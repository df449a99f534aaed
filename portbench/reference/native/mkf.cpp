// Frozen copy of reseek_tpu_torch/native/mkf.cpp (commit f533a72), the benchmark's
// plain reference: unchanged.
// Native MKF (Mu k-mer seeded x-drop) aligner for long chains.
// Same algorithm and float semantics as reseek_tpu/align/mkf.py (which is
// validated against the reference binary's -test_xdrop and q100 output);
// reference: src/mukmerfilter.cpp, src/chainer.cpp, src/xdrophsp.cpp,
// src/xdropfwd.cpp, src/mergefwdback.cpp.
//
// Build: g++ -O2 -march=native -shared -fPIC mkf.cpp -o libmkf.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <string>
#include <functional>

namespace {

constexpr int HASHW = 4;
constexpr uint16_t NO_POS = 0xFFFF;
constexpr float MINUS_INF = -9e9f;
constexpr int DICT3 = 36 * 36 * 36;

struct Scorer {
    // SubstScore(a, b) = sum_f w[f][pa[f][a]][pb[f][b]], float32
    // feature-ordered accumulation (src/xdrophsp.cpp:8-33)
    const float *w;       // [F, 32, 32]
    const uint8_t *pa;    // [F, LA]
    const uint8_t *pb;    // [F, LB]
    int F, LA, LB;
    inline float operator()(int a, int b) const {
        float t = 0.0f;
        for (int f = 0; f < F; ++f)
            t += w[(f * 32 + pa[f * LA + a]) * 32 + pb[f * LB + b]];
        return t;
    }
};

// ---- ungapped +/- x-drop on Mu letters (mukmerfilter.cpp:105-175) ------
int mu_xdrop(const int8_t *mx, const uint8_t *q, int lq, const uint8_t *t,
             int lt, int pq, int pt, int x, int &lo_i, int &lo_j,
             int &len) {
    int i = pq, j = pt;
    int fwd = 0, best_fwd = 0, fwd_len = 0;
    while (i < lq && j < lt) {
        fwd += mx[q[i] * 36 + t[j]];
        ++i; ++j;
        if (fwd > best_fwd) { best_fwd = fwd; fwd_len = i - pq; }
        else if (fwd + x < best_fwd) break;
    }
    int rev = 0, best_rev = 0, rev_len = 0;
    i = pq - 1; j = pt - 1;
    while (i >= 0 && j >= 0) {
        rev += mx[q[i] * 36 + t[j]];
        if (rev > best_rev) { best_rev = rev; rev_len = pq - i; }
        else if (rev + x < best_rev) break;
        --i; --j;
    }
    lo_i = pq - rev_len;
    lo_j = pt - rev_len;
    len = fwd_len + rev_len;
    return best_fwd + best_rev;
}

// ---- 1-D chaining sweep (chainer.cpp:31-194) ---------------------------
float chain_hsps(const std::vector<int> &los, const std::vector<int> &his,
                 const std::vector<float> &scores, std::vector<int> &idxs) {
    idxs.clear();
    int n = (int)los.size();
    if (n == 0) return 0.0f;
    struct BP { int pos; int is_hi; int idx; };
    std::vector<BP> bps;
    bps.reserve(2 * n);
    for (int i = 0; i < n; ++i) {
        bps.push_back({los[i], 0, i});
        bps.push_back({his[i], 1, i});
    }
    std::stable_sort(bps.begin(), bps.end(), [](const BP &a, const BP &b) {
        return a.pos != b.pos ? a.pos < b.pos : a.is_hi < b.is_hi;
    });
    std::vector<int> tb(n, -1);
    std::vector<float> cs(n, MINUS_INF);
    int best_end = -1;
    for (const BP &bp : bps) {
        if (!bp.is_hi) {
            tb[bp.idx] = best_end;
            cs[bp.idx] = best_end < 0 ? scores[bp.idx]
                                      : cs[best_end] + scores[bp.idx];
        } else {
            if (best_end < 0 || cs[bp.idx] > cs[best_end])
                best_end = bp.idx;
        }
    }
    float total = 0.0f;
    for (int i = best_end; i >= 0; i = tb[i]) {
        total += scores[i];
        idxs.push_back(i);
    }
    return total;
}

// ---- banded gapped x-drop fwd (xdropfwd.cpp:71-386) --------------------
// Returns best score; path (M/D/I chars) appended to out.
float xdrop_fwd(const Scorer &sub, float x, float open_, float ext,
                int lo_a, int la_total, int lo_b, int lb_total,
                std::string &path) {
    path.clear();
    int LA = la_total - lo_a;
    int LB = lb_total - lo_b;
    if (LA == 1 || LB == 1) {
        float s = sub(lo_a, lo_b);
        if (s > 0) path = "M";
        return s;
    }
    float abs_open = -open_, abs_ext = -ext;
    std::vector<float> mrow(LB + 2, MINUS_INF);  // index j+1
    std::vector<float> drow(LB + 2, MINUS_INF);
    std::vector<uint8_t> tb((size_t)(LA + 2) * (LB + 2), 0);
    auto TB = [&](int i, int j) -> uint8_t & {
        return tb[(size_t)i * (LB + 2) + j];
    };
    const uint8_t DM = 1, IM = 2, MD = 4, MI = 8;
    auto MR = [&](int j) -> float & { return mrow[j + 1]; };

    float best = 0.0f;
    int besti = 0, bestj = 0;
    int prev_jlo = 0, prev_jhi = 0, jlo = 1, jhi = 1;
    float m0 = best;
    const long UNSET = -1;

    for (int i = 1; i <= LA; ++i) {
        if (jlo == prev_jlo) {
            MR(jlo - 1) = MINUS_INF;
            drow[jlo] = MINUS_INF;
        }
        int endj = std::min(prev_jhi + 1, LB);
        for (int j = endj + 1; j <= std::min(jhi + 1, LB); ++j) {
            MR(j - 1) = MINUS_INF;
            drow[j] = MINUS_INF;
        }
        long next_jlo = UNSET, next_jhi = UNSET;
        float i0 = MINUS_INF;
        for (int j = jlo; j <= jhi; ++j) {
            uint8_t bits = 0;
            float saved_m0 = m0;
            float xm = m0;
            if (drow[j] > xm) { xm = drow[j]; bits = DM; }
            if (i0 > xm) { xm = i0; bits = IM; }
            m0 = MR(j);
            float s = sub(lo_a + i - 1, lo_b + j - 1) + xm;
            MR(j) = s;
            float h = s - best + x;
            if (h > 0) {
                next_jlo = next_jlo == UNSET ? j + 1
                                             : std::min(next_jlo, (long)j + 1);
                next_jhi = j + 1;  // plain assignment (xdropfwd.cpp:201)
            }
            if (h > abs_open)
                next_jlo = next_jlo == UNSET ? j
                                             : std::min(next_jlo, (long)j);
            if (h > abs_ext && j == jhi && jhi + 1 < LB) {
                ++jhi;
                int new_endj = std::max(std::min(jhi + 1, LB), endj);
                for (int j2 = endj + 1; j2 <= new_endj; ++j2) {
                    if (j2 - 1 > j) MR(j2 - 1) = MINUS_INF;
                    drow[j2] = MINUS_INF;
                }
                endj = new_endj;
            }
            if (s >= best) { best = s; besti = i; bestj = j; }

            if (j != jlo) {
                float md = saved_m0 + open_;
                drow[j] += ext;
                if (md >= drow[j]) { drow[j] = md; bits |= MD; }
                h = drow[j] - best + x;
                if (h > 0) {
                    next_jlo = next_jlo == UNSET
                                   ? j - 1 : std::min(next_jlo, (long)j - 1);
                    // max(UINT_MAX, .) absorbs: unset stays unset
                    if (next_jhi != UNSET)
                        next_jhi = std::max(next_jhi, (long)j - 1);
                }
            }
            float mi = saved_m0 + open_;
            i0 += ext;
            if (mi >= i0) { i0 = mi; bits |= MI; }
            h = i0 - best + x;
            if (h > 0) {
                next_jlo = next_jlo == UNSET ? j + 1
                                             : std::min(next_jlo, (long)j + 1);
                if (next_jhi != UNSET)
                    next_jhi = std::max(next_jhi, (long)j + 1);
            }
            if (h > abs_ext && j == jhi && jhi + 1 < LB) {
                ++jhi;
                int new_endj = std::max(std::min(jhi + 1, LB), endj);
                for (int j2 = endj + 1; j2 <= new_endj; ++j2) {
                    MR(j2 - 1) = MINUS_INF;
                    drow[j2] = MINUS_INF;
                }
                endj = new_endj;
            }
            TB(i, j) = bits;
        }
        if (jhi < LB) {
            int jhi1 = jhi + 1;
            TB(i, jhi1) = 0;
            float md = m0 + open_;
            drow[jhi1] += ext;
            if (md >= drow[jhi1]) { drow[jhi1] = md; TB(i, jhi1) = MD; }
        }
        if (next_jlo == UNSET) break;
        prev_jlo = jlo;
        prev_jhi = jhi;
        jlo = (int)std::min(next_jlo, (long)LB);
        jhi = next_jhi == UNSET ? LB : (int)std::min(next_jhi, (long)LB);
        if (jlo == prev_jlo) {
            m0 = MINUS_INF;
            drow[jlo] = MINUS_INF;
        } else {
            m0 = MR(jlo - 1);
        }
    }
    if (best <= 0) return 0.0f;
    // TraceBack with GetTBBit offsets (swtrace.h:6-41)
    int i = besti, j = bestj;
    char state = 'M';
    std::string rev;
    for (;;) {
        rev.push_back(state);
        if (i == 1 || j == 1) break;
        if (state == 'M') {
            uint8_t t = TB(i, j);
            state = (t & DM) ? 'D' : ((t & IM) ? 'I' : 'M');
            --i; --j;
        } else if (state == 'D') {
            uint8_t t = TB(i, j + 1);
            state = (t & MD) ? 'M' : 'D';
            --i;
        } else {
            uint8_t t = TB(i + 1, j);
            state = (t & MI) ? 'M' : 'I';
            --j;
        }
    }
    path.assign(rev.rbegin(), rev.rend());
    return best;
}

}  // namespace

extern "C" {

// Full MKF alignment of one pair.
//   lets_q/lets_t: uint8 Mu letters; kmers_t built internally (pattern 111)
//   prof_q/prof_t: uint8 [F, L] profiles; w: float32 [F,32,32] weighted mats
//   int_mx: int8 [36*36] Mu matrix
//   params: x1, min_hsp, x2 (gapped), open, ext, min_mega
// Outputs: *score, *lo_a, *lo_b, path written to path_buf (cap path_cap),
// *path_len.  Returns 1 if an alignment was produced, 0 otherwise.
int mkf_align(const uint8_t *lets_q, int lq, const uint8_t *lets_t, int lt,
              const uint8_t *prof_q, const uint8_t *prof_t, int F,
              const float *w, const int8_t *int_mx,
              int x1, int min_hsp, float x2, float open_, float ext,
              float min_mega,
              float *score, int *lo_a, int *lo_b,
              char *path_buf, int path_cap, int *path_len,
              int *best_hsp_out, int *best_chain_out) {
    *score = 0;
    *lo_a = *lo_b = 0;
    *path_len = 0;
    *best_hsp_out = 0;
    *best_chain_out = 0;
    if (lq < 3 || lt < 3) return 0;

    // query 3-mer hash (mukmerfilter.cpp:208-225)
    std::vector<uint16_t> ht((size_t)DICT3 * HASHW, NO_POS);
    std::vector<uint8_t> fill(DICT3, 0);
    for (int p = 0; p + 3 <= lq; ++p) {
        int km = (lets_q[p] * 36 + lets_q[p + 1]) * 36 + lets_q[p + 2];
        if (fill[km] < HASHW) ht[(size_t)km * HASHW + fill[km]++] = (uint16_t)p;
    }

    // target k-mer hits -> HSPs (mukmerfilter.cpp:316-389)
    std::vector<int> lois, lojs, lens;
    std::vector<float> scores;
    int best_hsp = 0;
    for (int pt = 0; pt + 3 <= lt; ++pt) {
        int km = (lets_t[pt] * 36 + lets_t[pt + 1]) * 36 + lets_t[pt + 2];
        for (int wslot = 0; wslot < HASHW; ++wslot) {
            uint16_t pq = ht[(size_t)km * HASHW + wslot];
            if (pq == NO_POS) continue;
            int li, lj, ln;
            int sc = mu_xdrop(int_mx, lets_q, lq, lets_t, lt, pq, pt, x1,
                              li, lj, ln);
            if (sc >= min_hsp && sc > best_hsp) {
                best_hsp = sc;
                bool seen = false;
                for (int v : lois)
                    if (v == li) { seen = true; break; }
                if (!seen) {
                    lois.push_back(li);
                    lojs.push_back(lj);
                    lens.push_back(ln);
                    scores.push_back((float)sc);
                }
            }
        }
    }
    *best_hsp_out = best_hsp;
    if (lois.empty()) return 0;
    std::vector<int> his(lois.size());
    for (size_t i = 0; i < lois.size(); ++i) his[i] = lois[i] + lens[i] - 1;
    std::vector<int> idxs;
    float chain_score = chain_hsps(lois, his, scores, idxs);
    *best_chain_out = (int)chain_score;
    if (chain_score <= 0 || idxs.empty()) return 0;

    Scorer sub{w, prof_q, prof_t, F, lq, lt};

    // mega re-score (dssaligner.cpp:488-527, 1395-1419): feature-major f32
    float mega_total = 0.0f, best_mega = 0.0f;
    int best_idx = idxs[0];
    for (int idx : idxs) {
        float total = 0.0f;
        for (int f = 0; f < F; ++f)
            for (int k = 0; k < lens[idx]; ++k)
                total += w[(f * 32 + prof_q[f * lq + lois[idx] + k]) * 32 +
                           prof_t[f * lt + lojs[idx] + k]];
        if (total > best_mega) { best_mega = total; best_idx = idx; }
        mega_total += total;
    }
    if (mega_total < min_mega) return 0;

    // best 8-mer inside the best HSP (xdrophsp.cpp:66-98)
    const int K = 8;
    int li = lois[best_idx], lj = lojs[best_idx], ln = lens[best_idx];
    int la0 = li + ln / 2, lb0 = lj + ln / 2;
    float best_mer = 0.0f;
    for (int start = 0; start + K <= ln; ++start) {
        float mer = 0.0f;
        for (int k = 0; k < K; ++k) mer += sub(li + start + k, lj + start + k);
        if (mer > best_mer) {
            best_mer = mer;
            la0 = li + start;
            lb0 = lj + start;
        }
    }
    if (std::min(la0, lb0) < K / 2) { la0 += K / 2; lb0 += K / 2; }

    std::string fwd_path, bwd_path;
    float sf = xdrop_fwd(sub, x2, open_, ext, la0, lq, lb0, lt, fwd_path);
    // backward: reversed coordinates (xdropbwd.cpp)
    int rla = la0, rlb = lb0;  // HiA=la0-1 -> RD.LA = la0
    float sb = 0.0f;
    if (rla >= 1 && rlb >= 1) {
        // build reversed-index scorer via temporary reversed profiles
        std::vector<uint8_t> rq((size_t)F * rla), rt((size_t)F * rlb);
        for (int f = 0; f < F; ++f) {
            for (int i2 = 0; i2 < rla; ++i2)
                rq[f * rla + i2] = prof_q[f * lq + (rla - i2 - 1)];
            for (int j2 = 0; j2 < rlb; ++j2)
                rt[f * rlb + j2] = prof_t[f * lt + (rlb - j2 - 1)];
        }
        Scorer rsub{w, rq.data(), rt.data(), F, rla, rlb};
        std::string p;
        sb = xdrop_fwd(rsub, x2, open_, ext, 0, rla, 0, rlb, p);
        bwd_path.assign(p.rbegin(), p.rend());
    }
    float total = sf + sb;
    if (total < 10) return 0;
    int out_lo_a = la0, out_lo_b = lb0;
    if (!bwd_path.empty()) {
        int nm = 0, nd = 0, ni = 0;
        for (char c : bwd_path) {
            if (c == 'M') ++nm;
            else if (c == 'D') ++nd;
            else ++ni;
        }
        out_lo_a = la0 - (nm + nd);
        out_lo_b = lb0 - (nm + ni);
    }
    std::string full = bwd_path + fwd_path;
    if ((int)full.size() > path_cap) return 0;
    memcpy(path_buf, full.data(), full.size());
    *path_len = (int)full.size();
    *score = total;
    *lo_a = out_lo_a;
    *lo_b = out_lo_b;
    return 1;
}

}  // extern "C"
