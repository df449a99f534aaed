// Mu spaced k-mer two-hit diagonal prefilter — native scan kernel.
//
// Chunk-parallel redesign of the reference's streaming prefilter
// (reference: src/prefiltermu.cpp:121-392, src/mudex.cpp, src/mermx.cpp):
// instead of a 60M-slot counting-sort dictionary and radix-bucketed
// (seq, diag) bags, the query index here is a kmer-sorted entry array
// with a 16-bit prefix finger (memory stays proportional to the query
// set), and two-hit detection is a per-target sort + adjacent-dup scan.
// Targets are scanned by a thread pool over a flat concatenated letter
// buffer; per-thread outputs are concatenated in target order so results
// are deterministic for any thread count.
//
// Exports (ctypes):
//   pf_hoods  — high-scoring k-mer neighborhood enumeration (score>=T
//               against a given k-mer; branch-and-bound over score-sorted
//               letter rows). Used for query-side (idxq) index expansion.
//   pf_scan   — scan a chunk of targets against the query index, either
//               looking target k-mers up directly (idxq; the index was
//               built with neighborhoods) or expanding each target
//               k-mer's neighborhood at scan time (idxt).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int K = 5;
constexpr int KSPAN = 7;
constexpr int OFFS[K] = {0, 1, 2, 5, 6};
constexpr uint32_t MASK14 = (1u << 14) - 1;

struct ScoreCtx {
    int8_t s[36][36];
    // per row, letters sorted by descending score (for B&B early break)
    uint8_t ord[36][36];
    int8_t ordscore[36][36];
    int8_t selfdiag[36];

    void init(const int8_t* mumx) {
        for (int a = 0; a < 36; ++a) {
            for (int b = 0; b < 36; ++b) s[a][b] = mumx[a * 36 + b];
            selfdiag[a] = s[a][a];
            uint8_t idx[36];
            for (int b = 0; b < 36; ++b) idx[b] = (uint8_t)b;
            std::stable_sort(idx, idx + 36, [&](uint8_t x, uint8_t y) {
                return s[a][x] > s[a][y];
            });
            for (int b = 0; b < 36; ++b) {
                ord[a][b] = idx[b];
                ordscore[a][b] = s[a][idx[b]];
            }
        }
    }
};

// All 5-mers whose pair score against `q` is >= min_score.  DFS over
// positions; at each position letters are tried in descending score order
// so the loop can break as soon as even the best completion falls short.
inline int enum_hood(const ScoreCtx& sc, const uint8_t q[K], int min_score,
                     uint32_t* out, int cap) {
    int sufmax[K + 1];
    sufmax[K] = 0;
    for (int p = K - 1; p >= 0; --p)
        sufmax[p] = sufmax[p + 1] + sc.ordscore[q[p]][0];
    int n = 0;
    struct Frame { int li; uint32_t code; int score; };
    // iterative DFS, depth K
    Frame st[K];
    int depth = 0;
    st[0] = {0, 0u, 0};
    while (depth >= 0) {
        Frame& f = st[depth];
        if (f.li >= 36) { --depth; continue; }
        const uint8_t qc = q[depth];
        int sc_l = sc.ordscore[qc][f.li];
        int scr = f.score + sc_l;
        if (scr + sufmax[depth + 1] < min_score) { --depth; continue; }
        uint32_t code = f.code * 36u + sc.ord[qc][f.li];
        ++f.li;
        if (depth == K - 1) {
            if (scr >= min_score) {
                if (n >= cap) return -1;
                out[n++] = code;
            }
        } else {
            st[depth + 1] = {0, code, scr};
            ++depth;
        }
    }
    return n;
}

struct QueryIndex {
    const uint32_t* kmers;   // [ne] sorted ascending
    const uint32_t* qidx;    // [ne]
    const uint16_t* qpos;    // [ne]
    const uint32_t* finger;  // [65537] ranges by top-16-bits of kmer
    int64_t ne;

    inline void lookup(uint32_t kmer, int64_t& lo, int64_t& hi) const {
        uint32_t pre = kmer >> 10;  // 36^5 < 2^26, top 16 bits = code>>10
        const uint32_t* base = kmers;
        lo = std::lower_bound(base + finger[pre], base + finger[pre + 1],
                              kmer) - base;
        hi = std::upper_bound(base + lo, base + finger[pre + 1], kmer) -
             base;
    }
};

struct ThreadOut {
    std::vector<int32_t> q;
    std::vector<int32_t> t;
    std::vector<uint16_t> score;
};

// Best ungapped segment score on one diagonal (reset-at-negative rule,
// reference: src/prefiltermu.cpp:12-48).
inline int diag_best(const ScoreCtx& sc, const uint8_t* qs, int ql,
                     const uint8_t* ts, int tl, int d) {
    int i = ql - d - 1;
    if (i < 0) i = 0;
    int j = d - ql + 1;
    if (j < 0) j = 0;
    int n = std::min(ql - i, tl - j);
    int b = 0, f = 0;
    for (int k = 0; k < n; ++k) {
        f += sc.s[qs[i + k]][ts[j + k]];
        if (f > b)
            b = f;
        else if (f < 0)
            f = 0;
    }
    return b;
}

struct ScanArgs {
    QueryIndex qi;
    const uint16_t* qlens;
    const uint8_t* qcat;
    const int64_t* qoff;
    int32_t nq;
    const uint8_t* tcat;
    const int64_t* toff;
    const int32_t* tids;
    int32_t nt;
    const ScoreCtx* sc;
    bool idxt;
    int min_pair_score;
};

void scan_range(const ScanArgs& a, int t0, int t1, ThreadOut& out) {
    std::vector<uint32_t> keys;        // qidx*16384 + diag per index hit
    std::vector<uint16_t> best;        // per-query best two-hit diag score
    std::vector<uint32_t> touched;
    best.assign(a.nq, 0);
    std::vector<uint32_t> hood(65536);

    for (int ti = t0; ti < t1; ++ti) {
        const uint8_t* ts = a.tcat + a.toff[ti];
        const int tl = int(a.toff[ti + 1] - a.toff[ti]);
        keys.clear();

        for (int p = 0; p + KSPAN <= tl; ++p) {
            uint32_t kmer = 0;
            int selfscore = 0;
            bool ok = true;
            for (int x = 0; x < K; ++x) {
                uint8_t c = ts[p + OFFS[x]];
                if (c >= 36) { ok = false; break; }
                kmer = kmer * 36u + c;
                selfscore += a.sc->selfdiag[c];
            }
            if (!ok || selfscore < a.min_pair_score) continue;

            if (!a.idxt) {
                int64_t lo, hi;
                a.qi.lookup(kmer, lo, hi);
                for (int64_t e = lo; e < hi; ++e) {
                    uint32_t qx = a.qi.qidx[e];
                    int diag = int(a.qlens[qx]) + p - int(a.qi.qpos[e]) - 1;
                    if ((unsigned)diag > MASK14) continue;
                    keys.push_back(qx * (MASK14 + 1u) + (uint32_t)diag);
                }
            } else {
                uint8_t lets[K];
                uint32_t km = kmer;
                for (int x = K - 1; x >= 0; --x) {
                    lets[x] = km % 36u;
                    km /= 36u;
                }
                int nh = enum_hood(*a.sc, lets, a.min_pair_score,
                                   hood.data(), (int)hood.size());
                for (int h = 0; h < nh; ++h) {
                    int64_t lo, hi;
                    a.qi.lookup(hood[h], lo, hi);
                    for (int64_t e = lo; e < hi; ++e) {
                        uint32_t qx = a.qi.qidx[e];
                        int diag =
                            int(a.qlens[qx]) + p - int(a.qi.qpos[e]) - 1;
                        if ((unsigned)diag > MASK14) continue;
                        keys.push_back(qx * (MASK14 + 1u) + (uint32_t)diag);
                    }
                }
            }
        }
        if (keys.empty()) continue;

        std::sort(keys.begin(), keys.end());
        touched.clear();
        size_t nk = keys.size();
        for (size_t s = 0; s < nk;) {
            size_t e = s + 1;
            while (e < nk && keys[e] == keys[s]) ++e;
            if (e - s >= 2) {  // two-hit diagonal
                uint32_t qx = keys[s] / (MASK14 + 1u);
                int diag = int(keys[s] & MASK14);
                int ds = diag_best(*a.sc, a.qcat + a.qoff[qx],
                                   int(a.qlens[qx]), ts, tl, diag);
                if (ds > 0) {
                    if (ds > 65534) ds = 65534;
                    if (best[qx] == 0) touched.push_back(qx);
                    if (ds > best[qx]) best[qx] = (uint16_t)ds;
                }
            }
            s = e;
        }
        if (!touched.empty()) {
            std::sort(touched.begin(), touched.end());
            for (uint32_t qx : touched) {
                out.q.push_back((int32_t)qx);
                out.t.push_back(a.tids[ti]);
                out.score.push_back(best[qx]);
                best[qx] = 0;
            }
        }
    }
}

}  // namespace

extern "C" {

// Neighborhood enumeration for a batch of k-mers. out gets all neighbor
// codes back to back; out_offsets[i]..out_offsets[i+1] is kmer i's range.
// Returns total count, or -(total needed) if cap was too small.
int64_t pf_hoods(const int64_t* kmers, int64_t n, int32_t min_score,
                 const int8_t* mumx, int64_t* out, int64_t* out_offsets,
                 int64_t cap) {
    ScoreCtx sc;
    sc.init(mumx);
    std::vector<uint32_t> buf(65536);
    int64_t total = 0;
    out_offsets[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t lets[K];
        uint32_t km = (uint32_t)kmers[i];
        for (int x = K - 1; x >= 0; --x) {
            lets[x] = km % 36u;
            km /= 36u;
        }
        int nh = enum_hood(sc, lets, min_score, buf.data(),
                           (int)buf.size());
        if (nh < 0) return -1;
        if (total + nh <= cap)
            for (int h = 0; h < nh; ++h) out[total + h] = (int64_t)buf[h];
        total += nh;
        out_offsets[i + 1] = total;
    }
    return total;
}

// Scan nt targets against the query k-mer index; append one
// (query, target, best-two-hit-diag-score) triple per hit pair.
// Returns the triple count, or -(needed) if cap was too small.
int64_t pf_scan(const uint32_t* kmers_sorted, const uint32_t* e_qidx,
                const uint16_t* e_qpos, const uint32_t* finger16,
                int64_t ne, const uint16_t* qlens, const uint8_t* qcat,
                const int64_t* qoff, int32_t nq, const uint8_t* tcat,
                const int64_t* toff, const int32_t* tids, int32_t nt,
                const int8_t* mumx, int32_t idxt, int32_t min_pair_score,
                int32_t nthreads, int32_t* out_q, int32_t* out_t,
                uint16_t* out_score, int64_t cap) {
    ScoreCtx sc;
    sc.init(mumx);
    ScanArgs a;
    a.qi = QueryIndex{kmers_sorted, e_qidx, e_qpos, finger16, ne};
    a.qlens = qlens;
    a.qcat = qcat;
    a.qoff = qoff;
    a.nq = nq;
    a.tcat = tcat;
    a.toff = toff;
    a.tids = tids;
    a.nt = nt;
    a.sc = &sc;
    a.idxt = idxt != 0;
    a.min_pair_score = min_pair_score;

    if (nthreads < 1) nthreads = 1;
    if (nthreads > nt) nthreads = nt > 0 ? nt : 1;
    std::vector<ThreadOut> outs(nthreads);
    if (nthreads == 1) {
        scan_range(a, 0, nt, outs[0]);
    } else {
        std::vector<std::thread> pool;
        int per = (nt + nthreads - 1) / nthreads;
        for (int w = 0; w < nthreads; ++w) {
            int t0 = w * per, t1 = std::min(nt, t0 + per);
            if (t0 >= t1) break;
            pool.emplace_back(
                [&, w, t0, t1]() { scan_range(a, t0, t1, outs[w]); });
        }
        for (auto& th : pool) th.join();
    }

    int64_t total = 0;
    for (auto& o : outs) total += (int64_t)o.q.size();
    if (total > cap) return -total;
    int64_t pos = 0;
    for (auto& o : outs) {
        int64_t m = (int64_t)o.q.size();
        if (m == 0) continue;
        std::memcpy(out_q + pos, o.q.data(), m * sizeof(int32_t));
        std::memcpy(out_t + pos, o.t.data(), m * sizeof(int32_t));
        std::memcpy(out_score + pos, o.score.data(), m * sizeof(uint16_t));
        pos += m;
    }
    return total;
}

}  // extern "C"
