// Frozen copy of reseek_tpu_torch/native/sw.cpp (commit f533a72), the benchmark's
// plain reference: unchanged.
// Native score-only Smith-Waterman over multi-feature log-odds profiles —
// exact replica of the reference kernel's per-cell float32 arithmetic and
// tie rules (src/sw.cpp:79-212) with the substitution value computed
// feature-ordered like SetSMx_NoRev (src/dssaligner.cpp:529-611: first
// feature assigns, the rest += in float32).
//
// Per cell (i, j):
//   e_open = H(i-2, j-1) + open ; e_ext = E(i-1, j) + ext
//   E      = e_open >= e_ext ? e_open : e_ext        (open wins ties)
//   f_open = H(i-1, j-2) + open ; f_ext = F(i, j-1) + ext
//   F      = f_open >= f_ext ? f_open : f_ext
//   m = H(i-1, j-1); if (E > m) m = E; if (F > m) m = F;
//   if (0 >= m) m = 0;                                (0 wins ties)
//   H(i, j) = m + S(i, j)
//
// All operations are float32 adds/compares (no multiplies), so there is
// nothing for -ffp-contract to fuse; results are bit-identical to the
// numpy replica in reseek_tpu/ops/sw_np.py (asserted in tests).
//
// Used for the per-chain self-reversal score (GetSelfRevScore,
// src/alignpair.cpp:7-25): host-exact, no device round trip, no XLA
// compilation — keeping the TS inputs bit-exact on every backend.

#include <cstdint>
#include <cstring>
#include <vector>

static const float NEG = -9e9f;

extern "C" {

// prof_a/prof_b: uint8 [nf, la] / [nf, lb] row-major feature profiles.
// w: float32 [nf, 32, 32] weighted per-feature matrices (letters < 32).
// Returns the best local score (0 if none positive).
float sw_score_profile(const uint8_t *prof_a, int la, const uint8_t *prof_b,
                       int lb, int nf, const float *w, float open_,
                       float ext) {
    if (la <= 0 || lb <= 0)
        return 0.0f;
    // hp[j]  = H(i-1, j), hpp[j] = H(i-2, j), e[j] = E(i-1, j); j offset
    // by 2 so j-1 / j-2 reads fall into NEG-initialized slots.
    std::vector<float> hp(lb + 2, NEG), hpp(lb + 2, NEG), e(lb + 2, NEG);
    std::vector<float> hcur(lb + 2, NEG);
    // per-row pointers to each feature's letter rows
    std::vector<const float *> wrow(nf);

    float best = 0.0f;
    for (int i = 0; i < la; ++i) {
        for (int f = 0; f < nf; ++f)
            wrow[f] = w + ((size_t)f * 32 + prof_a[(size_t)f * la + i]) * 32;
        float fprev = NEG;  // F(i, j-1)
        for (int j = 0; j < lb; ++j) {
            const int jj = j + 2;
            const float e_open = hpp[jj - 1] + open_;
            const float e_ext = e[jj] + ext;
            const float ev = e_open >= e_ext ? e_open : e_ext;
            const float f_open = hp[jj - 2] + open_;
            const float f_ext = fprev + ext;
            const float fv = f_open >= f_ext ? f_open : f_ext;
            float m = hp[jj - 1];
            if (ev > m)
                m = ev;
            if (fv > m)
                m = fv;
            if (0.0f >= m)
                m = 0.0f;
            // S(i, j): feature-ordered float32 accumulation
            float s = wrow[0][prof_b[j]];
            for (int f = 1; f < nf; ++f)
                s += wrow[f][prof_b[(size_t)f * lb + j]];
            const float h = m + s;
            hcur[jj] = h;
            e[jj] = ev;
            fprev = fv;
            if (h > best)
                best = h;
        }
        hpp.swap(hp);
        hp.swap(hcur);
    }
    return best;
}

// Letters-vs-letters score-only SW over one substitution table
// (e.g. the 36x36 Mu matrix for the Mu filter, src/parasail_mu.cpp
// recurrences with integer-exact float32 values).
float sw_score_letters(const uint8_t *a, int la, const uint8_t *b, int lb,
                       const float *mx, int as, float open_, float ext) {
    if (la <= 0 || lb <= 0)
        return 0.0f;
    std::vector<float> hp(lb + 2, NEG), hpp(lb + 2, NEG), e(lb + 2, NEG);
    std::vector<float> hcur(lb + 2, NEG);
    float best = 0.0f;
    for (int i = 0; i < la; ++i) {
        const float *row = mx + (size_t)a[i] * as;
        float fprev = NEG;
        for (int j = 0; j < lb; ++j) {
            const int jj = j + 2;
            const float e_open = hpp[jj - 1] + open_;
            const float e_ext = e[jj] + ext;
            const float ev = e_open >= e_ext ? e_open : e_ext;
            const float f_open = hp[jj - 2] + open_;
            const float f_ext = fprev + ext;
            const float fv = f_open >= f_ext ? f_open : f_ext;
            float m = hp[jj - 1];
            if (ev > m)
                m = ev;
            if (fv > m)
                m = fv;
            if (0.0f >= m)
                m = 0.0f;
            const float h = m + row[b[j]];
            hcur[jj] = h;
            e[jj] = ev;
            fprev = fv;
            if (h > best)
                best = h;
        }
        hpp.swap(hp);
        hp.swap(hcur);
    }
    return best;
}

// Full local alignment with traceback — exact replica of SWFast +
// TraceBackBitSW (src/sw.cpp:8-212) as mirrored by
// reseek_tpu/ops/sw_np.sw_align: same tie rules (E beats match only if
// strictly greater, F only if strictly greater than the running max,
// 0 wins ties, gap-open wins ties against gap-extend), best cell = first
// row-major maximum under strict-improvement scan.
//
// path_buf receives 'M'/'D'/'I' bytes (D consumes A, I consumes B).
// Returns 1 on success with *out_score > 0, else 0 (empty alignment).
int sw_align_profile(const uint8_t *prof_a, int la, const uint8_t *prof_b,
                     int lb, int nf, const float *w, float open_,
                     float ext, float *out_score, int *out_lo_a,
                     int *out_lo_b, char *path_buf, int path_cap,
                     int *out_plen) {
    *out_score = 0.0f;
    *out_lo_a = *out_lo_b = *out_plen = 0;
    if (la <= 0 || lb <= 0)
        return 0;
    static const uint8_t SRC_M = 0, SRC_D = 1, SRC_I = 2, SRC_S = 3;
    static const uint8_t BIT_MD = 4, BIT_MI = 8;
    std::vector<uint8_t> tb((size_t)la * lb, 0);
    std::vector<float> hp(lb + 2, NEG), hpp(lb + 2, NEG), e(lb + 2, NEG);
    std::vector<float> hcur(lb + 2, NEG);
    std::vector<const float *> wrow(nf);

    float best = NEG;
    int best_i = 0, best_j = 0;
    for (int i = 0; i < la; ++i) {
        for (int f = 0; f < nf; ++f)
            wrow[f] = w + ((size_t)f * 32 + prof_a[(size_t)f * la + i]) * 32;
        uint8_t *trow = tb.data() + (size_t)i * lb;
        float fprev = NEG;
        for (int j = 0; j < lb; ++j) {
            const int jj = j + 2;
            const float e_open = hpp[jj - 1] + open_;
            const float e_ext = e[jj] + ext;
            const bool e_pref = e_open >= e_ext;
            const float ev = e_pref ? e_open : e_ext;
            const float f_open = hp[jj - 2] + open_;
            const float f_ext = fprev + ext;
            const bool f_pref = f_open >= f_ext;
            const float fv = f_pref ? f_open : f_ext;
            float m = hp[jj - 1];
            uint8_t src = SRC_M;
            if (ev > m) {
                m = ev;
                src = SRC_D;
            }
            if (fv > m) {
                m = fv;
                src = SRC_I;
            }
            if (0.0f >= m) {
                m = 0.0f;
                src = SRC_S;
            }
            float s = wrow[0][prof_b[j]];
            for (int f = 1; f < nf; ++f)
                s += wrow[f][prof_b[(size_t)f * lb + j]];
            const float h = m + s;
            hcur[jj] = h;
            e[jj] = ev;
            fprev = fv;
            trow[j] |= src;
            // gap-open preference bits live at the DECIDING cells
            // (sw_np._forward: E(i,j) decided by (i-1, j), F by (i, j-1))
            if (e_pref && i > 0)
                tb[(size_t)(i - 1) * lb + j] |= BIT_MD;
            if (f_pref && j > 0)
                trow[j - 1] |= BIT_MI;
            if (h > best) {  // strict: first row-major maximum
                best = h;
                best_i = i;
                best_j = j;
            }
        }
        hpp.swap(hp);
        hp.swap(hcur);
    }
    if (best <= 0.0f)
        return 0;

    // backward walk (sw_np.sw_align / src/sw.cpp:8-77)
    int i = best_i + 1, j = best_j + 1;
    char state = 'M';
    int n = 0;
    std::vector<char> rev;
    rev.reserve(la + lb);
    for (;;) {
        rev.push_back(state);
        ++n;
        if (state == 'M') {
            const uint8_t t = tb[(size_t)(i - 1) * lb + (j - 1)];
            const uint8_t src = t & 3;
            if (src == SRC_D)
                state = 'D';
            else if (src == SRC_I)
                state = 'I';
            else if (src == SRC_S) {
                break;
            }
            --i;
            --j;
        } else if (state == 'D') {
            const uint8_t t = tb[(size_t)(i - 1) * lb + j];
            state = (t & BIT_MD) ? 'M' : 'D';
            --i;
        } else {
            const uint8_t t = tb[(size_t)i * lb + (j - 1)];
            state = (t & BIT_MI) ? 'M' : 'I';
            --j;
        }
    }
    if (n > path_cap)
        return 0;  // caller buffer too small (shouldn't happen)
    for (int k = 0; k < n; ++k)
        path_buf[k] = rev[(size_t)(n - 1 - k)];
    *out_score = best;
    *out_lo_a = i - 1;
    *out_lo_b = j - 1;
    *out_plen = n;
    return 1;
}

}  // extern "C"
