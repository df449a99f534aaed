// Frozen copy of reseek_tpu_torch/native/dss_encoder.cpp (commit f533a72), the benchmark's
// plain reference: unchanged.
// Native DSS encoder: per-residue structure-state features from C-alpha
// coordinates, numerically identical to the Python reference encoder
// (reseek_tpu/encoder/dss.py) and to the original method's semantics
// (reference src/dss.cpp, src/getss.cpp, src/myss.cpp, src/valuetoint.cpp).
//
// Exposed as a C ABI for ctypes.  Distance math is float32, windowed
// accumulations are double with left-to-right order; trained constants
// (Conf centroids, bin thresholds) are passed in from Python so the single
// source of truth stays in reseek_tpu/data.
//
// Build: g++ -O2 -march=native -shared -fPIC dss_encoder.cpp -o libdssenc.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int DENSITY_W = 50, DENSITY_w = 3;
constexpr int SSDENSITY_W = 50, SSDENSITY_w = 8;
constexpr double DENSITY_RADIUS = 20.0;
constexpr double NU_ND_RADIUS = 20.0;
constexpr int NEN_W = 100, NEN_w = 12;
constexpr int NUDX_W = 50;
constexpr double DEFAULT_NENDIST = 10.0;
constexpr double SSDENSITY_EPS = 1.0;
constexpr int SSE_MIN_LENGTH = 8;
constexpr int SSE_MARGIN = 8;
constexpr int PM_DELTA = 8;
constexpr double PI_REF = 3.1415926535;  // reference abcxyz.h:7
const double DBL_BIG = 1e308;

struct Coords {
    const float *x;  // [L][3] interleaved
    int L;
    inline float dist(int i, int j) const {
        float dx = x[3 * i] - x[3 * j];
        float dy = x[3 * i + 1] - x[3 * j + 1];
        float dz = x[3 * i + 2] - x[3 * j + 2];
        return sqrtf(dx * dx + dy * dy + dz * dz);
    }
};

// feature order must match reseek_tpu.constants: AA + int features + float
enum Feat {
    F_AA, F_SS, F_SS3, F_NENSS, F_NENConf, F_NENSS3, F_Conf, F_RENSS,
    F_RENSS3, F_RENConf, F_NormDens4, F_NENDist4, F_RENDist4, F_Mu,
    F_AA3, F_AA4, F_NormDens, F_NENDist, F_HelixDens, F_StrandDens,
    F_DstNxtHlx, F_DstPrvHlx, F_NX, F_RENDist, F_PMDist, F_COUNT
};

inline int bin_value(const double *ts, int n, double v) {
    for (int i = 0; i < n; ++i)
        if (v < ts[i]) return i;
    return n;
}

}  // namespace

extern "C" {

// Encode one chain.
//   coords:    float32 [L*3]
//   seq:       char [L]
//   centroids: double [16*9] Conf k-means centroids
//   bins:      double [9*15] thresholds for NormDens, NENDist, HelixDens,
//              StrandDens, DstNxtHlx, DstPrvHlx, NX, RENDist, PMDist
//   out:       uint8 [F_COUNT * L] feature letters (row per feature)
// Returns 0 on success.
int dss_encode(const float *coords, const char *seq, int L,
               const double *centroids, const double *bins,
               uint8_t *out) {
    if (L <= 0) return 0;
    Coords C{coords, L};
    const double *bins_NormDens = bins + 0 * 15;
    const double *bins_NENDist = bins + 1 * 15;
    const double *bins_HelixDens = bins + 2 * 15;
    const double *bins_StrandDens = bins + 3 * 15;
    const double *bins_DstNxtHlx = bins + 4 * 15;
    const double *bins_DstPrvHlx = bins + 5 * 15;
    const double *bins_NX = bins + 6 * 15;
    const double *bins_RENDist = bins + 7 * 15;
    const double *bins_PMDist = bins + 8 * 15;

    auto row = [&](int f) { return out + (size_t)f * L; };

    // ---- SS (getss.cpp:6-60): h=0 s=1 t=2 ~=3 --------------------------
    std::vector<uint8_t> ss(L, 3);
    for (int p = 2; p + 2 < L; ++p) {
        double d13 = C.dist(p - 2, p);
        double d14 = C.dist(p - 2, p + 1);
        double d15 = C.dist(p - 2, p + 2);
        double d24 = C.dist(p - 1, p + 1);
        double d25 = C.dist(p - 1, p + 2);
        double d35 = C.dist(p, p + 2);
        const double DH = 2.1, DS = 1.42;
        if (fabs(d15 - 6.37) < DH && fabs(d14 - 5.18) < DH &&
            fabs(d25 - 5.18) < DH && fabs(d13 - 5.45) < DH &&
            fabs(d24 - 5.45) < DH && fabs(d35 - 5.45) < DH)
            ss[p] = 0;
        else if (fabs(d15 - 13) < DS && fabs(d14 - 10.4) < DS &&
                 fabs(d25 - 10.4) < DS && fabs(d13 - 6.1) < DS &&
                 fabs(d24 - 6.1) < DS && fabs(d35 - 6.1) < DS)
            ss[p] = 1;
        else if (d15 < 8.2)
            ss[p] = 2;
    }

    // ---- windowed scans: NEN/REN + densities + NX ----------------------
    // (dss.cpp:374-470, 179-244, 339-372, 246-325)
    // One distance row per residue feeds every windowed feature, and
    // exp(-d/20) is computed once per (p, q) pair — density, ss-density
    // and NX all use radius 20 (DENSITY_RADIUS == NU_ND_RADIUS).
    // Identical float inputs give identical values and each feature's
    // accumulation order is unchanged, so results stay bit-equal to the
    // separate per-feature loops (asserted vs the numpy encoder).
    static_assert(DENSITY_RADIUS == NU_ND_RADIUS, "shared exp cache");
    static_assert(DENSITY_W == SSDENSITY_W && DENSITY_W == NUDX_W,
                  "shared 50-window");
    std::vector<int> nen(L, -1), ren(L, -1);
    std::vector<double> dens(L), helixd(L), strandd(L), nx(L);
    double mn = 999, mx = 0;
    std::vector<float> drow(2 * NEN_W + 1);
    std::vector<double> e20(2 * DENSITY_W + 1);
    for (int p = 0; p < L; ++p) {
        const int lo100 = p - NEN_W < 0 ? 0 : p - NEN_W;
        const int hi100 = p + NEN_W >= L ? L - 1 : p + NEN_W;
        for (int q = lo100; q <= hi100; ++q)
            drow[q - lo100] = C.dist(p, q);
        const int lo50 = p - DENSITY_W < 0 ? 0 : p - DENSITY_W;
        const int hi50 = p + DENSITY_W >= L ? L - 1 : p + DENSITY_W;
        for (int q = lo50; q <= hi50; ++q)
            e20[q - lo50] =
                exp(-(double)drow[q - lo100] / DENSITY_RADIUS);

        // NEN / REN
        {
            double best = 999;
            int bi = -1;
            for (int q = lo100; q <= hi100; ++q) {
                if (q + NEN_w >= p && q <= p + NEN_w) continue;
                double d = drow[q - lo100];
                if (d < best) { best = d; bi = q; }
            }
            nen[p] = bi;
            if (bi >= 0) {
                int rlo, rhi;
                if (bi > p) { rlo = lo100; rhi = p - 1; }
                else { rlo = p + 1; rhi = hi100; }
                if (rhi >= 0) {
                    best = 999; bi = -1;
                    for (int q = rlo; q <= rhi; ++q) {
                        if (q + NEN_w >= p && q <= p + NEN_w) continue;
                        double d = drow[q - lo100];
                        if (d < best) { best = d; bi = q; }
                    }
                    ren[p] = bi;
                }
            }
        }

        if (p == 0 || p + 1 >= L) {
            dens[p] = DBL_BIG;
            helixd[p] = DBL_BIG;
            strandd[p] = DBL_BIG;
            nx[p] = DBL_BIG;
            continue;
        }

        // density (exclude +-DENSITY_w)
        {
            double d = 0;
            for (int q = lo50; q <= hi50; ++q) {
                if (q + DENSITY_w >= p && q <= p + DENSITY_w) continue;
                d += e20[q - lo50];
            }
            dens[p] = d;
            if (d < mn) mn = d;
            if (d > mx) mx = d;
        }

        // ss-densities, both classes in one pass (each class's own
        // accumulators add in the same ascending-q order as before)
        {
            double d0 = 0, dc0 = 0, d1 = 0, dc1 = 0;
            for (int q = lo50; q <= hi50; ++q) {
                if (q + SSDENSITY_w >= p && q <= p + SSDENSITY_w)
                    continue;
                const double f = e20[q - lo50];
                d0 += f;
                if (ss[q] == 0) dc0 += f;
                d1 += f;
                if (ss[q] == 1) dc1 += f;
            }
            helixd[p] = dc0 / (d0 + SSDENSITY_EPS);
            strandd[p] = dc1 / (d1 + SSDENSITY_EPS);
        }

        // NX (dss.cpp:246-325)
        {
            double d1x = (double)coords[3 * p] - coords[3 * (p - 1)];
            double d1y = (double)coords[3 * p + 1] - coords[3 * (p - 1) + 1];
            double d1z = (double)coords[3 * p + 2] - coords[3 * (p - 1) + 2];
            double d2x = (double)coords[3 * p] - coords[3 * (p + 1)];
            double d2y = (double)coords[3 * p + 1] - coords[3 * (p + 1) + 1];
            double d2z = (double)coords[3 * p + 2] - coords[3 * (p + 1) + 2];
            double vx = d1x + d2x, vy = d1y + d2y, vz = d1z + d2z;
            double mod = sqrt(vx * vx + vy * vy + vz * vz);
            if (mod > 0) { vx /= mod; vy /= mod; vz /= mod; }
            double nu = 0, nd = 0;
            for (int q = lo50; q <= hi50; ++q) {
                if (q + 3 >= p && q <= p + 3) continue;
                const double f = e20[q - lo50];
                double wx = (double)coords[3 * q] - coords[3 * p];
                double wy = (double)coords[3 * q + 1] - coords[3 * p + 1];
                double wz = (double)coords[3 * q + 2] - coords[3 * p + 2];
                double dot = vx * wx + vy * wy + vz * wz;
                double mi = sqrt(vx * vx + vy * vy + vz * vz);
                double mj = sqrt(wx * wx + wy * wy + wz * wz);
                bool up;
                if (fabs(mi * mj) < 1e-6) {
                    up = true;  // GetTheta3D returns 0 (abcxyz.h:210-211)
                } else {
                    double ct = dot / (mi * mj);
                    if (ct < -1) ct = -1;
                    else if (ct > 1) ct = 1;
                    double deg = acos(ct) * 180.0 / PI_REF;
                    up = deg < 90.0;
                }
                if (up) nu += f; else nd += f;
            }
            nx[p] = nu + nd;
        }
    }
    double rng = mx - mn;
    if (rng < 1) rng = 1;
    for (int p = 0; p < L; ++p)
        if (dens[p] != DBL_BIG) dens[p] = (dens[p] - mn) / rng;

    // ---- Conf (myss.cpp:127-170) ---------------------------------------
    static const int CONF_I[9] = {-2, -2, -2, -1, -1, 0, -3, 0, -3};
    static const int CONF_J[9] = {0, 1, 2, 1, 2, 2, 3, 3, 0};
    std::vector<uint8_t> conf(L, 0);
    for (int p = 3; p + 3 < L; ++p) {
        double v[9];
        for (int m = 0; m < 9; ++m)
            v[m] = C.dist(p + CONF_I[m], p + CONF_J[m]);
        double bestd = 0;
        int bestk = 0;
        for (int k = 0; k < 16; ++k) {
            double s2 = 0;
            for (int m = 0; m < 9; ++m) {
                double diff = v[m] - centroids[k * 9 + m];
                s2 += diff * diff;
            }
            double d = sqrt(s2);
            if (k == 0 || d < bestd) { bestd = d; bestk = k; }
        }
        conf[p] = (uint8_t)bestk;
    }

    // ---- SSEs (dss.cpp:78-155) -----------------------------------------
    std::vector<int> h_mids;          // helix mids, ascending
    std::vector<int> all_mids;        // all h/s mids, ascending
    std::vector<uint8_t> mid_is_h;
    {
        int start = 0;
        for (int p = 1; p <= L; ++p) {
            bool boundary = (p == L) || (ss[p] != ss[start]);
            if (boundary) {
                int len = p - start;
                uint8_t c = ss[start];
                if (len >= SSE_MIN_LENGTH && (c == 0 || c == 1)) {
                    int mid = start + len / 2;
                    all_mids.push_back(mid);
                    mid_is_h.push_back(c == 0);
                    if (c == 0) h_mids.push_back(mid);
                }
                start = p;
            }
        }
    }

    // ---- per-position feature letters ---------------------------------
    // AA letter tables: function-local static struct so initialization is
    // thread-safe (C++11 magic statics) — encode calls run concurrently
    // from a Python thread pool with the GIL released.
    struct AATabs {
        int8_t aa[256], aa3[256], aa4[256];
        AATabs() {
            memset(aa, -1, sizeof aa);
            memset(aa3, 0, sizeof aa3);
            memset(aa4, 0, sizeof aa4);
            const char *alpha = "ACDEFGHIKLMNPQRSTVWY";
            for (int i = 0; alpha[i]; ++i) {
                aa[(uint8_t)alpha[i]] = i;
                aa[(uint8_t)(alpha[i] + 32)] = i;  // lowercase
            }
            const char *a3_1 = "ADEHKNPQRST", *a3_2 = "CFILMVWY";
            for (const char *c = a3_1; *c; ++c) aa3[(uint8_t)*c] = 1;
            for (const char *c = a3_2; *c; ++c) aa3[(uint8_t)*c] = 2;
            aa3[(uint8_t)'G'] = 0;
            const char *a4_1 = "AHPST", *a4_2 = "CFILMVWY",
                       *a4_3 = "DEKNQR";
            for (const char *c = a4_1; *c; ++c) aa4[(uint8_t)*c] = 1;
            for (const char *c = a4_2; *c; ++c) aa4[(uint8_t)*c] = 2;
            for (const char *c = a4_3; *c; ++c) aa4[(uint8_t)*c] = 3;
            aa4[(uint8_t)'G'] = 0;
        }
    };
    static const AATabs tabs;
    const int8_t *aa_tab = tabs.aa, *aa3_tab = tabs.aa3,
                 *aa4_tab = tabs.aa4;

    static const uint8_t SS3_MAP[4] = {0, 1, 2, 2};
    for (int p = 0; p < L; ++p) {
        int8_t aa = aa_tab[(uint8_t)seq[p]];
        row(F_AA)[p] = aa < 0 ? 0 : aa;
        row(F_AA3)[p] = seq[p] == 'G' ? 0 : aa3_tab[(uint8_t)seq[p]];
        row(F_AA4)[p] = seq[p] == 'G' ? 0 : aa4_tab[(uint8_t)seq[p]];
        row(F_SS)[p] = ss[p];
        row(F_SS3)[p] = SS3_MAP[ss[p]];
        row(F_Conf)[p] = conf[p];

        int ne = nen[p], re = ren[p];
        row(F_NENSS)[p] = ne < 0 ? 3 : ss[ne];
        row(F_RENSS)[p] = re < 0 ? 3 : ss[re];
        row(F_NENSS3)[p] = ne < 0 ? 0 : SS3_MAP[ss[ne]];
        row(F_RENSS3)[p] = re < 0 ? 0 : SS3_MAP[ss[re]];
        row(F_NENConf)[p] = ne < 0 ? 0 : conf[ne];
        row(F_RENConf)[p] = re < 0 ? 0 : conf[re];

        double nd = ne < 0 ? DEFAULT_NENDIST : (double)C.dist(p, ne);
        double rd = re < 0 ? DEFAULT_NENDIST : (double)C.dist(p, re);
        row(F_NENDist)[p] = bin_value(bins_NENDist, 15, nd);
        row(F_RENDist)[p] = bin_value(bins_RENDist, 15, rd);
        row(F_NENDist4)[p] = row(F_NENDist)[p] / 4;
        row(F_RENDist4)[p] = row(F_RENDist)[p] / 4;

        row(F_NormDens)[p] = bin_value(bins_NormDens, 15, dens[p]);
        row(F_NormDens4)[p] = row(F_NormDens)[p] / 4;
        row(F_HelixDens)[p] = bin_value(bins_HelixDens, 15, helixd[p]);
        row(F_StrandDens)[p] = bin_value(bins_StrandDens, 15, strandd[p]);
        row(F_NX)[p] = bin_value(bins_NX, 15, nx[p]);

        // DstNxtHlx: first helix mid > p + margin (dss.cpp:866-881)
        double dnh = 0;
        for (size_t k = 0; k < h_mids.size(); ++k) {
            if (h_mids[k] <= p + SSE_MARGIN) continue;
            dnh = C.dist(p, h_mids[k]);
            break;
        }
        row(F_DstNxtHlx)[p] = bin_value(bins_DstNxtHlx, 15, dnh);

        // DstPrvHlx with the reference's mirrored-candidate quirk
        // (dss.cpp:849-864: char check cs[N-1-i], mid Mids[i])
        double dph = 0;
        {
            size_t n = all_mids.size();
            for (size_t i = 0; i < n; ++i) {
                if (!mid_is_h[n - 1 - i]) continue;
                int mid = all_mids[i];
                if (mid + SSE_MARGIN >= p) continue;
                dph = C.dist(p, mid);
                break;
            }
        }
        row(F_DstPrvHlx)[p] = bin_value(bins_DstPrvHlx, 15, dph);

        // PMDist
        double pmd = 0;
        if (L >= 8) {
            int p1 = p - PM_DELTA < 0 ? 0 : p - PM_DELTA;
            int p2 = p + PM_DELTA >= L ? L - 1 : p + PM_DELTA;
            pmd = C.dist(p1, p2);
        }
        row(F_PMDist)[p] = bin_value(bins_PMDist, 15, pmd);

        // Mu = SS3 + 3*NENSS3 + 9*RENDist4 (dss.cpp:629-644)
        row(F_Mu)[p] = row(F_SS3)[p] + 3 * row(F_NENSS3)[p]
                       + 9 * row(F_RENDist4)[p];
    }
    return 0;
}

int dss_feature_count() { return F_COUNT; }

}  // extern "C"
