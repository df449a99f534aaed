// Native LDDT over aligned columns — exact replica of GetLDDT_mu_fast
// (reference src/lddt.cpp:63-124) float32 semantics:
//   - distance^2 with GCC FMA contraction:
//       d2 = fmaf(dz, dz, fmaf(dx, dx, (float)(dy*dy)))
//     (the reference compiles dx*dx + dy*dy + dz*dz with
//     -ffp-contract=fast; see reseek_tpu/fp.py)
//   - R0 = 15, thresholds {0.5, 1, 2, 4}
//   - column score = (float)preserved / (float)considered
//   - final = sequential float32 sum of column scores / n
//
// Compile with -ffp-contract=off so only the EXPLICIT fmaf calls fuse.
//
// This is the bit-exact host recompute path for device-LDDT boundary
// cases (see ops/postalign_jax.lddt_batch) and the host MKF pipeline;
// the numpy implementation in reseek_tpu/ops/lddt.py stays as the
// differential-test reference.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// cq, ct: [n][3] float32 aligned-column coordinates (already gathered).
// scratch_cons / scratch_pres: caller-provided int64[n] work arrays.
// Returns the LDDT score.
float lddt_pair(const float *cq, const float *ct, int n,
                int64_t *scratch_cons, int64_t *scratch_pres) {
    if (n <= 0)
        return 0.0f;
    const float R0_SQ = 225.0f;
    memset(scratch_cons, 0, sizeof(int64_t) * (size_t)n);
    memset(scratch_pres, 0, sizeof(int64_t) * (size_t)n);

    for (int i = 0; i < n; ++i) {
        const float qx = cq[3 * i], qy = cq[3 * i + 1], qz = cq[3 * i + 2];
        const float tx = ct[3 * i], ty = ct[3 * i + 1], tz = ct[3 * i + 2];
        for (int j = i + 1; j < n; ++j) {
            const float dx1 = qx - cq[3 * j];
            const float dy1 = qy - cq[3 * j + 1];
            const float dz1 = qz - cq[3 * j + 2];
            const float a1 = fmaf(dz1, dz1, fmaf(dx1, dx1, dy1 * dy1));
            const float dx2 = tx - ct[3 * j];
            const float dy2 = ty - ct[3 * j + 1];
            const float dz2 = tz - ct[3 * j + 2];
            const float a2 = fmaf(dz2, dz2, fmaf(dx2, dx2, dy2 * dy2));
            if (a1 > R0_SQ && a2 > R0_SQ)
                continue;
            const float diff = fabsf(sqrtf(a1) - sqrtf(a2));
            const int64_t npres = (int64_t)(diff <= 0.5f) + (diff <= 1.0f) +
                                  (diff <= 2.0f) + (diff <= 4.0f);
            scratch_cons[i] += 4;
            scratch_cons[j] += 4;
            scratch_pres[i] += npres;
            scratch_pres[j] += npres;
        }
    }

    float total = 0.0f;
    for (int i = 0; i < n; ++i) {
        float s = 0.0f;
        if (scratch_cons[i] > 0)
            s = (float)scratch_pres[i] / (float)scratch_cons[i];
        total += s;  // sequential f32 accumulation (src/lddt.cpp:110-123)
    }
    return total / (float)n;
}

}  // extern "C"
