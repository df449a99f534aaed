// Post-alignment kernels of stage 3: the traceback walk and LDDT.
//
// Neither replaces a Pallas kernel: both replace lax.scan code of
// reseek_tpu/ops/postalign_jax.py that eager PyTorch would run as
// hundreds of tiny launches per chunk.
//
// walk_traceback (replaces postalign_jax.walk_traceback_batch): one thread
// per pair walks the traceback backward from the best cell, exactly as the
// scan does on the skewed bytes: the same clamped reads (a read at (i, j)
// goes to skewed location (clip(i+j), clip(i)), i.e. cell (clip(i),
// clip(i+j) - clip(i)), which reads 0 outside 0 <= j < LB), the same state
// machine, the stop-without-decrement rule and done0 = best <= 0, with
// PEND (0) codes after the end.  The traceback is the packed layout of
// csrc/sw_align.cu (4 bits a cell; rows in strips of R per lane, tiles of
// 32 R rows, LB + 31 steps a tile).  Bound on the H100: one dependent
// load per step (latency, not bandwidth); pairs are independent, so all of
// a chunk's pairs are in flight at once, each in a block of one thread:
// pairs sharing a warp diverge at every step and wait on each other's
// scattered loads (the walk at 213 pairs of 512 x 512 took ~3x longer
// with 128 pairs a block), while a warp each spreads them over the SMs.
//
// lddt (replaces postalign_jax.lddt_batch, LDDT_mu_fast of src/lddt.cpp):
// one block per pair.  The O(M^2) column-pair work is spread over the
// threads, one aligned column each (the counts are integers, so their order
// is free); then one thread adds the per-column scores left to right in
// float32, the reference's order.  Bound: the M^2 distance evaluations of a
// pair, ~20 float ops each, from coordinates staged in shared memory.
// Rounding: d^2 = (dx*dx + dy*dy) + dz*dz with every product and sum
// rounded: -fmad stays at nvcc's default (on), but the explicit _rn
// intrinsics are never contracted into FMAs.  IEEE sqrt and division
// (__fsqrt_rn, __fdiv_rn; built without --use_fast_math).  That is
// the plain PyTorch version's rounding; the reference contracts d^2 into
// two FMAs (reseek_tpu/fp.py), which moves a distance by at most an ulp or
// two, inside the `risky` margins (3e-5 on |d1-d2| at each threshold, 1e-3
// on d^2 at R0^2 = 225) that send a pair to the exact host recompute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WALK_THREADS = 1;      // one pair a block (see above)
constexpr int LDDT_THREADS = 256;
constexpr float R0_SQ = 225.0f;

template <int R>
__global__ void __launch_bounds__(WALK_THREADS)
walk_kernel(const uint8_t* __restrict__ tb, const float* __restrict__ best,
            const int* __restrict__ best_i, const int* __restrict__ best_j,
            int* __restrict__ lo_a, int* __restrict__ lo_b,
            int* __restrict__ plen, uint8_t* __restrict__ path_rev, int B,
            int LA, int LB, int Dp) {
  // R (rows a lane) and the 32 lanes of a tile are powers of two: the
  // address of a cell is shifts and masks, since each step's load waits
  // on the index arithmetic before it
  constexpr int LOG_R = R == 4 ? 2 : 3;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= B) return;
  const int steps = Dp + 1;
  const int tiles = (LA + 32 * R - 1) / (32 * R);
  const int words = (LB + 31) * 32;               // words of a tile
  const uint8_t* ptb = tb + (size_t)p * tiles * words * (R / 2);
  uint8_t* out = path_rev + (size_t)p * steps;
  // the code of skewed location (clip(i+j), clip(i)) of this pair
  auto at = [&](int i, int j) -> int {
    const int d = min(max(i + j, 0), Dp - 1);
    const int ic = min(max(i, 0), LA - 1);
    const int jc = d - ic;
    if (jc < 0 || jc >= LB) return 0;
    const int tile = ic >> (5 + LOG_R);
    const int k = (ic >> LOG_R) & 31;
    const int r = ic & (R - 1);
    const int word = tile * words + (jc + k) * 32 + k;
    return (ptb[word * (R / 2) + (r >> 1)] >> (4 * (r & 1))) & 15;
  };
  int i = best_i[p] + 1;
  int j = best_j[p] + 1;
  int st = 0;                     // 0 = M, 1 = D, 2 = I
  bool done = best[p] <= 0.0f;
  int n = 0;
  int t = 0;
  for (; t < steps && !done; ++t) {
    out[t] = (uint8_t)(st + 1);   // PM, PD, PI
    ++n;
    if (st == 0) {
      const int src = at(i - 1, j - 1) & 3;
      if (src == 3) {             // local start: stop without decrement
        done = true;
        continue;
      }
      st = src;
      --i;
      --j;
    } else if (st == 1) {
      st = (at(i, j) & 4) ? 0 : 1;
      --i;
    } else {
      st = (at(i, j) & 8) ? 0 : 2;
      --j;
    }
  }
  for (; t < steps; ++t) out[t] = 0;   // PEND
  lo_a[p] = i - 1;
  lo_b[p] = j - 1;
  plen[p] = n;
}

__device__ __forceinline__ float dist2(float x0, float y0, float z0,
                                       float x1, float y1, float z1) {
  const float dx = __fsub_rn(x0, x1);
  const float dy = __fsub_rn(y0, y1);
  const float dz = __fsub_rn(z0, z1);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool near(float x, float t, float margin) {
  return fabsf(__fsub_rn(x, t)) < margin;
}

__global__ void __launch_bounds__(LDDT_THREADS)
lddt_kernel(const float* __restrict__ cq, const float* __restrict__ ct,
            const uint8_t* __restrict__ valid, const int* __restrict__ ncols,
            float* __restrict__ out, uint8_t* __restrict__ risky, int M,
            int with_risky) {
  extern __shared__ float smem[];
  float* q = smem;                 // [M, 3]
  float* t = q + 3 * M;            // [M, 3]
  float* score = t + 3 * M;        // [M]
  uint8_t* v = reinterpret_cast<uint8_t*>(score + M);   // [M]
  __shared__ int n_cols;

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pq = cq + (size_t)pair * M * 3;
  const float* pt = ct + (size_t)pair * M * 3;
  const uint8_t* pv = valid + (size_t)pair * M;
  if (tid == 0) n_cols = 0;
  for (int k = tid; k < 3 * M; k += LDDT_THREADS) {
    q[k] = pq[k];
    t[k] = pt[k];
  }
  __syncthreads();
  int last = 0;
  for (int c = tid; c < M; c += LDDT_THREADS) {
    v[c] = pv[c];
    if (pv[c]) last = c + 1;
  }
  atomicMax(&n_cols, last);
  __syncthreads();
  // columns past the last valid one score 0 and add nothing to the sum
  const int n = n_cols;

  int flag = 0;
  for (int c = tid; c < n; c += LDDT_THREADS) {
    int pres = 0, cons = 0;
    if (v[c]) {
      const float qx = q[3 * c], qy = q[3 * c + 1], qz = q[3 * c + 2];
      const float tx = t[3 * c], ty = t[3 * c + 1], tz = t[3 * c + 2];
      for (int o = 0; o < n; ++o) {
        if (o == c || !v[o]) continue;
        const float a1 = dist2(qx, qy, qz, q[3 * o], q[3 * o + 1], q[3 * o + 2]);
        const float a2 = dist2(tx, ty, tz, t[3 * o], t[3 * o + 1], t[3 * o + 2]);
        if (with_risky && (near(a1, R0_SQ, 1e-3f) || near(a2, R0_SQ, 1e-3f)))
          flag = 1;
        if (a1 > R0_SQ && a2 > R0_SQ) continue;
        const float dd = fabsf(__fsub_rn(__fsqrt_rn(a1), __fsqrt_rn(a2)));
        pres += (dd <= 0.5f) + (dd <= 1.0f) + (dd <= 2.0f) + (dd <= 4.0f);
        cons += 4;
        if (with_risky && (near(dd, 0.5f, 3e-5f) || near(dd, 1.0f, 3e-5f) ||
                           near(dd, 2.0f, 3e-5f) || near(dd, 4.0f, 3e-5f)))
          flag = 1;
      }
    }
    score[c] = cons > 0 ? __fdiv_rn((float)pres, (float)cons) : 0.0f;
  }
  const int any_flag = __syncthreads_or(flag);
  if (tid == 0) {
    float total = 0.0f;
    for (int c = 0; c < n; ++c) total = __fadd_rn(total, score[c]);
    out[pair] = __fdiv_rn(total, (float)max(ncols[pair], 1));
    if (with_risky) risky[pair] = (uint8_t)(any_flag != 0);
  }
}

}  // namespace

extern "C" {

// tb: csrc/sw_align.cu's packed traceback of a [LA, LB] shape with R rows
// a lane; best [B] float32, best_i/best_j [B] int32; lo_a/lo_b/plen [B]
// int32, path_rev [B, Dp+1] uint8 (Dp >= LA+LB-1).
int walk_traceback(const void* tb, const void* best, const void* best_i,
                   const void* best_j, void* lo_a, void* lo_b, void* plen,
                   void* path_rev, int B, int LA, int LB, int Dp, int R,
                   void* stream) {
  if (B <= 0) return 0;
  if (Dp < LA + LB - 1 || (R != 4 && R != 8))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + WALK_THREADS - 1) / WALK_THREADS;
  auto kernel = R == 4 ? walk_kernel<4> : walk_kernel<8>;
  kernel<<<blocks, WALK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tb), static_cast<const float*>(best),
      static_cast<const int*>(best_i), static_cast<const int*>(best_j),
      static_cast<int*>(lo_a), static_cast<int*>(lo_b),
      static_cast<int*>(plen), static_cast<uint8_t*>(path_rev), B, LA, LB,
      Dp);
  return cudaGetLastError();
}

// cq, ct [B, M, 3] float32, valid [B, M] bool (one byte), ncols [B] int32;
// out [B] float32, risky [B] bool (written only when with_risky != 0).
int lddt(const void* cq, const void* ct, const void* valid, const void* ncols,
         void* out, void* risky, int B, int M, int with_risky, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = sizeof(float) * 7 * (size_t)M + (size_t)M;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lddt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  lddt_kernel<<<B, LDDT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cq), static_cast<const float*>(ct),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(ncols),
      static_cast<float*>(out), static_cast<uint8_t*>(risky), M, with_risky);
  return cudaGetLastError();
}

}  // extern "C"
