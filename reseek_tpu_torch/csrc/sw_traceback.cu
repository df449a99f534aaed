// Bit-exact Smith-Waterman wavefront: with per-cell traceback bytes
// (stage 3), or score only (stage 2's exact scores and the self-reversal
// scores).
//
// Replaces the Pallas kernels reseek_tpu/ops/sw_pallas.py
// sw_traceback_pallas (_trace_kernel) and sw_score_pallas
// (_score_kernel).  Same per-cell float32 arithmetic and tie rules as
// their _step (itself ops/sw_np.py and src/sw.cpp:79-212):
//   E = E_open >= E_ext ? E_open : E_ext   (open wins ties: bit 4)
//   F = F_open >= F_ext ? F_open : F_ext   (open wins ties: bit 8)
//   M = H(i-1,j-1); E then F replace it on strict >; 0 >= M floors it
//   H = M + S(i,j)
// with E_open = H(i-2,j-1)+open, E_ext = E(i-1,j)+ext, F_open =
// H(i-1,j-2)+open, F_ext = F(i,j-1)+ext.  Only adds and compares, so there
// is nothing for the compiler to contract.  The best cell is the
// lexicographically smallest (i, j) among the maxima when the maximum is
// > 0, else (0, 0) with best 0: the diagonal rule of the Pallas kernel.
// The score-only instantiation (TRACE = false) compiles out the tb stores
// and the best-cell bookkeeping and keeps a per-thread max, reduced at the
// end as _score_kernel reduces its bestv: its score equals the traced
// instantiation's best bit for bit.
//
// Output tb[d, pair, i] = src | 4*e_pref | 8*f_pref for cell (i, d-i), the
// JAX package's skewed layout.  Cells outside 0 <= d-i < LB, and the rows
// d >= LA+LB-1 that pad the diagonal count, are left unwritten.
//
// What bounds it on the H100: E depends on the row above and F on the
// column to the left, both with float rounding, so no scan closed form is
// exact; the anti-diagonal is the unit of parallel work and a pair is
// LA+LB-1 dependent steps.  The cost is the per-diagonal __syncthreads, so
// the design makes it the only one: one block per pair, threads over the
// A-side lanes (strided, so shared-memory reads and the tb byte stores are
// contiguous across a warp), H kept for the last four diagonals and E for
// the last two in shared-memory rings (a step reads diagonals d-2, d-3 and
// E of d-1 and writes d, so one barrier per step separates readers and
// writers), F and the running best in registers.  Every lane is computed
// with S = NEG outside the band, exactly as the JAX wavefront does, so the
// in-band values match it bit for bit.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -9e9f;
constexpr int MAX_THREADS = 256;

struct Best {
  float v;
  int i, j;
};

__device__ __forceinline__ bool better(const Best& x, const Best& y) {
  return x.v > y.v ||
         (x.v == y.v && (x.i < y.i || (x.i == y.i && x.j < y.j)));
}

template <int V, bool TRACE>
__global__ void __launch_bounds__(MAX_THREADS)
wavefront_kernel(const float* __restrict__ s, float* __restrict__ best,
                 int* __restrict__ best_i, int* __restrict__ best_j,
                 uint8_t* __restrict__ tb, int B, int LA, int LB,
                 float open_, float ext) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int lanes = T * V;
  float* hs = smem;                // H of diagonals d..d-3: 4 x lanes
  float* es = hs + 4 * lanes;      // E of diagonals d, d-1: 2 x lanes
  float* rv = es + 2 * lanes;      // block-reduction scratch [32] x 3
  int* ri = reinterpret_cast<int*>(rv + 32);
  int* rj = ri + 32;

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sp = s + (size_t)pair * LA * LB;

  for (int k = tid; k < 6 * lanes; k += T) hs[k] = NEG;
  float f1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) f1[k] = NEG;
  Best b{0.0f, INT_MAX, INT_MAX};
  __syncthreads();

  const int D = LA + LB - 1;
  for (int d = 0; d < D; ++d) {
    const float* h2 = hs + ((d + 2) & 3) * lanes;   // diagonal d-2
    const float* h3 = hs + ((d + 1) & 3) * lanes;   // diagonal d-3
    float* hw = hs + (d & 3) * lanes;
    const float* e1 = es + ((d + 1) & 1) * lanes;   // diagonal d-1
    float* ew = es + (d & 1) * lanes;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = tid + k * T;
      if (i >= LA) break;
      const int j = d - i;
      const bool in_band = j >= 0 && j < LB;
      const float sv = in_band ? sp[(size_t)i * LB + j] : NEG;

      const float e_open = (i >= 2 ? h3[i - 2] : NEG) + open_;
      const float e_ext = (i >= 1 ? e1[i - 1] : NEG) + ext;
      const bool e_pref = e_open >= e_ext;
      const float e = e_pref ? e_open : e_ext;

      const float f_open = (i >= 1 ? h3[i - 1] : NEG) + open_;
      const float f_ext = f1[k] + ext;
      const bool f_pref = f_open >= f_ext;
      const float f = f_pref ? f_open : f_ext;

      float m = i >= 1 ? h2[i - 1] : NEG;
      int src = 0;
      if (e > m) { m = e; src = 1; }
      if (f > m) { m = f; src = 2; }
      if (0.0f >= m) { m = 0.0f; src = 3; }
      const float h = m + sv;

      hw[i] = h;
      ew[i] = e;
      f1[k] = f;
      if (in_band) {
        if constexpr (TRACE) {
          tb[((size_t)d * B + pair) * LA + i] =
              (uint8_t)(src | (e_pref ? 4 : 0) | (f_pref ? 8 : 0));
          const Best c{h, i, j};
          if (better(c, b)) b = c;
        } else {
          b.v = fmaxf(b.v, h);
        }
      }
    }
    __syncthreads();
  }

  // block-wide best: max value, then (traced) smallest (i, j)
  const int warp = tid >> 5;
  if constexpr (TRACE) {
#pragma unroll
    for (int sh = 16; sh >= 1; sh >>= 1) {
      Best o{__shfl_xor_sync(0xffffffffu, b.v, sh),
             __shfl_xor_sync(0xffffffffu, b.i, sh),
             __shfl_xor_sync(0xffffffffu, b.j, sh)};
      if (better(o, b)) b = o;
    }
    if ((tid & 31) == 0) {
      rv[warp] = b.v;
      ri[warp] = b.i;
      rj[warp] = b.j;
    }
  } else {
#pragma unroll
    for (int sh = 16; sh >= 1; sh >>= 1)
      b.v = fmaxf(b.v, __shfl_xor_sync(0xffffffffu, b.v, sh));
    if ((tid & 31) == 0) rv[warp] = b.v;
  }
  __syncthreads();
  if (tid == 0) {
    Best r{0.0f, INT_MAX, INT_MAX};
    for (int w = 0; w < (T >> 5); ++w) {
      if constexpr (TRACE) {
        const Best o{rv[w], ri[w], rj[w]};
        if (better(o, r)) r = o;
      } else {
        r.v = fmaxf(r.v, rv[w]);
      }
    }
    const bool hit = r.v > 0.0f;
    best[pair] = hit ? r.v : 0.0f;
    if constexpr (TRACE) {
      best_i[pair] = hit ? r.i : 0;
      best_j[pair] = hit ? r.j : 0;
    }
  }
}

template <int V, bool TRACE>
cudaError_t launch(const float* s, float* best, int* bi, int* bj,
                   uint8_t* tb, int B, int LA, int LB, float open_,
                   float ext, cudaStream_t stream) {
  int threads = (LA + V - 1) / V;
  threads = ((threads + 31) / 32) * 32;
  const int lanes = threads * V;
  const size_t smem = sizeof(float) * (6 * lanes + 96);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel<V, TRACE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  wavefront_kernel<V, TRACE><<<B, threads, smem, stream>>>(
      s, best, bi, bj, tb, B, LA, LB, open_, ext);
  return cudaGetLastError();
}

// lane-count variant by LA (LA <= 8192)
template <bool TRACE>
int dispatch(const void* s, void* best, void* best_i, void* best_j,
             void* tb, int B, int LA, int LB, float open_, float ext,
             void* stream) {
  const float* ps = static_cast<const float*>(s);
  float* pb = static_cast<float*>(best);
  int* pi = static_cast<int*>(best_i);
  int* pj = static_cast<int*>(best_j);
  uint8_t* pt = static_cast<uint8_t*>(tb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RESEEK_LAUNCH(V) \
  launch<V, TRACE>(ps, pb, pi, pj, pt, B, LA, LB, open_, ext, st)
  if (LA <= 256) return RESEEK_LAUNCH(1);
  if (LA <= 512) return RESEEK_LAUNCH(2);
  if (LA <= 1024) return RESEEK_LAUNCH(4);
  if (LA <= 2048) return RESEEK_LAUNCH(8);
  if (LA <= 4096) return RESEEK_LAUNCH(16);
  if (LA <= 8192) return RESEEK_LAUNCH(32);
#undef RESEEK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// s [B, LA, LB] float32 (NEG-padded substitution scores); best [B] float32,
// best_i/best_j [B] int32, tb [Dp, B, LA] uint8 (Dp >= LA+LB-1).
// LA <= 8192.
int sw_traceback(const void* s, void* best, void* best_i, void* best_j,
                 void* tb, int B, int LA, int LB, int Dp, float open_,
                 float ext, void* stream) {
  if (B <= 0) return 0;
  if (Dp < LA + LB - 1) return (int)cudaErrorInvalidValue;
  return dispatch<true>(s, best, best_i, best_j, tb, B, LA, LB, open_, ext,
                        stream);
}

// Score only: s [B, LA, LB] float32 -> best [B] float32 (>= 0), equal to
// sw_traceback's best.  LA <= 8192.
int sw_score(const void* s, void* best, int B, int LA, int LB, float open_,
             float ext, void* stream) {
  if (B <= 0) return 0;
  return dispatch<false>(s, best, nullptr, nullptr, nullptr, B, LA, LB,
                         open_, ext, stream);
}

}  // extern "C"
