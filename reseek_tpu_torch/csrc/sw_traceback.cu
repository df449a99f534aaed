// Bit-exact Smith-Waterman wavefront, score only (stage 2's exact scores
// and the self-reversal scores).  Stage 3's wavefront with traceback is
// csrc/sw_align.cu, which reads profiles instead of S.
//
// Replaces the Pallas kernel reseek_tpu/ops/sw_pallas.py sw_score_pallas
// (_score_kernel).  Same per-cell float32 arithmetic as its _step (itself
// ops/sw_np.py and src/sw.cpp:79-212):
//   E = E_open >= E_ext ? E_open : E_ext
//   F = F_open >= F_ext ? F_open : F_ext
//   M = H(i-1,j-1); E then F replace it on strict >; 0 >= M floors it
//   H = M + S(i,j)
// with E_open = H(i-2,j-1)+open, E_ext = E(i-1,j)+ext, F_open =
// H(i-1,j-2)+open, F_ext = F(i,j-1)+ext.  Only adds and compares, so there
// is nothing for the compiler to contract.  Each thread keeps a running
// maximum of its in-band H, reduced at the end as _score_kernel reduces its
// bestv; the score is max(0, that maximum), equal bit for bit to the best
// of the traceback wavefront.
//
// What bounds it on the H100: E depends on the row above and F on the
// column to the left, both with float rounding, so no scan closed form is
// exact; the anti-diagonal is the unit of parallel work and a pair is
// LA+LB-1 dependent steps.  The cost is the per-diagonal __syncthreads, so
// the design makes it the only one: one block per pair, threads over the
// A-side lanes (strided, so shared-memory reads are contiguous across a
// warp), H kept for the last four diagonals and E for the last two in
// shared-memory rings (a step reads diagonals d-2, d-3 and E of d-1 and
// writes d, so one barrier per step separates readers and writers), F and
// the running maximum in registers.  Every lane is computed with S = NEG
// outside the band, exactly as the JAX wavefront does, so the in-band
// values match it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -9e9f;
constexpr int MAX_THREADS = 256;

template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
wavefront_kernel(const float* __restrict__ s, float* __restrict__ best,
                 int LA, int LB, float open_, float ext) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int lanes = T * V;
  float* hs = smem;                // H of diagonals d..d-3: 4 x lanes
  float* es = hs + 4 * lanes;      // E of diagonals d, d-1: 2 x lanes
  float* rv = es + 2 * lanes;      // block-reduction scratch [32]

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sp = s + (size_t)pair * LA * LB;

  for (int k = tid; k < 6 * lanes; k += T) hs[k] = NEG;
  float f1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) f1[k] = NEG;
  float b = 0.0f;
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
      const float e = e_open >= e_ext ? e_open : e_ext;

      const float f_open = (i >= 1 ? h3[i - 1] : NEG) + open_;
      const float f_ext = f1[k] + ext;
      const float f = f_open >= f_ext ? f_open : f_ext;

      float m = i >= 1 ? h2[i - 1] : NEG;
      if (e > m) m = e;
      if (f > m) m = f;
      if (0.0f >= m) m = 0.0f;
      const float h = m + sv;

      hw[i] = h;
      ew[i] = e;
      f1[k] = f;
      if (in_band) b = fmaxf(b, h);
    }
    __syncthreads();
  }

  // block-wide maximum
#pragma unroll
  for (int sh = 16; sh >= 1; sh >>= 1)
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, sh));
  if ((tid & 31) == 0) rv[tid >> 5] = b;
  __syncthreads();
  if (tid == 0) {
    float r = 0.0f;
    for (int w = 0; w < (T >> 5); ++w) r = fmaxf(r, rv[w]);
    best[pair] = r > 0.0f ? r : 0.0f;
  }
}

template <int V>
cudaError_t launch(const float* s, float* best, int B, int LA, int LB,
                   float open_, float ext, cudaStream_t stream) {
  int threads = (LA + V - 1) / V;
  threads = ((threads + 31) / 32) * 32;
  const int lanes = threads * V;
  const size_t smem = sizeof(float) * (6 * lanes + 32);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wavefront_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  wavefront_kernel<V><<<B, threads, smem, stream>>>(s, best, LA, LB, open_,
                                                     ext);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Score only: s [B, LA, LB] float32 -> best [B] float32 (>= 0), equal to
// the traceback wavefront's best.  LA <= 8192 (lane-count variant by LA).
int sw_score(const void* s, void* best, int B, int LA, int LB, float open_,
             float ext, void* stream) {
  if (B <= 0) return 0;
  const float* ps = static_cast<const float*>(s);
  float* pb = static_cast<float*>(best);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RESEEK_LAUNCH(V) launch<V>(ps, pb, B, LA, LB, open_, ext, st)
  if (LA <= 256) return RESEEK_LAUNCH(1);
  if (LA <= 512) return RESEEK_LAUNCH(2);
  if (LA <= 1024) return RESEEK_LAUNCH(4);
  if (LA <= 2048) return RESEEK_LAUNCH(8);
  if (LA <= 4096) return RESEEK_LAUNCH(16);
  if (LA <= 8192) return RESEEK_LAUNCH(32);
#undef RESEEK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
