// Mu-filter Smith-Waterman score, row sweep (stage 1 of the self-search).
//
// Replaces the Pallas kernels reseek_tpu/ops/sw_sweep.py
// sw_score_sweep_pallas (_sweep_kernel, on the bf16 mu_smx_onehot tensor)
// and mu_sw_score_fused_pallas (_fused_sweep_kernel): both compute the best
// local affine SW score of two Mu letter rows under the integer 36-letter
// matrix, and so does this kernel.
//
// Recurrences (src/sw.cpp as written, S folded in after the max):
//   F(i,j) = max(H(i-1,j-2)+open, F(i,j-1)+ext)
//          = j*ext + cummax_{k<=j}(H(i-1,k-2)+open - k*ext)
//   E(i,j) = max(H(i-2,j-1)+open, E(i-1,j)+ext)
//   H(i,j) = max(H(i-1,j-1), E(i,j), F(i,j), 0) + S(i,j)
// Every value of a real cell is a small integer, exact in float32, so any
// evaluation order gives the bits of ops/sw_np.sw_score.  Padding letter 36
// scores NEG/2 (finite) and only ever trails the real letters, so padded
// cells stay hugely negative and never reach the 0-floored best.
//
// What bounds it on the H100: one row is a dependent step (the F scan reads
// the whole previous row), so a pair is LA sequential steps of a block-wide
// max-scan; the cost is the two __syncthreads and the scan per row, not
// memory.  The design keeps everything on chip: the 37x37 table, the B-side
// letters and the two previous H rows live in shared memory and the
// substitution row is a table lookup, so the [B, LA, LB] substitution tensor
// the TPU path materialised is never written.  One block per pair, threads
// over B-side lanes (V contiguous lanes each: a serial scan inside the
// thread, a warp-shuffle scan across lanes, one shared-memory pass across
// warps).  Trailing padding rows of A are skipped: they cannot raise the
// best.  No tensor cores: the work is compares and adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -9e9f;
constexpr int MU_N = 37;    // 36 letters + padding
constexpr int MU_PAD = 36;
constexpr int MAX_THREADS = 256;

template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
mu_sweep_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                const float* __restrict__ mumx, float* __restrict__ out,
                int LA, int LB, float open_, float ext) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int lanes = T * V;
  float* tab = smem;                      // [37*37]
  float* h1s = tab + MU_N * MU_N;         // H(i-1, :)  [lanes]
  float* h2s = h1s + lanes;               // H(i-2, :)  [lanes]
  float* wsum = h2s + lanes;              // per-warp scan totals [32]
  int* la_eff = reinterpret_cast<int*>(wsum + 32);
  uint8_t* bl = reinterpret_cast<uint8_t*>(la_eff + 1);   // [lanes]
  uint8_t* al = bl + lanes;                               // [LA]

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const uint8_t* arow = a + (size_t)pair * LA;
  const uint8_t* brow = b + (size_t)pair * LB;

  if (tid == 0) *la_eff = 0;
  for (int k = tid; k < MU_N * MU_N; k += T) tab[k] = mumx[k];
  for (int j = tid; j < lanes; j += T) {
    bl[j] = j < LB ? brow[j] : (uint8_t)MU_PAD;
    h1s[j] = NEG;
    h2s[j] = NEG;
  }
  __syncthreads();
  // rows after the last real A letter only add NEG/2 everywhere
  int last = 0;
  for (int i = tid; i < LA; i += T) {
    const uint8_t c = arow[i];
    al[i] = c;
    if (c != MU_PAD) last = i + 1;
  }
  atomicMax(la_eff, last);
  __syncthreads();
  const int nrows = *la_eff;

  const int base = tid * V;
  float hp[V], hp2[V], ep[V];
  int bcode[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    hp[k] = NEG;
    hp2[k] = NEG;
    ep[k] = NEG;
    bcode[k] = bl[base + k];
  }
  float best = 0.0f;

  for (int i = 0; i < nrows; ++i) {
    const float* trow = tab + al[i] * MU_N;
    // previous-row neighbours that live in the previous thread's lanes
    const float n1 = base >= 1 ? h1s[base - 1] : NEG;   // H(i-1, base-1)
    const float n2 = base >= 2 ? h1s[base - 2] : NEG;   // H(i-1, base-2)
    const float m1 = base >= 1 ? h2s[base - 1] : NEG;   // H(i-2, base-1)

    float av[V];
    float run = NEG;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float hj2 = k >= 2 ? hp[k - 2] : (k == 1 ? n1 : n2);
      const float kext = (float)(base + k) * ext;
      av[k] = (hj2 + open_) - kext;
      run = fmaxf(run, av[k]);
      av[k] = run;               // inclusive scan inside the thread
    }
    // inclusive max-scan of the per-thread totals across the warp
    float incl = run;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl = fmaxf(incl, o);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = NEG;
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = fmaxf(excl, wsum[w]);

    float h[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float kext = (float)(base + k) * ext;
      const float f = fmaxf(excl, av[k]) + kext;
      const float h2j1 = k >= 1 ? hp2[k - 1] : m1;   // H(i-2, j-1)
      const float e = fmaxf(h2j1 + open_, ep[k] + ext);
      const float h1j1 = k >= 1 ? hp[k - 1] : n1;    // H(i-1, j-1)
      const float m = fmaxf(fmaxf(h1j1, e), fmaxf(f, 0.0f));
      h[k] = m + trow[bcode[k]];
      best = fmaxf(best, h[k]);
      ep[k] = e;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      hp2[k] = hp[k];
      hp[k] = h[k];
      h2s[base + k] = hp2[k];
      h1s[base + k] = h[k];
    }
    __syncthreads();
  }

  // block max of the per-thread bests
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, s));
  if (lane == 0) wsum[warp] = best;
  __syncthreads();
  if (tid == 0) {
    float r = 0.0f;
    for (int w = 0; w < nwarps; ++w) r = fmaxf(r, wsum[w]);
    out[pair] = r;
  }
}

template <int V>
cudaError_t launch(const uint8_t* a, const uint8_t* b, const float* mumx,
                   float* out, int B, int LA, int LB, float open_, float ext,
                   cudaStream_t stream) {
  int threads = (LB + V - 1) / V;
  threads = ((threads + 31) / 32) * 32;
  const int lanes = threads * V;
  const size_t smem = sizeof(float) * (MU_N * MU_N + 2 * lanes + 32) +
                      sizeof(int) + lanes + LA;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mu_sweep_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  mu_sweep_kernel<V><<<B, threads, smem, stream>>>(a, b, mumx, out, LA, LB,
                                                   open_, ext);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a [B, LA] and b [B, LB] uint8 Mu letters (36 = padding), mumx [37, 37]
// float32; out [B] float32 best local scores (>= 0).  LB <= 8192.
int mu_sweep(const void* a, const void* b, const void* mumx, void* out,
             int B, int LA, int LB, float open_, float ext, void* stream) {
  if (B <= 0) return 0;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  const float* pm = static_cast<const float*>(mumx);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (LB <= 256) return launch<1>(pa, pb, pm, po, B, LA, LB, open_, ext, s);
  if (LB <= 512) return launch<2>(pa, pb, pm, po, B, LA, LB, open_, ext, s);
  if (LB <= 1024) return launch<4>(pa, pb, pm, po, B, LA, LB, open_, ext, s);
  if (LB <= 2048) return launch<8>(pa, pb, pm, po, B, LA, LB, open_, ext, s);
  if (LB <= 4096) return launch<16>(pa, pb, pm, po, B, LA, LB, open_, ext, s);
  if (LB <= 8192) return launch<32>(pa, pb, pm, po, B, LA, LB, open_, ext, s);
  return (int)cudaErrorInvalidValue;
}

const char* reseek_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
