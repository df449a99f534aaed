// Smith-Waterman best score by row sweep over float32 substitution rows:
// the score-only prepass of stage 2.
//
// Replaces the Pallas kernel reseek_tpu/ops/sw_sweep.py:206
// (sw_score_sweep_pallas, _sweep_kernel) as the JAX engine's stage-2
// prepass (_stage2_body) uses it: it reads the rows of a float32
// substitution tensor [B, LA, LB].  (The Mu filter, the stage-1 use of the
// row sweep on letters, is csrc/mu_wavefront.cu.)
//
// Recurrences (src/sw.cpp as written, S folded in after the max), in the
// op order of sw_sweep._row_step:
//   F(i,j) = max(H(i-1,j-2)+open, F(i,j-1)+ext)
//          = kext(j) + cummax_{k<=j}((H(i-1,k-2)+open) - kext(k)),
//            kext(k) = float(k)*ext
//   E(i,j) = max(H(i-2,j-1)+open, E(i-1,j)+ext)
//   H(i,j) = max(H(i-1,j-1), E(i,j), F(i,j), 0) + S(i,j)
// Every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract "h + open - float(k)*ext" into an
// FMA: each value is rounded where the plain PyTorch version rounds it,
// and a max-scan is exact in any order, so the kernel equals the plain
// version bit for bit.  The row sweep's rounding differs from the
// wavefront's cell order (a closed form of F), by up to ~1e-3 on profile
// scores; the engine gates its results with a guard band.  Float padding
// is ~NEG (finite), so padded cells stay hugely negative and never reach
// the 0-floored best.
//
// What bounds it on the H100: one row is a dependent step (the F scan
// reads the whole previous row), so a pair is LA sequential steps of a
// block-wide max-scan; the cost is the two __syncthreads and the scan per
// row, not memory.  One block per pair, threads over B-side lanes (V
// contiguous lanes each: a serial scan inside the thread, a warp-shuffle
// scan across lanes, one shared-memory pass across warps); the two
// previous H rows live in shared memory.  Each thread reads its V lanes
// of row i+1 from global memory (float4 loads where aligned, so a warp
// reads one contiguous span along LB) while it computes row i.  No tensor
// cores: the work is compares and adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -9e9f;
constexpr int MAX_THREADS = 256;

// DP state of one thread's V contiguous B-side lanes base..base+V-1.
template <int V>
struct Lanes {
  float hp[V];    // H(i-1, :)
  float hp2[V];   // H(i-2, :)
  float ep[V];    // E(i-1, :)
  float best;
};

template <int V>
__device__ __forceinline__ void init_lanes(Lanes<V>& st) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    st.hp[k] = NEG;
    st.hp2[k] = NEG;
    st.ep[k] = NEG;
  }
  st.best = 0.0f;
}

// One DP row given its substitution values sv.  h1s/h2s [lanes] hold
// H(i-1, :) and H(i-2, :) for the neighbour reads across threads; they
// are rewritten with this row's values after the mid-row barrier (every
// neighbour read precedes it), and the closing barrier publishes them.
template <int V>
__device__ __forceinline__ void sweep_row(Lanes<V>& st, const float (&sv)[V],
                                          float* h1s, float* h2s,
                                          float* wsum, int base, float open_,
                                          float ext) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // previous-row neighbours that live in the previous thread's lanes
  const float n1 = base >= 1 ? h1s[base - 1] : NEG;   // H(i-1, base-1)
  const float n2 = base >= 2 ? h1s[base - 2] : NEG;   // H(i-1, base-2)
  const float m1 = base >= 1 ? h2s[base - 1] : NEG;   // H(i-2, base-1)

  float av[V];
  float run = NEG;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float hj2 = k >= 2 ? st.hp[k - 2] : (k == 1 ? n1 : n2);
    const float kext = __fmul_rn((float)(base + k), ext);
    av[k] = __fsub_rn(__fadd_rn(hj2, open_), kext);
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
    const float kext = __fmul_rn((float)(base + k), ext);
    const float f = __fadd_rn(fmaxf(excl, av[k]), kext);
    const float h2j1 = k >= 1 ? st.hp2[k - 1] : m1;   // H(i-2, j-1)
    const float e = fmaxf(__fadd_rn(h2j1, open_), __fadd_rn(st.ep[k], ext));
    const float h1j1 = k >= 1 ? st.hp[k - 1] : n1;    // H(i-1, j-1)
    const float m = fmaxf(fmaxf(h1j1, e), fmaxf(f, 0.0f));
    h[k] = __fadd_rn(m, sv[k]);
    st.best = fmaxf(st.best, h[k]);
    st.ep[k] = e;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    st.hp2[k] = st.hp[k];
    st.hp[k] = h[k];
    h2s[base + k] = st.hp2[k];
    h1s[base + k] = h[k];
  }
  __syncthreads();
}

// Block max of the per-thread bests (>= 0) into *out.
__device__ __forceinline__ void block_best(float best, float* wsum,
                                           float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, s));
  if (lane == 0) wsum[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r = fmaxf(r, wsum[w]);
    *out = r;
  }
}

// V lanes of one substitution row from global memory; NEG past LB.
template <int V>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int base, int LB, bool vec,
                                         float (&v)[V]) {
  if constexpr (V % 4 == 0) {
    if (vec && base + V <= LB) {
      const float4* r4 = reinterpret_cast<const float4*>(row + base);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 x = __ldg(r4 + q);
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    v[k] = base + k < LB ? __ldg(row + base + k) : NEG;
}

template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
sweep_kernel(const float* __restrict__ s, float* __restrict__ out, int LA,
             int LB, float open_, float ext) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int lanes = T * V;
  float* h1s = smem;                      // H(i-1, :)  [lanes]
  float* h2s = h1s + lanes;               // H(i-2, :)  [lanes]
  float* wsum = h2s + lanes;              // per-warp scan totals [32]

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sp = s + (size_t)pair * LA * LB;
  // float4 loads need 16-byte aligned rows
  const bool vec = (LB & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(s) & 15) == 0;

  for (int j = tid; j < lanes; j += T) {
    h1s[j] = NEG;
    h2s[j] = NEG;
  }
  __syncthreads();

  const int base = tid * V;
  Lanes<V> st;
  init_lanes(st);
  float sv[V];
  if (LA > 0) load_row(sp, base, LB, vec, sv);
  for (int i = 0; i < LA; ++i) {
    // next row's loads are in flight while this row computes
    float nx[V];
    load_row(sp + (size_t)min(i + 1, LA - 1) * LB, base, LB, vec, nx);
    sweep_row(st, sv, h1s, h2s, wsum, base, open_, ext);
#pragma unroll
    for (int k = 0; k < V; ++k) sv[k] = nx[k];
  }
  block_best(st.best, wsum, out + pair);
}

// Threads for LB lanes at V lanes each, a whole number of warps.
template <int V>
int threads_for(int LB) {
  const int t = (LB + V - 1) / V;
  return ((t + 31) / 32) * 32;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int V>
cudaError_t launch_float(const float* s, float* out, int B, int LA, int LB,
                         float open_, float ext, cudaStream_t stream) {
  const int threads = threads_for<V>(LB);
  const size_t smem = sizeof(float) * (2 * threads * V + 32);
  cudaError_t err = allow_smem(sweep_kernel<V>, smem);
  if (err != cudaSuccess) return err;
  sweep_kernel<V><<<B, threads, smem, stream>>>(s, out, LA, LB, open_, ext);
  return cudaGetLastError();
}

}  // namespace

// lane-count variant by LB (LB <= 8192)
#define RESEEK_BY_LB(CALL)                        \
  if (LB <= 256) return CALL(1);                  \
  if (LB <= 512) return CALL(2);                  \
  if (LB <= 1024) return CALL(4);                 \
  if (LB <= 2048) return CALL(8);                 \
  if (LB <= 4096) return CALL(16);                \
  if (LB <= 8192) return CALL(32);                \
  return (int)cudaErrorInvalidValue;

extern "C" {

// s [B, LA, LB] float32 substitution scores (NEG-padded); out [B] float32
// best local scores (>= 0).  LB <= 8192.
int sw_score_sweep(const void* s, void* out, int B, int LA, int LB,
                   float open_, float ext, void* stream) {
  if (B <= 0) return 0;
  const float* ps = static_cast<const float*>(s);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RESEEK_FLOAT(V) launch_float<V>(ps, po, B, LA, LB, open_, ext, st)
  RESEEK_BY_LB(RESEEK_FLOAT)
#undef RESEEK_FLOAT
}

const char* reseek_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
