// Smith-Waterman best score by row sweep, substitution scores built from
// the profiles: the score-only prepass of stage 2.
//
// Replaces the Pallas kernel reseek_tpu/ops/sw_sweep.py:206
// (sw_score_sweep_pallas, _sweep_kernel) as the JAX engine's stage-2
// prepass (_stage2_body) uses it, together with the gather-sum that fed it
// its float32 substitution tensor [B, LA, LB] (ops/smx.py profile_smx):
// the kernel reads the uint8 profiles of each pair and the per-feature
// tables, so no [B, LA, LB] tensor exists.
//
// Score of cell (i, j), in feature order, as profile_smx adds it:
//   S = T_0[a_0(i)][b_0(j)];  S = S + T_f[a_f(i)][b_f(j)]  (f = 1..F-1, _rn)
// with letter index n_f standing for PAD_BYTE, so padding sums to ~NEG bit
// for bit (every feature's pad entry is NEG/F).
//
// Recurrences (src/sw.cpp as written, S folded in after the max), in the
// op order of sw_sweep._row_step:
//   F(i,j) = max(H(i-1,j-2)+open, F(i,j-1)+ext)
//          = kext(j) + cummax_{k<=j}((H(i-1,k-2)+open) - kext(k)),
//            kext(k) = float(k)*ext
//   E(i,j) = max(H(i-2,j-1)+open, E(i-1,j)+ext)
//   H(i,j) = max(H(i-1,j-1), E(i,j), F(i,j), 0) + S(i,j)
// Every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract "h + open - float(k)*ext" into an FMA:
// each value is rounded where the plain PyTorch version rounds it, and a
// max-scan is exact in any order, so the kernel equals the plain version
// (profile_smx, then the row sweep) bit for bit.  The closed form of F
// rounds differently from the wavefront, by up to ~1e-3 on profile
// scores; the engine gates the prepass with a guard band.
//
// Rows past the A chain's own end (the last row with a byte other than
// PAD_BYTE, plus one) are not swept: their cells score ~NEG, so their H
// stays hugely negative and never raises the best, which starts at 0, and
// they feed only the rows below them.  The result is unchanged.
//
// Design for the H100: lanes over B columns, V contiguous columns a lane,
// the row's state (H of the last two rows, E) in registers.  A row's F is
// a serial max-scan inside the lane, then a 5-step __shfl_up_sync scan
// across the warp; the neighbour values H(i-1, base-1), H(i-1, base-2) and
// H(i-2, base-1) come from the lane below by shuffle.  Up to LB 512 a pair
// is one warp (a block of 32 threads), so the row chain has no block
// barrier (up to 512 columns, one warp a pair was faster than two or four
// on the H100).  Wider rows span LB / 256 warps of 8 columns a lane (at
// 34 x 1,024 x 1,024 faster than two warps of 16), LB / 512 warps of 16
// beyond 4,096 columns, where 16 warps are the most: each warp publishes
// its
// scan total and its last lane's H values of the rows above to shared
// memory, one barrier a row (two buffers by row parity), and the first
// two columns of each warp, whose F terms read the warp below, are folded
// into the carry after the barrier (max is exact in any order).
// The tables sit in shared memory A-major, each A row of each T_f in a
// slot of 256 bytes: all lanes of a warp read one row at B letters that
// are at most 64 apart, so no two lanes of a load meet in one bank, and a
// cell's byte offset is slot * 256 + 4 * b, which one byte permute (PRMT)
// assembles from a column word (4 b, a byte a feature) and a row word
// (the slots, a byte a feature).  The A rows' slots are loaded 32 rows at
// a time, a row a lane, one chunk ahead, and broadcast by shuffle each
// row; the B columns' bytes sit in registers for the whole pair.  A row's
// scores are computed first: they do not wait on the recurrence, so they
// fill the latencies of its scan.  (A tree for the lane's scan total, to
// start the warp's scan sooner, measured no faster; unrolling the row
// loop by four instead of two, 1.8x slower.)
//
// What bounds it on the H100: operations.  A cell takes 8 PRMTs, 8
// shared-memory loads and 7 adds for the score, and ~13 adds and maxima
// for the recurrence; the bytes read (the profiles, ~8 KB a pair of 512)
// are nothing beside that.  A warp's V cells a lane are independent
// outside the scan, so one warp a scheduler can keep issuing.
// No tensor cores: the work is adds, maxima and table loads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -9e9f;
constexpr int MAX_F = 8;            // features
constexpr int MAX_WARPS = 16;       // warps of a pair (LB <= 16 * 32 * 16)
constexpr int MAX_LETTERS = 63;     // n_f: 4 * n_f fits a byte
constexpr int MAX_TABLE_FLOATS = 16383;   // as sw_align takes them
constexpr int MAX_SLOTS = 256;      // table rows in shared memory
constexpr int SLOT_FLOATS = 64;     // 256 bytes a row: 4 * letter is its byte
constexpr unsigned FULL = 0xffffffffu;

struct Tables {
  int nf;
  int size[MAX_F];    // alphabet size n_f; letter index n_f is padding
  int off[MAX_F];     // start of T_f in the caller's table array (floats)
  int slot[MAX_F];    // shared-memory row of T_f's A letter 0
};

// letter index of a profile byte: PAD_BYTE (255) -> n_f
__device__ __forceinline__ int letter(uint32_t byte, int n) {
  return byte == 255u ? n : (int)byte;
}

// byte q of x, zero-extended
__device__ __forceinline__ int byte_of(uint32_t x, int q) {
  return (int)__byte_perm(x, 0u, 0x4440u + (unsigned)q);
}

// The profile bytes of row r of the A side (255 where r >= nrows or
// f >= nf), four features a word.
template <int NF>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ pa,
                                         int L, int r, int nrows, int nf,
                                         uint32_t (&raw)[2]) {
  raw[0] = raw[1] = 0u;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    const bool have = (NF > 0 ? f < NF : f < nf) && r < nrows;
    const uint32_t b = have ? (uint32_t)__ldg(pa + (size_t)f * L + r) : 255u;
    raw[f >> 2] |= b << (8 * (f & 3));
  }
}

// The shared-memory rows (slots) of the A letters a_f, three a word in
// bytes 0-2 (byte 3 stays 0).
template <int NF>
__device__ __forceinline__ void row_slots(const uint32_t (&raw)[2],
                                          const Tables& tt, int nf,
                                          uint32_t (&rs)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) rs[q] = 0u;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    if (NF > 0 ? f < NF : f < nf) {
      const int a = letter((uint32_t)byte_of(raw[f >> 2], f & 3), tt.size[f]);
      rs[f / 3] |= (uint32_t)(tt.slot[f] + a) << (8 * (f % 3));
    }
  }
}

// Byte offset of cell (a_f, b_f) in the shared tables, one PRMT: byte 0
// the B letter times 4 (byte f & 3 of a column word), byte 1 the A row's
// slot (byte f % 3 of a row word), bytes 2-3 the row word's byte 3, 0.
__device__ __forceinline__ uint32_t cell_offset(uint32_t col, uint32_t row,
                                                int f) {
  return __byte_perm(col, row,
                     (unsigned)((f & 3) | ((4 + f % 3) << 4) | 0x7700));
}

// V columns a lane; a pair spans blockDim.x / 32 warps, at most MAXW (a
// pair above one warp takes V >= 2; MAXW 8 leaves the compiler 255
// registers a thread, 16 only 128); NF features, or 0 for tt.nf at run
// time
template <int V, int MAXW, int NF>
__global__ void __launch_bounds__(32 * MAXW)
sweep_kernel(const uint8_t* __restrict__ prof,
             const uint8_t* __restrict__ prof_b,
             const int64_t* __restrict__ ia, const int64_t* __restrict__ ib,
             const float* __restrict__ tables, Tables tt, int L, int LA,
             int LB, float open_, float ext, float* __restrict__ best) {
  constexpr bool MULTI = MAXW > 1;
  static_assert(!MULTI || V >= 2, "a warp's edge holds two columns");
  // T_f row a (A letter) at slot tt.slot[f] + a, 256 bytes a slot, entry
  // b at byte 4 b
  extern __shared__ __align__(16) float tab[];
  __shared__ float wsum[2][MAX_WARPS];           // each warp's scan total
  __shared__ float edge[2][MAX_WARPS][3];        // H(i-1,last), H(i-1,last-1),
                                                 // H(i-2,last)
  __shared__ float wbest[MAX_WARPS];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int pair = blockIdx.x;
  const int nf = NF > 0 ? NF : tt.nf;

  // the B-major blocks of the caller, an A row a slot
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    if (f < nf) {
      const int n1 = tt.size[f] + 1;
      const float* src = tables + tt.off[f];
      for (int a = 0; a < n1; ++a)
        for (int b = threadIdx.x; b < n1; b += blockDim.x)
          tab[(tt.slot[f] + a) * SLOT_FLOATS + b] = src[b * n1 + a];
    }
  }

  const uint8_t* pa = prof + (size_t)ia[pair] * nf * L;
  const uint8_t* pb = prof_b + (size_t)ib[pair] * nf * L;

  // rows to sweep: up to the A side's last row that is not all padding
  int nrows = 0;
  for (int i0 = ((LA - 1) >> 5) << 5; i0 >= 0 && nrows == 0; i0 -= 32) {
    const int r = i0 + lane;
    bool real = false;
    if (r < LA) {
#pragma unroll
      for (int f = 0; f < MAX_F; ++f)
        if (f < nf) real |= __ldg(pa + (size_t)f * L + r) != 255;
    }
    const unsigned m = __ballot_sync(FULL, real);
    if (m) nrows = i0 + 32 - __clz((int)m);
  }

  const int base = (w * 32 + lane) * V;   // this lane's first column
  // B letters times 4 (byte offsets into a table row), four features a
  // word; padding past LB
  uint32_t cl[V][2];
  float kx[V];                             // kext of the lane's columns
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = base + k;
    cl[k][0] = cl[k][1] = 0u;
#pragma unroll
    for (int f = 0; f < MAX_F; ++f) {
      if (NF > 0 ? f < NF : f < nf) {
        const uint32_t b = j < LB ? (uint32_t)__ldg(pb + (size_t)f * L + j)
                                  : 255u;
        cl[k][f >> 2] |= (uint32_t)(4 * letter(b, tt.size[f]))
                         << (8 * (f & 3));
      }
    }
    kx[k] = __fmul_rn((float)j, ext);
  }
  __syncthreads();   // the tables

  float hp[V], hp2[V], ep[V];   // H(i-1, :), H(i-2, :), E(i-1, :)
#pragma unroll
  for (int k = 0; k < V; ++k) hp[k] = hp2[k] = ep[k] = NEG;
  float bst = 0.0f;
  const char* tb8 = reinterpret_cast<const char*>(tab);

  uint32_t raw[2], rs[3];
  load_row<NF>(pa, L, lane, nrows, nf, raw);
  // two rows an iteration: no register copies carry the state from one
  // row to the next, and the second row's scores fill the first's waits
#pragma unroll 2
  for (int i = 0; i < nrows; ++i) {
    if ((i & 31) == 0) {
      row_slots<NF>(raw, tt, nf, rs);
      load_row<NF>(pa, L, i + 32 + lane, nrows, nf, raw);   // next chunk
    }
    uint32_t row[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) row[q] = __shfl_sync(FULL, rs[q], i & 31);
    // the row's scores first: they do not wait on the recurrence, so
    // their loads and adds fill the scan's latencies
    float sv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float x = *reinterpret_cast<const float*>(
          tb8 + cell_offset(cl[k][0], row[0], 0));
#pragma unroll
      for (int f = 1; f < MAX_F; ++f)
        if (NF > 0 ? f < NF : f < nf)
          x = __fadd_rn(x, *reinterpret_cast<const float*>(
                               tb8 + cell_offset(cl[k][f >> 2], row[f / 3],
                                                 f)));
      sv[k] = x;
    }

    // previous-row neighbours that live in the lane below
    float n1 = __shfl_up_sync(FULL, hp[V - 1], 1);            // H(i-1, base-1)
    float n2 = V >= 2 ? __shfl_up_sync(FULL, hp[V >= 2 ? V - 2 : 0], 1)
                      : __shfl_up_sync(FULL, hp[0], 2);        // H(i-1, base-2)
    float m1 = __shfl_up_sync(FULL, hp2[V - 1], 1);           // H(i-2, base-1)
    if (lane == 0) n1 = n2 = m1 = NEG;
    if (V == 1 && lane == 1) n2 = NEG;
    // the first lane of a warp above warp 0 reads the warp below after
    // the barrier: its two first F terms wait until then
    const bool later = MULTI && w > 0 && lane == 0;

    float av[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float hj2 = k >= 2 ? hp[k >= 2 ? k - 2 : 0] : (k == 1 ? n1 : n2);
      av[k] = __fsub_rn(__fadd_rn(hj2, open_), kx[k]);
      if (later && k < 2) av[k] = -INFINITY;
      if (k > 0) av[k] = fmaxf(av[k - 1], av[k]);   // inclusive, in the lane
    }
    float incl = av[V - 1];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float o = __shfl_up_sync(FULL, incl, s);
      if (lane >= s) incl = fmaxf(incl, o);
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = -INFINITY;

    if constexpr (MULTI) {
      const int buf = i & 1;
      if (lane == 31) {
        wsum[buf][w] = incl;
        edge[buf][w][0] = hp[V - 1];
        edge[buf][w][1] = hp[V - 2];
        edge[buf][w][2] = hp2[V - 1];
      }
      __syncthreads();
      // the F terms of columns cw, cw+1 of warp u: H(i-1, cw-2), H(i-1,
      // cw-1) of warp u-1, + open, - kext
      float carry = -INFINITY, a0 = -INFINITY, a1 = -INFINITY;
      for (int u = 0; u <= w; ++u) {
        float t0 = -INFINITY, t1 = -INFINITY;
        if (u > 0) {
          const int cw = u * 32 * V;
          t0 = __fsub_rn(__fadd_rn(edge[buf][u - 1][1], open_),
                         __fmul_rn((float)cw, ext));
          t1 = __fsub_rn(__fadd_rn(edge[buf][u - 1][0], open_),
                         __fmul_rn((float)(cw + 1), ext));
        }
        if (u < w) {
          carry = fmaxf(carry, fmaxf(wsum[buf][u], fmaxf(t0, t1)));
        } else {
          a0 = t0;
          a1 = t1;
        }
      }
      if (w > 0) {
        if (lane == 0) {
          n1 = edge[buf][w - 1][0];
          n2 = edge[buf][w - 1][1];
          m1 = edge[buf][w - 1][2];
#pragma unroll
          for (int k = 0; k < V; ++k)
            av[k] = fmaxf(av[k], k >= 1 ? fmaxf(a0, a1) : a0);
          excl = carry;
        } else {
          excl = fmaxf(fmaxf(excl, carry), fmaxf(a0, a1));
        }
      }
    }

    float h[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float fv = __fadd_rn(fmaxf(excl, av[k]), kx[k]);
      const float h2j1 = k >= 1 ? hp2[k >= 1 ? k - 1 : 0] : m1;   // H(i-2, j-1)
      const float e = fmaxf(__fadd_rn(h2j1, open_), __fadd_rn(ep[k], ext));
      const float h1j1 = k >= 1 ? hp[k >= 1 ? k - 1 : 0] : n1;    // H(i-1, j-1)
      const float m = fmaxf(fmaxf(h1j1, e), fmaxf(fv, 0.0f));
      h[k] = __fadd_rn(m, sv[k]);
      bst = fmaxf(bst, h[k]);
      ep[k] = e;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      hp2[k] = hp[k];
      hp[k] = h[k];
    }
  }

#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    bst = fmaxf(bst, __shfl_xor_sync(FULL, bst, s));
  if constexpr (MULTI) {
    if (lane == 0) wbest[w] = bst;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int u = 1; u < (int)(blockDim.x >> 5); ++u)
        bst = fmaxf(bst, wbest[u]);
      best[pair] = bst;
    }
  } else if (lane == 0) {
    best[pair] = bst;
  }
}

template <int V, int MAXW, int NF>
cudaError_t launch(const uint8_t* prof, const uint8_t* prof_b,
                   const int64_t* ia, const int64_t* ib, const float* tables,
                   int slots, const Tables& tt, int L, int B, int LA, int LB,
                   int warps, float open_, float ext, float* best,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * SLOT_FLOATS * (size_t)slots;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<V, MAXW, NF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sweep_kernel<V, MAXW, NF><<<B, 32 * warps, smem, stream>>>(
      prof, prof_b, ia, ib, tables, tt, L, LA, LB, open_, ext, best);
  return cudaGetLastError();
}

// The feature tables' layout from the alphabet sizes (and *slots, the
// table rows in shared memory); false if the shape, the layout or the
// tables are outside what the kernel takes.
bool tables_of(const int* sizes, int F, int tab_floats, int L, int LA,
               int LB, int V, int warps, Tables* tt, int* slots) {
  if (F < 1 || F > MAX_F || LA < 1 || LB < 1 || LA > L || LB > L ||
      warps < 1 || warps > MAX_WARPS || 32 * V * warps < LB ||
      (warps > 1 && V < 2))
    return false;
  *tt = Tables{};
  tt->nf = F;
  int off = 0;
  *slots = 0;
  for (int f = 0; f < F; ++f) {
    if (sizes[f] < 1 || sizes[f] > MAX_LETTERS) return false;
    tt->size[f] = sizes[f];
    tt->off[f] = off;
    tt->slot[f] = *slots;
    off += (sizes[f] + 1) * (sizes[f] + 1);
    *slots += sizes[f] + 1;
  }
  return off == tab_floats && off <= MAX_TABLE_FLOATS &&
         *slots <= MAX_SLOTS;
}

}  // namespace

extern "C" {

// The pairs (prof[ia], prof_b[ib]), prof and prof_b both [N, F, L] uint8
// (255 past a chain's end), ia, ib [B] int64; tables: the F blocks T_f
// [(n_f+1) x (n_f+1)] float32, B-major (as sw_align takes them), one after
// another (tab_floats in all); sizes [F] the alphabet sizes (host memory,
// each <= 63, their sum plus F <= 256).  DP shape LA x LB; V columns a
// lane and `warps` warps a pair, 32 V warps >= LB: one warp with V 1, 2,
// 4, 8 or 16; 2-8 warps with V 8; 9-16 warps with V 8 or 16.
// best [B] float32: the best local score, >= 0.
int sw_score_sweep(const void* prof, const void* prof_b, const void* ia,
                   const void* ib, const void* tables, int tab_floats,
                   const int* sizes, int F, int L, int B, int LA, int LB,
                   int V, int warps, float open_, float ext, void* best,
                   void* stream) {
  if (B <= 0) return 0;
  Tables tt;
  int slots;
  if (!tables_of(sizes, F, tab_floats, L, LA, LB, V, warps, &tt, &slots))
    return (int)cudaErrorInvalidValue;
  const uint8_t* p = static_cast<const uint8_t*>(prof);
  const uint8_t* q = static_cast<const uint8_t*>(prof_b);
  const int64_t* pia = static_cast<const int64_t*>(ia);
  const int64_t* pib = static_cast<const int64_t*>(ib);
  const float* tab = static_cast<const float*>(tables);
  float* pb = static_cast<float*>(best);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RESEEK_LAUNCH(V_, MAXW)                                             \
  (F == MAX_F ? launch<V_, MAXW, MAX_F>(p, q, pia, pib, tab, slots,         \
                                        tt, L, B, LA, LB, warps, open_,     \
                                        ext, pb, st)                        \
              : launch<V_, MAXW, 0>(p, q, pia, pib, tab, slots, tt, L,      \
                                    B, LA, LB, warps, open_, ext, pb, st))
  if (warps == 1) {
    switch (V) {
      case 1: return RESEEK_LAUNCH(1, 1);
      case 2: return RESEEK_LAUNCH(2, 1);
      case 4: return RESEEK_LAUNCH(4, 1);
      case 8: return RESEEK_LAUNCH(8, 1);
      case 16: return RESEEK_LAUNCH(16, 1);
    }
  } else if (warps <= 8) {
    if (V == 8) return RESEEK_LAUNCH(8, 8);
  } else {
    switch (V) {
      case 8: return RESEEK_LAUNCH(8, MAX_WARPS);
      case 16: return RESEEK_LAUNCH(16, MAX_WARPS);
    }
  }
#undef RESEEK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* reseek_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
