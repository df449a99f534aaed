// The Mu filter (stage 1): best local Smith-Waterman score of Mu letter
// rows under the integer 36-letter table, as a warp-synchronous integer
// wavefront on Hopper's DPX instructions.
//
// Replaces the Pallas kernel reseek_tpu/ops/sw_sweep.py:327
// (mu_sw_score_fused_pallas, _fused_sweep_kernel), which builds each
// substitution row from the 37x37 table and sweeps it.  The earlier port
// of it was a float row sweep, one block a pair, two block barriers a row.
//
// Recurrence (src/sw.cpp, S folded in after the max; open, ext <= 0):
//   E(i,j) = max(H(i-2,j-1) + open, E(i-1,j) + ext)
//   F(i,j) = max(H(i-1,j-2) + open, F(i,j-1) + ext)
//   H(i,j) = max(H(i-1,j-1), E(i,j), F(i,j), 0) + S(i,j)
//   score  = max(0, max H)
// with H, E, F = NEG before the first row and column.  The kernel runs
// the clamped recurrence H' = max(H, 0), E' = max(E, 0), F' = max(F, 0):
//   E' = max(H'(i-2,j-1) + open, E'(i-1,j) + ext, 0)  __viaddmax_relu
//   F' = max(H'(i-1,j-2) + open, F'(i,j-1) + ext, 0)  __viaddmax_relu
//   H' = max(max(H'(i-1,j-1), E', F') + S, 0)      __vimax3, __viaddmax_relu
// which equals max(., 0) of the original at every cell (by induction: a
// negative value and 0 both lose to the final 0 once open and ext are
// <= 0), so the scores are the same, every value lies in [0, hi] with hi
// = max(S, 0) x min(LA, LB), and the boundary is 0.  Padding letter 36
// scores PAD, below -hi, so a padded cell's H' is 0: it neither raises the
// score nor, padding being trailing, feeds a real cell.  The sums that
// can leave [0, hi] are m + S (>= PAD) and H' + open, E' + ext (>= the
// penalty); ops/sw_sweep.py mu_lane_fits proves for each shape that they
// fit the lane type before the wrapper picks it:
//   int16x2: two pairs a 32-bit word, PAD = -32768, when hi <= 32767
//            (min(LA, LB) <= 8191 with the Mu table's largest entry, 4);
//   int32:   one pair a word, PAD = -2^30, while hi < 2^30 (every length
//            the engines reach).
// DPX adds wrap and never saturate; that proof is what makes them exact.
//
// Design: a warp runs one group (two pairs, or one).  Lane k owns a strip
// of R consecutive rows of a tile of 32 R rows and sweeps the columns one
// step behind lane k-1, taking H' of the strip above's last two rows and
// E' of its last row by __shfl_up_sync (the scheme of csrc/sw_align.cu,
// which carries the same two-back reads H(i-2,j-1) and H(i-1,j-2)), so
// the inner loop has no block barrier.  Taller shapes run tiles in
// passes, the last lane writing its boundary row to a global scratch row
// that the next pass reads 32 columns at a time (one coalesced load, then
// a shuffle a step).  The table sits in shared memory (int16, or int32
// with the int32 PAD); each group's B letters sit in shared memory as one
// word a column holding both halves' byte offsets, with 32 padding words
// on each side, so every lane runs every step unpredicated (a step
// outside the real columns computes padding cells, which stay 0).  Rows
// and columns past the last real letter of a group are not swept.
// Past 8,192 columns (mu_wavefront_long, GCOL; int32 lanes only, which a
// square shape that wide needs anyway: hi = 4 x 8,193 > 32,767) the rows
// of words do not fit: each warp writes its group's row, padding words
// included, to a device-memory scratch and reads it from there, a warp's
// 32 lanes reading 32 consecutive words a step (one coalesced load, L1
// hits after the first).  A plain load, not __ldg: the kernel wrote the
// words.
//
// What bounds it on the H100: issue.  A cell pair (int16x2) costs two
// shared-memory loads, their address adds and a byte permute for the
// scores, and five DPX/SIMD operations (E, F, the max, H', H' + open) plus
// half a max for the best; the shuffles and the letter load are shared by
// the R rows of a strip.  About 11 instructions per cell pair, ~5.5 per
// cell, against the float row sweep's ~4x that plus two barriers a row.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MU_N = 37;          // 36 letters + padding
constexpr int MU_PAD = 36;
constexpr int WARPS = 4;          // groups a block, one warp each
constexpr int EDGE = 32;          // padding words on each side of a row
constexpr unsigned FULL = 0xffffffffu;
constexpr int PAD16 = -32768;     // the table's padding entries
constexpr int MAX_LB = 8192;

// two int16 lanes in a word: two pairs at once
struct S16x2 {
  static constexpr int PAIRS = 2;
  using tab_t = int16_t;
  static constexpr int PAD = PAD16;
  static __device__ __forceinline__ uint32_t splat(int v) {
    return (uint32_t)(v & 0xffff) | ((uint32_t)(v & 0xffff) << 16);
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return __vadd2(a, b);
  }
  // max(a + b, c, 0)
  static __device__ __forceinline__ uint32_t addmax0(uint32_t a, uint32_t b,
                                                     uint32_t c) {
    return __viaddmax_s16x2_relu(a, b, c);
  }
  static __device__ __forceinline__ uint32_t max3(uint32_t a, uint32_t b,
                                                  uint32_t c) {
    return __vimax3_s16x2_relu(a, b, c);
  }
  static __device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
    return __vmaxs2(a, b);
  }
  // S of this cell for both pairs: their rows' offsets ra, the column's
  // offsets in the two halves of cw
  static __device__ __forceinline__ uint32_t score(const char* tab,
                                                   const uint32_t (&ra)[2],
                                                   uint32_t cw) {
    const int lo = *reinterpret_cast<const int16_t*>(tab + ra[0] +
                                                     (cw & 0xffffu));
    const int hi = *reinterpret_cast<const int16_t*>(tab + ra[1] + (cw >> 16));
    return __byte_perm((uint32_t)lo, (uint32_t)hi, 0x5410);
  }
  static __device__ __forceinline__ float half(uint32_t w, int h) {
    return (float)(int16_t)(h ? (w >> 16) : (w & 0xffffu));
  }
};

// one int32 lane: one pair a word
struct S32 {
  static constexpr int PAIRS = 1;
  using tab_t = int32_t;
  static constexpr int PAD = -(1 << 30);
  static __device__ __forceinline__ uint32_t splat(int v) {
    return (uint32_t)v;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    return a + b;
  }
  static __device__ __forceinline__ uint32_t addmax0(uint32_t a, uint32_t b,
                                                     uint32_t c) {
    return (uint32_t)__viaddmax_s32_relu((int)a, (int)b, (int)c);
  }
  static __device__ __forceinline__ uint32_t max3(uint32_t a, uint32_t b,
                                                  uint32_t c) {
    return (uint32_t)__vimax3_s32_relu((int)a, (int)b, (int)c);
  }
  static __device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
    return (uint32_t)max((int)a, (int)b);
  }
  static __device__ __forceinline__ uint32_t score(const char* tab,
                                                   const uint32_t (&ra)[1],
                                                   uint32_t cw) {
    return *reinterpret_cast<const uint32_t*>(tab + ra[0] + cw);
  }
  static __device__ __forceinline__ float half(uint32_t w, int) {
    return (float)(int)w;
  }
};

__host__ __device__ constexpr size_t tab_bytes(size_t elem) {
  return (MU_N * MU_N * elem + 15) & ~(size_t)15;
}

// a [B, LA], b [B, LB] uint8 letters; tab16 [37, 37] int16 (PAD16 in the
// padding row and column); bnd [groups, 2, 3, LB] words when LA > 32 R.
// GCOL: the rows of words in gcol [groups, LB + 2 EDGE], not shared memory.
template <class L, int R, bool GCOL>
__global__ void __launch_bounds__(WARPS * 32)
mu_wavefront_kernel(const uint8_t* __restrict__ a,
                    const uint8_t* __restrict__ b,
                    const int16_t* __restrict__ tab16,
                    float* __restrict__ out, uint32_t* __restrict__ bnd,
                    uint32_t* gcol, int B, int LA, int LB, int open_,
                    int ext) {
  using T = typename L::tab_t;
  constexpr int P = L::PAIRS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  for (int k = threadIdx.x; k < MU_N * MU_N; k += blockDim.x) {
    const int v = tab16[k];
    tab[k] = (T)(v == PAD16 ? L::PAD : v);
  }
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int width = LB + 2 * EDGE;
  const int groups = (B + P - 1) / P;
  const int g = blockIdx.x * WARPS + w;
  const bool live = g < groups;
  const int p0 = g * P;
  // column j's word at lw[j + EDGE]: each half's byte offset in a row
  uint32_t* lw =
      GCOL ? gcol + (size_t)g * width
           : reinterpret_cast<uint32_t*>(smem + tab_bytes(sizeof(T))) +
                 (size_t)w * width;
  int lastb = 0, lasta = 0;
  // (GCOL has rows for the live groups only)
  for (int k = lane; k < (GCOL && !live ? 0 : width); k += 32) {
    const int j = k - EDGE;
    uint32_t word = 0;
#pragma unroll
    for (int h = 0; h < P; ++h) {
      int c = MU_PAD;
      if (live && p0 + h < B && j >= 0 && j < LB)
        c = min((int)b[(size_t)(p0 + h) * LB + j], MU_PAD);
      if (c != MU_PAD) lastb = j + 1;
      word |= (uint32_t)(c * (int)sizeof(T)) << (16 * h);
    }
    lw[k] = word;
  }
#pragma unroll
  for (int h = 0; h < P; ++h)
    if (live && p0 + h < B)
      for (int i = lane; i < LA; i += 32)
        if (a[(size_t)(p0 + h) * LA + i] < MU_PAD) lasta = max(lasta, i + 1);
  __syncthreads();
  if (!live) return;
  const int ncols = (int)__reduce_max_sync(FULL, (unsigned)lastb);
  const int nrows = (int)__reduce_max_sync(FULL, (unsigned)lasta);

  const char* tb8 = reinterpret_cast<const char*>(tab);
  const uint32_t openw = L::splat(open_);
  const uint32_t extw = L::splat(ext);
  constexpr int TILE = 32 * R;
  const int tiles = ncols > 0 ? (nrows + TILE - 1) / TILE : 0;
  const int total = ncols + 31;
  uint32_t best = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    const int r0 = tile * TILE + lane * R;
    // byte offsets of the strip's rows in the table, per half
    uint32_t ra[R][P];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < P; ++h) {
        const int i = r0 + r;
        int c = MU_PAD;
        if (i < LA && p0 + h < B)
          c = min((int)a[(size_t)(p0 + h) * LA + i], MU_PAD);
        ra[r][h] = (uint32_t)(c * MU_N * (int)sizeof(T));
      }
    }
    // per row: H' of columns j-1, H' + open of columns j-1 and j-2, F' of
    // column j-1
    uint32_t h1[R], o1[R], o2[R], f1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) h1[r] = o1[r] = o2[r] = f1[r] = 0;
    // the rows above the strip: H'(r0-1, j-1) and, plus open, H'(r0-1,
    // j-1), H'(r0-2, j-1), H'(r0-1, j-2)
    uint32_t u1 = 0, uo1 = 0, uo2 = 0, uo1p = 0;
    // what this lane hands down: H' of its last two rows, E' of its last
    uint32_t oh1 = 0, oh2 = 0, oe = 0;
    // the previous pass's boundary row, 32 columns a batch (lane l holds
    // column 32q + l of batch q): current and next
    const bool bin = tile > 0;
    const bool bout = tile + 1 < tiles;
    const uint32_t* rd = bnd + ((size_t)g * 2 + ((tile + 1) & 1)) * 3 * LB;
    uint32_t* wr = bnd + ((size_t)g * 2 + (tile & 1)) * 3 * LB;
    uint32_t bc[3] = {0, 0, 0}, bn[3] = {0, 0, 0};
    auto batch = [&](int col, uint32_t (&v)[3]) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        v[q] = col < ncols ? rd[(size_t)q * LB + col] : 0u;
    };
    if (bin) {
      batch(lane, bc);
      batch(32 + lane, bn);
    }

#pragma unroll 2
    for (int t = 0; t < total; ++t) {
      const int j = t - lane;
      const uint32_t cw = lw[j + EDGE];
      uint32_t rh1 = __shfl_up_sync(FULL, oh1, 1);
      uint32_t rh2 = __shfl_up_sync(FULL, oh2, 1);
      uint32_t re = __shfl_up_sync(FULL, oe, 1);
      if (bin) {
        const int s = t & 31;
        const uint32_t x1 = __shfl_sync(FULL, bc[0], s);
        const uint32_t x2 = __shfl_sync(FULL, bc[1], s);
        const uint32_t x3 = __shfl_sync(FULL, bc[2], s);
        if (lane == 0) {
          rh1 = x1;
          rh2 = x2;
          re = x3;
        }
        if (s == 31) {
#pragma unroll
          for (int q = 0; q < 3; ++q) bc[q] = bn[q];
          batch(t + 33 + lane, bn);
        }
      } else if (lane == 0) {
        rh1 = rh2 = re = 0;
      }
      uint32_t s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = L::score(tb8, ra[r], cw);
      uint32_t hn[R], fn[R];
      uint32_t e_up = re;            // E'(i-1, j)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t ho2 = r >= 2 ? o1[r - 2] : (r == 1 ? uo1 : uo2);
        const uint32_t hl2 = r >= 1 ? o2[r - 1] : uo1p;
        const uint32_t hd = r >= 1 ? h1[r - 1] : u1;
        const uint32_t e = L::addmax0(e_up, extw, ho2);
        const uint32_t f = L::addmax0(f1[r], extw, hl2);
        hn[r] = L::addmax0(L::max3(hd, e, f), s[r], 0u);
        fn[r] = f;
        e_up = e;
      }
#pragma unroll
      for (int r = 0; r + 1 < R; r += 2)
        best = L::max3(best, hn[r], hn[r + 1]);
      uo1p = uo1;
      u1 = rh1;
      uo1 = L::add(rh1, openw);
      uo2 = L::add(rh2, openw);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        o2[r] = o1[r];
        o1[r] = L::add(hn[r], openw);
        h1[r] = hn[r];
        f1[r] = fn[r];
      }
      oh1 = hn[R - 1];
      oh2 = hn[R - 2];
      oe = e_up;
      if (bout && lane == 31 && (unsigned)j < (unsigned)ncols) {
        wr[j] = oh1;
        wr[(size_t)LB + j] = oh2;
        wr[(size_t)2 * LB + j] = oe;
      }
    }
    // the boundary row written above is read by the next pass
    __syncwarp();
  }
#pragma unroll
  for (int sh = 16; sh >= 1; sh >>= 1)
    best = L::max2(best, __shfl_xor_sync(FULL, best, sh));
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < P; ++h)
      if (p0 + h < B) out[p0 + h] = L::half(best, h);
  }
}

template <class L, int R, bool GCOL>
cudaError_t launch(const uint8_t* a, const uint8_t* b, const int16_t* tab,
                   float* out, uint32_t* bnd, uint32_t* gcol, int B, int LA,
                   int LB, int open_, int ext, cudaStream_t stream) {
  const size_t smem =
      tab_bytes(sizeof(typename L::tab_t)) +
      (GCOL ? 0 : sizeof(uint32_t) * WARPS * (size_t)(LB + 2 * EDGE));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mu_wavefront_kernel<L, R, GCOL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int groups = (B + L::PAIRS - 1) / L::PAIRS;
  const int blocks = (groups + WARPS - 1) / WARPS;
  mu_wavefront_kernel<L, R, GCOL><<<blocks, WARPS * 32, smem, stream>>>(
      a, b, tab, out, bnd, gcol, B, LA, LB, open_, ext);
  return cudaGetLastError();
}

// the arguments both entries check; LB <= max_lb
bool mu_args_ok(int LA, int LB, int max_lb, int open_, int ext, int R,
                const void* bnd) {
  return LA >= 0 && LB >= 1 && LB <= max_lb && open_ <= 0 && ext <= 0 &&
         open_ >= -32767 && ext >= -32767 && (R == 4 || R == 8) &&
         (LA <= 32 * R || bnd != nullptr);
}

}  // namespace

extern "C" {

// a [B, LA] and b [B, LB] uint8 Mu letters (36 = padding; larger letters
// read as padding), tab [37, 37] int16 with -32768 in the padding row and
// column and the 36x36 block in [-32767, 32767]; out [B] float32 best
// local scores (>= 0).  open_, ext in [-32767, 0]; bits 16 (int16x2
// lanes) or 32, as ops/sw_sweep.py mu_lane_bits proves safe; R (rows a
// lane) 4 or 8; bnd [ceil(B / (bits == 16 ? 2 : 1)), 2, 3, LB] uint32
// scratch when LA > 32 R, else unused.  1 <= LB <= 8192.
int mu_wavefront(const void* a, const void* b, const void* tab, void* out,
                 void* bnd, int B, int LA, int LB, int open_, int ext,
                 int bits, int R, void* stream) {
  if (B <= 0) return 0;
  if (!mu_args_ok(LA, LB, MAX_LB, open_, ext, R, bnd) ||
      (bits != 16 && bits != 32))
    return (int)cudaErrorInvalidValue;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  const int16_t* pt = static_cast<const int16_t*>(tab);
  float* po = static_cast<float*>(out);
  uint32_t* pw = static_cast<uint32_t*>(bnd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RESEEK_MU(L, R_) \
  launch<L, R_, false>(pa, pb, pt, po, pw, nullptr, B, LA, LB, open_, ext, s)
  if (bits == 16) return R == 4 ? RESEEK_MU(S16x2, 4) : RESEEK_MU(S16x2, 8);
  return R == 4 ? RESEEK_MU(S32, 4) : RESEEK_MU(S32, 8);
#undef RESEEK_MU
}

// mu_wavefront in int32 lanes for any LB >= 1 (taken past 8,192): gcol
// [B, LB + 64] uint32 scratch (one row of words a pair).  The caller
// proves int32 exact at the shape (ops/sw_sweep.py mu_lane_fits).
int mu_wavefront_long(const void* a, const void* b, const void* tab,
                      void* out, void* bnd, void* gcol, int B, int LA, int LB,
                      int open_, int ext, int R, void* stream) {
  if (B <= 0) return 0;
  if (!mu_args_ok(LA, LB, INT_MAX - 2 * EDGE, open_, ext, R, bnd) ||
      gcol == nullptr)
    return (int)cudaErrorInvalidValue;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = static_cast<const uint8_t*>(b);
  const int16_t* pt = static_cast<const int16_t*>(tab);
  float* po = static_cast<float*>(out);
  uint32_t* pw = static_cast<uint32_t*>(bnd);
  uint32_t* pg = static_cast<uint32_t*>(gcol);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return R == 4 ? launch<S32, 4, true>(pa, pb, pt, po, pw, pg, B, LA, LB,
                                       open_, ext, s)
                : launch<S32, 8, true>(pa, pb, pt, po, pw, pg, B, LA, LB,
                                       open_, ext, s);
}

}  // extern "C"
