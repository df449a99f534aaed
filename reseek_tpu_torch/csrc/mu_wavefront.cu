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
// Past 8,192 columns (mu_wavefront_long; int32 lanes only, which a
// square shape that wide needs anyway: hi = 4 x 8,193 > 32,767) the band
// kernel takes the pair; see the section before its code.
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

// A lane's strip of R rows in the clamped recurrence above, one column a
// step; both kernels run it (mu_wavefront_kernel in lanes of type L, the
// band kernel in S32).
template <class L, int R>
struct MuStrip {
  // per row: H' of column j-1, H' + open of columns j-1 and j-2, F' of
  // column j-1
  uint32_t h1[R], o1[R], o2[R], f1[R];
  // the rows above the strip: H'(r0-1, j-1) and, plus open, H'(r0-1,
  // j-1), H'(r0-2, j-1), H'(r0-1, j-2)
  uint32_t u1, uo1, uo2, uo1p;
  // what this lane hands down: H' of its last two rows, E' of its last
  uint32_t oh1, oh2, oe;

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int r = 0; r < R; ++r) h1[r] = o1[r] = o2[r] = f1[r] = 0;
    u1 = uo1 = uo2 = uo1p = 0;
    oh1 = oh2 = oe = 0;
  }

  // column j: rh1, rh2 H' of the two rows above the strip at column j-1
  // and re E' of the row above at column j (the lane above's hand-down, or
  // the boundary), s the strip's scores; raises best
  __device__ __forceinline__ void step(uint32_t rh1, uint32_t rh2,
                                       uint32_t re, const uint32_t (&s)[R],
                                       uint32_t openw, uint32_t extw,
                                       uint32_t& best) {
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
  }
};

// a [B, LA], b [B, LB] uint8 letters; tab16 [37, 37] int16 (PAD16 in the
// padding row and column); bnd [groups, 2, 3, LB] words when LA > 32 R.
template <class L, int R>
__global__ void __launch_bounds__(WARPS * 32)
mu_wavefront_kernel(const uint8_t* __restrict__ a,
                    const uint8_t* __restrict__ b,
                    const int16_t* __restrict__ tab16,
                    float* __restrict__ out, uint32_t* __restrict__ bnd,
                    int B, int LA, int LB, int open_, int ext) {
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
  uint32_t* lw = reinterpret_cast<uint32_t*>(smem + tab_bytes(sizeof(T))) +
                 (size_t)w * width;
  int lastb = 0, lasta = 0;
  for (int k = lane; k < width; k += 32) {
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
    MuStrip<L, R> st;
    st.start();
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
      uint32_t rh1 = __shfl_up_sync(FULL, st.oh1, 1);
      uint32_t rh2 = __shfl_up_sync(FULL, st.oh2, 1);
      uint32_t re = __shfl_up_sync(FULL, st.oe, 1);
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
      st.step(rh1, rh2, re, s, openw, extw, best);
      if (bout && lane == 31 && (unsigned)j < (unsigned)ncols) {
        wr[j] = st.oh1;
        wr[(size_t)LB + j] = st.oh2;
        wr[(size_t)2 * LB + j] = st.oe;
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

template <class L, int R>
cudaError_t launch(const uint8_t* a, const uint8_t* b, const int16_t* tab,
                   float* out, uint32_t* bnd, int B, int LA, int LB,
                   int open_, int ext, cudaStream_t stream) {
  const size_t smem = tab_bytes(sizeof(typename L::tab_t)) +
                      sizeof(uint32_t) * WARPS * (size_t)(LB + 2 * EDGE);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mu_wavefront_kernel<L, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int groups = (B + L::PAIRS - 1) / L::PAIRS;
  const int blocks = (groups + WARPS - 1) / WARPS;
  mu_wavefront_kernel<L, R><<<blocks, WARPS * 32, smem, stream>>>(
      a, b, tab, out, bnd, B, LA, LB, open_, ext);
  return cudaGetLastError();
}

// the arguments both entries check; LB <= max_lb
bool mu_args_ok(int LA, int LB, int max_lb, int open_, int ext, int R,
                const void* bnd) {
  return LA >= 0 && LB >= 1 && LB <= max_lb && open_ <= 0 && ext <= 0 &&
         open_ >= -32767 && ext >= -32767 && (R == 4 || R == 8) &&
         (LA <= 32 * R || bnd != nullptr);
}


// ---- the band kernel (mu_wavefront_long) ----
//
// Replaces the same Pallas kernel (reseek_tpu/ops/sw_sweep.py:327,
// mu_sw_score_fused_pallas) past 8,192 columns.  A pair there is a few
// long rows: a warp a pair ran its tiles of 32 R rows one after another on
// one SM (2 x 12,032 x 12,032: 47 tiles of 12,062 steps, 82.4 ms with two
// warps busy on the card; chip_smoke.py --long, NVIDIA H100 80GB HBM3,
// 700 W).  What bounds it on the H100 is that chain of dependent steps, not
// the operations (~10 a cell, 0.036 ms at the card's rate) nor the bytes;
// no wavefront beats the LA + LB dependent cells of one pair (its chain
// bound, which chip_smoke.py prints).  So a pair's tiles run at once as
// bands, the scheme of csrc/sw_align.cu's band kernel: a band is one block
// of one warp whose lanes run a tile's strips (MuStrip, in S32), and the bands
// spread over the SMs.  A band starts ~2 BAND_GROUP + 31 steps after the
// one above it, so a pair takes ~LB + bands x 47 steps of a lone warp:
// 2.25 ms at 2 x 12,032 x 12,032 (94 bands a pair on 64-68 SMs, 37x the
// one-warp kernel in the same call; ~0.14 us a step, 15x the chain
// bound; chip_smoke.py --long, NVIDIA H100 80GB HBM3, 700 W).  R (rows a
// lane) comes from ops/sw_sweep.py mu_band_rows: 4 while all the
// launch's blocks fit on the card at once, where a band's step sets the
// time, else 8, which issues fewer instructions a cell (the stage-1
// blocks of 128 pairs of long rows; chip_smoke.py --mu-bands).
//  - Handoff: band p's last lane writes, for each column j < ncols, H' of
//    its last row, H' of the row above and E' of its last row to its own
//    boundary row in device memory ([B, bands - 1, LB, 3] words), which the
//    wrapper fills with SENTINEL first: every DP value lies in [0, 2^30),
//    so no cell takes it.  Each value is written once with a 32-bit
//    relaxed store, so a reader that sees a value other than the sentinel
//    sees the final one: no fence and no counter on the path.  Band p+1's
//    lanes g < BAND_GROUP load the columns of its next group with relaxed
//    loads one group ahead, and at each group start it checks the group it
//    is about to sweep (a warp vote), reloading with backoff until no
//    value is the sentinel.  Columns at or past the pair's ncols are never
//    written: the reader takes them as 0 without waiting.
//  - Ordering: a block takes its (pair, band) from an atomic ticket in the
//    order it starts, pair-major, so a band waits only on a band that
//    started before it; by induction every wait ends, however the card
//    schedules the blocks.  A band that waits ~8 s for one group traps
//    (SPIN_LIMIT): the launch fails and the wrapper raises.
//  - Rows and columns past the pair's last real letter (each band finds
//    them from the letters) are not swept: a band at or past the pair's
//    last tile exits at once, and none after it waits on it.
//  - Best: each band's maximum H' goes into the pair's float out by an
//    integer atomicMax on its bits (non-negative floats order as their
//    bits; out zeroed by the wrapper), so no band waits for another.
//  - The column letters are read from b itself, one byte a lane a step
//    (32 consecutive bytes a warp), a step ahead, and each step computes
//    the next column's table lookups after this column's cells, which do
//    not depend on them: a warp alone on its SM overlaps the two.
// Given a stats buffer (null unless the caller asks), the kernel also
// counts blocks in flight and marks the SMs each pair ran on, in the
// layout of csrc/sw_align.cu's.

constexpr int BAND_GROUP = 8;      // boundary columns a band loads at once
constexpr uint32_t SENTINEL = 0xffffffffu;   // a boundary value not written
constexpr int SM_WORDS = 8;        // words of a pair's SM mask (256 SMs)
// SM cycles a band may wait for one group of its boundary (~8 s at 2 GHz)
constexpr long long SPIN_LIMIT = 1ll << 34;

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v));
}

// one past the last real letter (< MU_PAD) of a row of n letters, 0 if
// none: the warp's maximum
__device__ __forceinline__ int last_letter(const uint8_t* p, int n,
                                           int lane) {
  int last = 0;
#pragma unroll 8
  for (int i = lane; i < n; i += 32)
    if (__ldg(p + i) < MU_PAD) last = i + 1;
  return (int)__reduce_max_sync(FULL, (unsigned)last);
}

// One band (32 R rows) of one pair a block of one warp, B x bands blocks.
// a [B, LA], b [B, LB] letters; out [B] zeroed; bnd [B, bands - 1, LB, 3]
// SENTINEL; ticket one int32, 0; stats null or int32 [2 + SM_WORDS B], 0.
template <int R>
__global__ void __launch_bounds__(32)
mu_band_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
               const int16_t* __restrict__ tab16, float* out, uint32_t* bnd,
               int* ticket, int* stats, int LA, int LB, int bands, int open_,
               int ext) {
  __shared__ int32_t tab[MU_N * MU_N];
  const int lane = threadIdx.x;
  for (int k = lane; k < MU_N * MU_N; k += 32) {
    const int v = tab16[k];
    tab[k] = v == PAD16 ? S32::PAD : v;
  }
  int item = 0;
  if (lane == 0) {
    item = atomicAdd(ticket, 1);
    if (stats != nullptr) atomicMax(stats + 1, atomicAdd(stats, 1) + 1);
  }
  item = __shfl_sync(FULL, item, 0);
  const int pair = item / bands, band = item % bands;
  if (stats != nullptr && lane == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    if (smid < 32 * SM_WORDS)
      atomicOr(reinterpret_cast<unsigned*>(stats) + 2 +
                   (size_t)pair * SM_WORDS + smid / 32,
               1u << (smid % 32));
  }
  const uint8_t* pa = a + (size_t)pair * LA;
  const uint8_t* pb = b + (size_t)pair * LB;
  const int nrows = last_letter(pa, LA, lane);
  const int ncols = last_letter(pb, LB, lane);
  constexpr int TILE = 32 * R;
  const int tiles = ncols > 0 ? (nrows + TILE - 1) / TILE : 0;
  __syncwarp();   // the table
  if (band < tiles) {
    const char* tb8 = reinterpret_cast<const char*>(tab);
    const uint32_t openw = (uint32_t)open_;
    const uint32_t extw = (uint32_t)ext;
    const int r0 = band * TILE + lane * R;
    // byte offsets of the strip's rows in the table
    uint32_t ra[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r0 + r;
      const int c = i < LA ? min((int)__ldg(pa + i), MU_PAD) : MU_PAD;
      ra[r] = (uint32_t)(c * MU_N * 4);
    }
    MuStrip<S32, R> st;
    st.start();
    const size_t row = (size_t)LB * 3;
    const uint32_t* bin =
        band > 0 ? bnd + ((size_t)pair * (bands - 1) + band - 1) * row
                 : nullptr;
    uint32_t* bout =
        band + 1 < tiles ? bnd + ((size_t)pair * (bands - 1) + band) * row
                         : nullptr;
    // the boundary above: lane g < BAND_GROUP holds column G + g of the
    // group G being swept (c*) and of the next (n*); 0 past ncols
    uint32_t n1 = 0, n2 = 0, ne = 0, c1 = 0, c2 = 0, ce = 0;
    auto fetch = [&](int col) {
      if (bin != nullptr && lane < BAND_GROUP) {
        const bool in = col < ncols;
        n1 = in ? ld_relaxed(bin + 3 * (size_t)col) : 0u;
        n2 = in ? ld_relaxed(bin + 3 * (size_t)col + 1) : 0u;
        ne = in ? ld_relaxed(bin + 3 * (size_t)col + 2) : 0u;
      }
    };
    auto ready = [&](int col) {
      return bin == nullptr || lane >= BAND_GROUP || col >= ncols ||
             (n1 != SENTINEL && n2 != SENTINEL && ne != SENTINEL);
    };
    // column j's byte offset in a table row (padding outside [0, ncols))
    auto word = [&](int j) -> uint32_t {
      return (uint32_t)(((unsigned)j < (unsigned)ncols
                             ? min((int)__ldg(pb + j), MU_PAD)
                             : MU_PAD) * 4);
    };
    auto lookups = [&](uint32_t cw, uint32_t (&sc)[R]) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        sc[r] = *reinterpret_cast<const uint32_t*>(tb8 + ra[r] + cw);
    };
    fetch(lane);
    // this step's scores, looked up a step ahead, and the next column's
    // word, loaded a step before that
    uint32_t sc[R];
    lookups(word(-lane), sc);
    uint32_t cwn = word(1 - lane);
    uint32_t best = 0;
    const int total = ncols + 31;
#pragma unroll 2
    for (int T = 0; T < total; ++T) {
      const int j = T - lane;
      if (bin != nullptr && (T & (BAND_GROUP - 1)) == 0 && T < ncols) {
        const int col = T + lane;
        bool ok = ready(col);
        const long long t0 = clock64();
        while (!__all_sync(FULL, ok)) {
          if (!ok) {
            __nanosleep(64);
            fetch(col);
            ok = ready(col);
          }
          // a band that waits this long is a protocol fault: fail the
          // launch
          if (clock64() - t0 > SPIN_LIMIT) __trap();
        }
        c1 = n1;
        c2 = n2;
        ce = ne;
        fetch(col + BAND_GROUP);
      }
      uint32_t rh1 = __shfl_up_sync(FULL, st.oh1, 1);
      uint32_t rh2 = __shfl_up_sync(FULL, st.oh2, 1);
      uint32_t re = __shfl_up_sync(FULL, st.oe, 1);
      // lane 0 (j = T): the band above's boundary, 0 past ncols (band 0:
      // the c* stay 0)
      const int g = T & (BAND_GROUP - 1);
      const uint32_t b1 = __shfl_sync(FULL, c1, g);
      const uint32_t b2 = __shfl_sync(FULL, c2, g);
      const uint32_t be = __shfl_sync(FULL, ce, g);
      if (lane == 0) {
        const bool in = T < ncols;
        rh1 = in ? b1 : 0u;
        rh2 = in ? b2 : 0u;
        re = in ? be : 0u;
      }
      st.step(rh1, rh2, re, sc, openw, extw, best);
      lookups(cwn, sc);
      cwn = word(j + 2);
      if (bout != nullptr && lane == 31 && (unsigned)j < (unsigned)ncols) {
        st_relaxed(bout + 3 * (size_t)j, st.oh1);
        st_relaxed(bout + 3 * (size_t)j + 1, st.oh2);
        st_relaxed(bout + 3 * (size_t)j + 2, st.oe);
      }
    }
#pragma unroll
    for (int sh = 16; sh >= 1; sh >>= 1)
      best = S32::max2(best, __shfl_xor_sync(FULL, best, sh));
    if (lane == 0 && best > 0)
      atomicMax(reinterpret_cast<int*>(out) + pair,
                __float_as_int(S32::half(best, 0)));
  }
  if (stats != nullptr && lane == 0) atomicSub(stats, 1);
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
  launch<L, R_>(pa, pb, pt, po, pw, B, LA, LB, open_, ext, s)
  if (bits == 16) return R == 4 ? RESEEK_MU(S16x2, 4) : RESEEK_MU(S16x2, 8);
  return R == 4 ? RESEEK_MU(S32, 4) : RESEEK_MU(S32, 8);
#undef RESEEK_MU
}

// mu_wavefront by the band kernel, int32 lanes, any LB >= 1 (taken past
// 8,192 columns; the caller proves int32 exact at the shape, ops/
// sw_sweep.py mu_lane_fits): R (rows a lane) 4 or 8, bands = ceil(LA /
// 32 R) a pair.  The wrapper (ops/sw_sweep.py mu_band_scratch; batches
// of mu_band_pairs pairs, so that bnd fits its share of the card's
// memory) hands out [B] zeroed, bnd [B, bands - 1, LB, 3] uint32 filled
// with 0xffffffff (unused when bands = 1), ticket one zeroed int32, and
// stats null or a zeroed int32 [2 + 8 B] for the blocks in flight and
// each pair's SMs.
int mu_wavefront_long(const void* a, const void* b, const void* tab,
                      void* out, void* bnd, void* ticket, void* stats, int B,
                      int LA, int LB, int open_, int ext, int R,
                      void* stream) {
  if (B <= 0 || LA <= 0) return 0;
  if (!mu_args_ok(LA, LB, INT_MAX / 4, open_, ext, R, bnd) ||
      ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  const int bands = (LA + 32 * R - 1) / (32 * R);
  if ((long long)B * bands > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = R == 4 ? mu_band_kernel<4> : mu_band_kernel<8>;
  kernel<<<B * bands, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const int16_t*>(tab), static_cast<float*>(out),
      static_cast<uint32_t*>(bnd), static_cast<int*>(ticket),
      static_cast<int*>(stats), LA, LB, bands, open_, ext);
  return cudaGetLastError();
}

}  // extern "C"
