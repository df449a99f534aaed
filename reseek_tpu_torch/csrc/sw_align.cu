// Stage-3 Smith-Waterman with traceback, substitution scores built on chip.
//
// Replaces the Pallas kernel reseek_tpu/ops/sw_pallas.py:230
// (sw_traceback_pallas) together with the gather-sum that fed it its
// substitution tensor (ops/smx.py profile_smx, the JAX engine's smx
// closure): the kernel reads the uint8 profiles of each pair and the
// per-feature substitution tables, so no [B, LA, LB] float tensor exists.
//
// Score of cell (i, j), in feature order, as profile_smx adds it:
//   S = T_0[b_0(j)][a_0(i)];  S = S + T_f[b_f(j)][a_f(i)]  (f = 1..F-1, _rn)
// T_f is feature f's block of the weighted table W with its pad row and
// column (letter index n_f stands for PAD_BYTE), stored B-major, so S
// equals the gather-sum bit for bit, padding included.
//
// Score only (sw_score_profiles): the same kernel instantiated with SCORE,
// replacing the Pallas kernel reseek_tpu/ops/sw_pallas.py:149
// (sw_score_pallas) and the gather-sum that fed it S.  It stores no
// traceback and keeps no best cell, only the running maximum of H over the
// LA x LB cells, floored at 0 (the Pallas _score_kernel's bestv), and reads
// the B side from its own profile tensor (the self-reversal scores read the
// reversed chains' profiles).  It takes the stage-3 kernel's rows a lane:
// 2 rows (eight warps a 512-row pair) were slower than 4 even on a launch
// of 37 pairs (0.236 against 0.224 ms at 37 x 512 x 512 on an H100 80GB
// HBM3 at 700 W, chip_smoke.py phase 2).
//
// Per-cell recurrence and tie rules: those of the Pallas _step
// (src/sw.cpp:79-212):
//   E = E_open >= E_ext ? E_open : E_ext  (E_open = H(i-2,j-1)+open,
//                                          E_ext = E(i-1,j)+ext)
//   F = F_open >= F_ext ? F_open : F_ext  (F_open = H(i-1,j-2)+open,
//                                          F_ext = F(i,j-1)+ext)
//   M = H(i-1,j-1); E, then F, replace it on strict >; 0 >= M floors it
//   H = M + S
// Rows and columns before the first hold NEG in H, E and F.  (The old
// wavefront computed those cells with S = NEG; they come out as NEG
// exactly when |open|, |ext| < 512, NEG's float32 spacing being 1024,
// which the wrapper requires.)  Best cell: the maximum H over the LA x LB
// cells, ties to the lexicographically smallest (i, j); (0, 0) with best 0
// when no cell is > 0.
//
// Design: lane k of a warp owns a strip of R consecutive rows of a tile of
// 32*R rows and sweeps the columns with a lag of one step per lane: at
// step t it computes column j = t - k of its R rows top to bottom, holding
// H and F of the last two columns in registers.  What the strip below
// needs (H of its two last rows and E of its last row, for column j) goes
// to lane k+1 by __shfl_up_sync at the next step.  A pair is one block of
// up to eight warps, one tile each, which run as one wavefront of up to
// 256 lanes: warp w starts 32 + 7 steps after warp w-1, and its lane 0
// reads warp w-1's last-lane values from a shared-memory ring of two
// groups of 8 steps.  The 7 steps of slack put the value a step needs
// in the group before its own, so one block barrier every 8 steps
// suffices (a barrier a step cost about as much as the 7 lookups of the
// score).  Why not one warp a pair: a stage-3 chunk holds at most 256
// pairs at 512x512 (2^26 cells), so a warp a pair leaves one or two warps
// on each SM, each alone on its scheduler, and the sweep is latency-bound;
// several warps a pair, with 4 rows a lane, spread a pair over an SM's
// schedulers (2 rows a lane doubles the warps but adds fill steps and
// issue; 8 rows halves the warps).  Taller shapes run several passes of
// up to eight tiles, the last warp writing the pass's bottom boundary to a scratch row that warp
// 0 of the next pass reads, so LA has no limit.  A-side letter indices
// sit in registers; the tables and, per B column, the start of its row in
// each table (16 bytes, one load a step; LB <= 8192) sit in shared
// memory, both as byte offsets, so a lookup is one add and one load.
//
// Past 8,192 columns, and below for pairs of more than 2,048 rows over at
// least 256 columns (ops/sw_align.py: sw_align_uses_bands), the _long
// entries' band kernel
// takes the pair: its tiles, here bands, run at once on many SMs, where
// one block a pair ran them in passes on one SM and kept B SMs of 132
// busy (2 x 8,192 x 16,384: 4 passes, 56.7 ms; the band kernel 6.9 ms on
// 64 SMs a pair, chip_smoke.py --long, NVIDIA H100 80GB HBM3, 700 W).
// A band is one block of one warp, the same strips and cell code as a
// tile; the rows per lane R and so the band height 32 R come from the
// shape alone (ops/sw_align.py: rows_per_lane): R = 4 from 1,024 columns,
// where more and shorter steps run at once, else 8, where the bands'
// start lag weighs more (chip_smoke.py --bands).  One warp a block spreads the bands over the SMs: two warps of a
// pair on one SM would each keep their own scheduler, but share its
// shared-memory pipe, which the 8 lookups a cell load with bank
// conflicts.  A warp alone on its SM is latency-bound, so each step
// computes the next column's scores (its lookups and their sums) after
// this column's cells, which do not depend on them: the scheduler
// overlaps the two (12% off the band kernel's time).
//  - Handoff: band p's last lane writes H of its two last rows and E of
//    its last row, per column, to a boundary row of its own in device
//    memory ([B, bands - 1, LB, 3] floats), which the entry fills with a
//    NaN pattern no cell takes (SENTINEL).  Every value is written once
//    with a 32-bit relaxed store, so a reader that sees a non-sentinel
//    value sees the final one: no fence and no counter on the path.
//    Band p+1 loads the columns of its next group of BAND_GROUP steps,
//    one a lane, with relaxed loads one group ahead, and at each group
//    start checks the group it is about to sweep (a warp vote) and
//    reloads, backing off, until no value is the sentinel; lane 0 takes
//    its step's value by a shuffle.  So the poll costs one vote a group,
//    and band p+1 settles 2 * BAND_GROUP + 31 steps behind band p.
//  - Ordering: a block takes its (pair, band) from an atomic ticket in
//    the order it starts, pair-major, not from blockIdx, so a band only
//    waits on a band that started before it and is resident; by
//    induction from ticket 0, which waits on nothing, every wait ends,
//    whatever the grid size and however the card schedules the blocks.
//    A band that waits ~8 s for one group traps (SPIN_LIMIT): a protocol
//    fault fails the launch instead of hanging the card.
//  - Fold: each band writes its best (v, i, j), or its maximum, to
//    [B, bands] in the work buffer, fences and counts itself done on its
//    pair; the band that counts last folds the pair's bests.  better()
//    is a total order (larger v, then smaller i, then smaller j), so the
//    fold gives the same cell in any order.
//  - Column words: a first small launch writes each pair's [LB] words
//    of table offsets once, to device memory (they do not fit beside the
//    tables), and every lane loads its column's word one step ahead with
//    __ldg: the 32 lanes of a warp read 32 consecutive columns.
// Given a stats buffer (null unless the caller asks), the kernel also
// counts blocks in flight and marks the SMs each pair ran on, which
// chip_smoke.py prints.  On other shapes the shared-memory kernel stays:
// the band kernel measured 3% slower at phase 2's 213 x 512 x 512 (1.8%
// faster score only at 37 x 512 x 512) and 1.9x slower at 128 x 4,096 x
// 128 (chip_smoke.py --bands; NVIDIA H100 80GB HBM3, 700 W).
// The step is issue- and latency-bound (a few warps an SM), so the code
// that runs per cell is kept short and free of branches: the feature
// count is a template parameter for the default eight (no predicated
// lookups); each row keeps its own best H and the first column it was
// seen at (one compare and two selects a cell), folded into the lane's
// best in row order at the end of a pass, which keeps the (i, j) tie rule;
// the step loop is unrolled by two, which spares the register copies that
// carry H and F from one column to the next.
//
// Traceback: src | 4*e_pref | 8*f_pref, 4 bits a cell, R cells (one lane's
// strip of one column) per word of R/2 bytes, written at
//   tb[pair][tile][step t][lane k]  (steps of a tile: LB + 31),
// so each step of a warp stores 32 consecutive words.  Cells at i >= LA,
// and steps where a lane has no column (j < 0 or j >= LB), hold 0.
// ops/sw_align.py's unpack_tb gives the skewed [Dp, B, LA] bytes back.
//
// Bound on the H100: at 213 pairs of 512x512 the profiles read are ~1.7
// MB and the traceback written 28 MB (4 bits a cell), ~9 us at 3.35 TB/s;
// the ~17 float adds and compares a cell (7 adds of the score, 5 of the
// recurrence, 5 compares) over 55.8 M cells are ~14 us at 67 TFLOP/s, so
// operations bind.  What the kernel issues is ~4x that: a cell also takes
// 8 shared-memory loads and their address adds, the traceback code and
// the best cell, and a step the shuffles, the ring and the store; and
// with one to two warps a scheduler the dependent chains (the E walk
// down a strip, the score sums) leave most issue slots empty.  The band
// kernel on a few long pairs is bound by its wavefront instead: a band
// sweeps LB + 31 steps and starts ~2 * BAND_GROUP + 31 steps after the
// one above, so a pair takes ~LB + bands * 47 steps of one warp alone on
// its SM (~19,400 at 2 x 8,192 x 16,384, ~0.35 us a step); no wavefront
// beats LA + LB dependent cells (the chain bound that chip_smoke.py
// prints beside the operations bound, 0.12 ms there).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -9e9f;
constexpr int MAX_WARPS = 8;       // tiles of a pass, one warp each
constexpr int MAX_F = 8;           // features
constexpr int MAX_LB = 8192;       // B columns staged in shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 8;           // steps between block barriers
constexpr int SLACK = GROUP - 1;   // a warp's extra lag behind the one above
constexpr int BAND_GROUP = 8;      // boundary columns a band loads at once
constexpr unsigned SENTINEL = 0xffffffffu;   // a boundary value not written
constexpr int SM_WORDS = 8;        // words of a pair's SM mask (256 SMs)
// SM cycles a band may wait for one group of its boundary (~8 s at 2 GHz)
constexpr long long SPIN_LIMIT = 1ll << 34;

struct Tables {
  int nf;
  int size[MAX_F];    // alphabet size n_f; letter index n_f is padding
  int off[MAX_F];     // start of T_f in the table array (floats)
};

struct Best {
  float v;
  int i, j;
};

__device__ __forceinline__ bool better(const Best& x, const Best& y) {
  return x.v > y.v ||
         (x.v == y.v && (x.i < y.i || (x.i == y.i && x.j < y.j)));
}

template <int R> struct Word;
template <> struct Word<4> { using T = uint16_t; };
template <> struct Word<8> { using T = uint32_t; };

// letter index of a profile byte: PAD_BYTE (255) -> n_f
__device__ __forceinline__ int letter(uint8_t byte, int n) {
  return byte == 255 ? n : (int)byte;
}

// the byte offset of column j's row in T_f (the column word's f-th half)
__device__ __forceinline__ uint32_t col_word(const uint8_t* pb, int L,
                                             const Tables& tt, int nf, int f,
                                             int j) {
  return f < nf ? 4u * (uint32_t)(tt.off[f] +
                                  letter(pb[(size_t)f * L + j], tt.size[f]) *
                                      (tt.size[f] + 1))
                : 0u;
}

// One lane's strip of R rows from r0, swept a column a step: the state
// carried from column to column in registers, and the step itself.
template <int R, int NF, bool SCORE>
struct Strip {
  int a[R][MAX_F];      // A-side letter indices (byte offsets) of the rows
  float h1[R], h2[R], f1[R];   // H of columns j-1 and j-2, F of j-1
  // the rows above the strip: H(r0-1, j-1), H(r0-2, j-1), H(r0-1, j-2)
  float u1, u2, u1p;
  // what this lane hands down: H of its last two rows, E of its last
  float oh1, oh2, oe;
  // per row, its best H (> 0) and the first column of it; rows past LA
  // start at +inf and never take a cell
  float bv[R];
  int bc[R];
  float mx;             // SCORE: the running maximum
  int r0, rows;         // first row; rows of the strip inside LA
  unsigned rmask;       // the traceback bits of those rows

  __device__ __forceinline__ void start(const uint8_t* pa, int L, int LA,
                                        int first, const Tables& tt,
                                        int nf) {
    r0 = first;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int f = 0; f < MAX_F; ++f) {
        const int i = r0 + r;
        a[r][f] = f < nf ? 4 * letter(i < LA ? pa[(size_t)f * L + i] : 255,
                                      tt.size[f])
                         : 0;
      }
    }
    rows = max(0, min(R, LA - r0));
#pragma unroll
    for (int r = 0; r < R; ++r) h1[r] = h2[r] = f1[r] = NEG;
    u1 = u2 = u1p = NEG;
    oh1 = oh2 = oe = NEG;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bv[r] = r < rows ? 0.0f : __int_as_float(0x7f800000);
      bc[r] = 0;
    }
    rmask = rows >= 8 ? ~0u : (1u << (4 * rows)) - 1u;
  }

  // the start of column j's row in each T_f, from the column's word cv
  __device__ __forceinline__ static void rows_of(uint4 cv,
                                                 int (&cb)[MAX_F]) {
    const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      cb[f] = (int)((cw[f >> 1] >> (16 * (f & 1))) & 0xffffu);
  }

  // the score of row r of the strip at the column of cb
  __device__ __forceinline__ float score(const int (&cb)[MAX_F], int r,
                                         const float* tab, int nf) const {
    const char* tb8 = reinterpret_cast<const char*>(tab);
    float s = *reinterpret_cast<const float*>(tb8 + cb[0] + a[r][0]);
#pragma unroll
    for (int f = 1; f < MAX_F; ++f)
      if (f < nf)
        s = __fadd_rn(s, *reinterpret_cast<const float*>(tb8 + cb[f] +
                                                         a[r][f]));
    return s;
  }

  // the scores of the strip's R cells at the column of word cv
  __device__ __forceinline__ void scores(uint4 cv, const float* tab, int nf,
                                         float (&sc)[R]) const {
    int cb[MAX_F];
    rows_of(cv, cb);
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = score(cb, r, tab, nf);
  }

  // column j's R cells from the rows above (rh1 = H(r0-1, j), rh2 =
  // H(r0-2, j), re1 = E(r0-1, j)) -> the traceback word; their scores
  // from sc (AHEAD: computed before) or from the column's rows cb, row
  // by row.  The shared-memory kernel keeps the row-by-row order: its
  // scores computed before the cells measured 3.6% slower score only at
  // 37 x 512 x 512 (NVIDIA H100 80GB HBM3, 700 W).
  template <bool AHEAD>
  __device__ __forceinline__ unsigned cells(const float (&sc)[R],
                                            const int (&cb)[MAX_F],
                                            float rh1, float rh2, float re1,
                                            int j, const float* tab, int nf,
                                            float open_, float ext) {
    unsigned word = 0;
    float hn[R], fn[R];
    float e_up = re1;          // E(i-1, j)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s = AHEAD ? sc[r] : score(cb, r, tab, nf);
      const float hd = r >= 1 ? h1[r - 1] : u1;       // H(i-1, j-1)
      const float hd2 = r >= 2 ? h1[r - 2] : (r == 1 ? u1 : u2);
      const float hl2 = r >= 1 ? h2[r - 1] : u1p;     // H(i-1, j-2)

      const float e_open = __fadd_rn(hd2, open_);
      const float e_ext = __fadd_rn(e_up, ext);
      const bool e_pref = e_open >= e_ext;
      const float e = e_pref ? e_open : e_ext;

      const float f_open = __fadd_rn(hl2, open_);
      const float f_ext = __fadd_rn(f1[r], ext);
      const bool f_pref = f_open >= f_ext;
      const float fv = f_pref ? f_open : f_ext;

      float m = hd;
      int src = 0;
      if (e > m) { m = e; src = 1; }
      if (fv > m) { m = fv; src = 2; }
      if (0.0f >= m) { m = 0.0f; src = 3; }
      const float h = __fadd_rn(m, s);

      hn[r] = h;
      fn[r] = fv;
      e_up = e;
      word |= (unsigned)(src | (e_pref ? 4 : 0) | (f_pref ? 8 : 0))
              << (4 * r);
    }
    if constexpr (SCORE) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) mx = fmaxf(mx, hn[r]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool up = hn[r] > bv[r];
        bv[r] = up ? hn[r] : bv[r];
        bc[r] = up ? j : bc[r];
      }
    }
    u1p = u1;
    u1 = rh1;
    u2 = rh2;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h2[r] = h1[r];
      h1[r] = hn[r];
      f1[r] = fn[r];
    }
    oh1 = hn[R - 1];
    oh2 = hn[R - 2];
    oe = e_up;
    return word;
  }

  // column j's cells from its word cv, each row's score where the row's
  // cell is computed
  __device__ __forceinline__ unsigned step(uint4 cv, float rh1, float rh2,
                                           float re1, int j, const float* tab,
                                           int nf, float open_, float ext) {
    int cb[MAX_F];
    rows_of(cv, cb);
    const float none[R] = {};
    return cells<false>(none, cb, rh1, rh2, re1, j, tab, nf, open_, ext);
  }

  // the strip's rows in order, columns first-seen, into b: ties go to the
  // smaller (i, j)
  __device__ __forceinline__ void fold(Best& b) const {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const Best c{bv[r], r0 + r, bc[r]};
      if (r < rows && bv[r] > 0.0f && better(c, b)) b = c;
    }
  }
};

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int sh = 16; sh >= 1; sh >>= 1) {
    const Best o{__shfl_xor_sync(FULL, b.v, sh),
                 __shfl_xor_sync(FULL, b.i, sh),
                 __shfl_xor_sync(FULL, b.j, sh)};
    if (better(o, b)) b = o;
  }
  return b;
}

__device__ __forceinline__ float warp_max(float mx) {
#pragma unroll
  for (int sh = 16; sh >= 1; sh >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, sh));
  return mx;
}

// R rows a lane; NF features, or 0 for tt.nf at run time; SCORE: the
// running maximum of H only (best), no traceback and no best cell
template <int R, int NF, bool SCORE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
sw_align_kernel(const uint8_t* __restrict__ prof,
                const uint8_t* __restrict__ prof_b,
                const int64_t* __restrict__ ia, const int64_t* __restrict__ ib,
                const float* __restrict__ tables, int tab_floats, Tables tt,
                int L, int LA, int LB, float open_, float ext,
                float* __restrict__ best, int* __restrict__ best_i,
                int* __restrict__ best_j,
                typename Word<R>::T* __restrict__ tb,
                float* __restrict__ scratch) {
  using W = typename Word<R>::T;
  extern __shared__ __align__(16) float smem[];
  // last lane's H, H, E per step, two groups of GROUP steps
  __shared__ float ring[MAX_WARPS][2 * GROUP][3];
  __shared__ Best wbest[MAX_WARPS];
  float* tab = smem;
  // per B column, the start of its row in each T_f: [LB][MAX_F] uint16
  uint16_t* col = reinterpret_cast<uint16_t*>(smem + ((tab_floats + 3) & ~3));
  for (int k = threadIdx.x; k < tab_floats; k += blockDim.x)
    tab[k] = tables[k];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int pair = blockIdx.x;
  const int nf = NF > 0 ? NF : tt.nf;
  const uint8_t* pa = prof + (size_t)ia[pair] * nf * L;
  const uint8_t* pb = prof_b + (size_t)ib[pair] * nf * L;
  const int steps = LB + 31;                 // of one tile
  const int tile_rows = 32 * R;
  const int tiles = (LA + tile_rows - 1) / tile_rows;
  const int passes = (tiles + nw - 1) / nw;
  float* sc = scratch + (size_t)pair * 3 * LB;   // [LB][3]: H, H, E
#pragma unroll
  for (int f = 0; f < MAX_F; ++f)
    for (int j = threadIdx.x; j < LB; j += blockDim.x)
      col[j * MAX_F + f] = (uint16_t)col_word(pb, L, tt, nf, f, j);
  __syncthreads();

  Best b{0.0f, INT_MAX, INT_MAX};
  Strip<R, NF, SCORE> s;
  s.mx = 0.0f;
  for (int pass = 0; pass < passes; ++pass) {
    const int tile = pass * nw + w;
    const bool live = tile < tiles;
    s.start(pa, L, LA, tile * tile_rows + lane * R, tt, nf);
    const int wlag = (32 + SLACK) * w;      // this warp's first step
    const int lag = wlag + lane;             // j = T - lag
    W* tbw = nullptr;
    if constexpr (!SCORE)
      tbw = tb + ((size_t)pair * tiles + tile) * steps * 32 + lane;
    const int total = steps + (32 + SLACK) * (nw - 1);
    const float* rin = &ring[w > 0 ? w - 1 : 0][0][0];
    float* rout = &ring[w][0][0];
    const bool sc_in = w == 0 && pass > 0;
    const bool sc_out = w == nw - 1 && pass + 1 < passes;

#pragma unroll 2
    for (int T = 0; T < total; ++T) {
      const int j = T - lag;
      const int t = T - wlag;                 // this warp's step
      const bool jin = (unsigned)j < (unsigned)LB;
      const bool on = live && jin;
      uint4 cv = make_uint4(0u, 0u, 0u, 0u);   // this column's table rows
      if (on) cv = *reinterpret_cast<const uint4*>(col + j * MAX_F);
      float rh1 = __shfl_up_sync(FULL, s.oh1, 1);
      float rh2 = __shfl_up_sync(FULL, s.oh2, 1);
      float re1 = __shfl_up_sync(FULL, s.oe, 1);
      if (lane == 0) {
        rh1 = rh2 = re1 = NEG;
        if (jin) {
          if (w > 0) {
            const float* r = rin + 3 * ((T + GROUP) & (2 * GROUP - 1));
            rh1 = r[0];
            rh2 = r[1];
            re1 = r[2];
          } else if (sc_in) {
            rh1 = sc[3 * j];
            rh2 = sc[3 * j + 1];
            re1 = sc[3 * j + 2];
          }
        }
      }
      unsigned word = 0;
      if (on) word = s.step(cv, rh1, rh2, re1, j, tab, nf, open_, ext);
      if (lane == 31) {
        float* r = rout + 3 * (T & (2 * GROUP - 1));
        r[0] = s.oh1;
        r[1] = s.oh2;
        r[2] = s.oe;
        if (sc_out && jin) {
          sc[3 * j] = s.oh1;
          sc[3 * j + 1] = s.oh2;
          sc[3 * j + 2] = s.oe;
        }
      }
      if constexpr (!SCORE) {
        if (live && (unsigned)t < (unsigned)steps)
          tbw[(size_t)t * 32] = (W)(word & s.rmask);
      }
      if ((T & (GROUP - 1)) == GROUP - 1 || T == total - 1) __syncthreads();
    }
    if constexpr (!SCORE) s.fold(b);
  }

  if constexpr (SCORE) {
    const float mx = warp_max(s.mx);
    if (lane == 0) wbest[w].v = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = mx;
      for (int k = 1; k < nw; ++k) m = fmaxf(m, wbest[k].v);
      best[pair] = m;
    }
  } else {
    b = warp_best(b);
    if (lane == 0) wbest[w] = b;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < nw; ++k)
        if (better(wbest[k], b)) b = wbest[k];
      const bool hit = b.v > 0.0f;
      best[pair] = hit ? b.v : 0.0f;
      best_i[pair] = hit ? b.i : 0;
      best_j[pair] = hit ? b.j : 0;
    }
  }
}

// ---- the band kernel (the _long entries; design in the header) ----

__device__ __forceinline__ float ld_relaxed(const float* p) {
  float v;
  asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed(float* p, float v) {
  asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(v));
}

__device__ __forceinline__ bool written(float v) {
  return __float_as_uint(v) != SENTINEL;
}

// The work buffer, int32: [0] the ticket, then done [B] and the bands'
// bests [B][bands][3] (v as float bits, i, j).  The stats buffer, int32,
// when asked for: [0] blocks live, [1] the most live at once, then the SM
// masks [B][SM_WORDS].  ops/sw_align.py's band_work_words,
// band_stats_words and band_stats read the same layouts.
struct Work {
  int* ticket;
  int* done;
  int* bests;
};

__host__ __device__ __forceinline__ Work work_of(int* w, int B) {
  return Work{w, w + 1, w + 1 + B};
}

__host__ __device__ __forceinline__ size_t work_words(int B, int bands) {
  return 1 + (size_t)B + 3 * (size_t)B * bands;
}

__host__ __device__ __forceinline__ size_t stats_words(int B) {
  return 2 + (size_t)B * SM_WORDS;
}

// each pair's column words, gcol [B, LB] of 16 bytes: the start of column
// j's row in each T_f, as the short kernel stages them in shared memory
__global__ void column_words_kernel(const uint8_t* __restrict__ prof_b,
                                    const int64_t* __restrict__ ib,
                                    Tables tt, int L, int B, int LB,
                                    uint4* __restrict__ gcol) {
  const size_t n = (size_t)B * LB;
  for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < n;
       k += (size_t)gridDim.x * blockDim.x) {
    const int pair = (int)(k / LB), j = (int)(k % LB);
    const uint8_t* pb = prof_b + (size_t)ib[pair] * tt.nf * L;
    uint32_t wd[MAX_F / 2];
#pragma unroll
    for (int h = 0; h < MAX_F / 2; ++h)
      wd[h] = col_word(pb, L, tt, tt.nf, 2 * h, j) |
              (col_word(pb, L, tt, tt.nf, 2 * h + 1, j) << 16);
    gcol[k] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// One band (32 R rows) of one pair a block of one warp; B x bands blocks.
// bnd [B][bands - 1][LB][3]: the boundary below band p, SENTINEL where not
// yet written; stats null unless asked for (the lane-0 atomics it takes
// are diagnostics only).
template <int R, int NF, bool SCORE>
__global__ void __launch_bounds__(32)
band_kernel(const uint8_t* __restrict__ prof, const int64_t* __restrict__ ia,
            const float* __restrict__ tables, int tab_floats, Tables tt,
            int L, int B, int LA, int LB, int bands, float open_, float ext,
            float* __restrict__ best, int* __restrict__ best_i,
            int* __restrict__ best_j, typename Word<R>::T* __restrict__ tb,
            float* bnd, const uint4* __restrict__ gcol, int* work,
            int* stats) {
  using W = typename Word<R>::T;
  extern __shared__ __align__(16) float tab[];
  const int lane = threadIdx.x;
  for (int k = lane; k < tab_floats; k += 32) tab[k] = tables[k];
  const Work wk = work_of(work, B);
  int item = 0;
  if (lane == 0) {
    item = atomicAdd(wk.ticket, 1);
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
  __syncwarp();

  const int nf = NF > 0 ? NF : tt.nf;
  const int steps = LB + 31;
  Strip<R, NF, SCORE> s;
  s.mx = 0.0f;
  s.start(prof + (size_t)ia[pair] * nf * L, L, LA, band * 32 * R + lane * R,
          tt, nf);
  const uint4* gcp = gcol + (size_t)pair * LB;
  const size_t row = (size_t)LB * 3;
  const float* bin = band > 0
      ? bnd + ((size_t)pair * (bands - 1) + band - 1) * row : nullptr;
  float* bout = band + 1 < bands
      ? bnd + ((size_t)pair * (bands - 1) + band) * row : nullptr;
  W* tbw = nullptr;
  if constexpr (!SCORE)
    tbw = tb + ((size_t)pair * bands + band) * steps * 32 + lane;

  // the boundary above: lane g < BAND_GROUP holds column G + g of the
  // group G being swept (c*) and of the next (n*)
  float n1 = NEG, n2 = NEG, ne = NEG, c1 = NEG, c2 = NEG, ce = NEG;
  auto fetch = [&](int col) {
    if (bin != nullptr && lane < BAND_GROUP && col < LB) {
      n1 = ld_relaxed(bin + 3 * col);
      n2 = ld_relaxed(bin + 3 * col + 1);
      ne = ld_relaxed(bin + 3 * col + 2);
    }
  };
  auto ready = [&](int col) {
    return bin == nullptr || lane >= BAND_GROUP || col >= LB ||
           (written(n1) && written(n2) && written(ne));
  };
  fetch(lane);
  // this step's scores, computed a step ahead from its column's word, and
  // the next column's word, loaded a step before that: the lookups of the
  // next column overlap the recurrence of this one
  float sc[R];
  const int no_rows[MAX_F] = {};
  s.scores(lane == 0 ? __ldg(gcp) : make_uint4(0u, 0u, 0u, 0u), tab, nf, sc);
  uint4 cvn = (unsigned)(1 - lane) < (unsigned)LB
                  ? __ldg(gcp + 1 - lane) : make_uint4(0u, 0u, 0u, 0u);

#pragma unroll 2
  for (int T = 0; T < steps; ++T) {
    const int j = T - lane;
    const bool jin = (unsigned)j < (unsigned)LB;
    if (bin != nullptr && (T & (BAND_GROUP - 1)) == 0 && T < LB) {
      const int col = T + lane;
      bool ok = ready(col);
      const long long t0 = clock64();
      while (!__all_sync(FULL, ok)) {
        if (!ok) {
          __nanosleep(64);
          fetch(col);
          ok = ready(col);
        }
        // a band that waits this long is a protocol fault: fail the launch
        if (clock64() - t0 > SPIN_LIMIT) __trap();
      }
      c1 = n1;
      c2 = n2;
      ce = ne;
      fetch(col + BAND_GROUP);
    }
    float rh1 = __shfl_up_sync(FULL, s.oh1, 1);
    float rh2 = __shfl_up_sync(FULL, s.oh2, 1);
    float re1 = __shfl_up_sync(FULL, s.oe, 1);
    // lane 0: the band above's boundary (band 0: c* stay NEG)
    const int g = T & (BAND_GROUP - 1);
    const float b1 = __shfl_sync(FULL, c1, g);
    const float b2 = __shfl_sync(FULL, c2, g);
    const float be = __shfl_sync(FULL, ce, g);
    if (lane == 0) {
      rh1 = jin ? b1 : NEG;
      rh2 = jin ? b2 : NEG;
      re1 = jin ? be : NEG;
    }
    unsigned word = 0;
    if (jin)
      word = s.template cells<true>(sc, no_rows, rh1, rh2, re1, j, tab, nf,
                                    open_, ext);
    s.scores(cvn, tab, nf, sc);
    cvn = (unsigned)(j + 2) < (unsigned)LB ? __ldg(gcp + j + 2)
                                           : make_uint4(0u, 0u, 0u, 0u);
    if (lane == 31 && bout != nullptr && jin) {
      st_relaxed(bout + 3 * j, s.oh1);
      st_relaxed(bout + 3 * j + 1, s.oh2);
      st_relaxed(bout + 3 * j + 2, s.oe);
    }
    if constexpr (!SCORE) tbw[(size_t)T * 32] = (W)(word & s.rmask);
  }

  // the band's best (its maximum) to the work buffer; the pair's last band
  // to finish folds them
  int* mine = wk.bests + 3 * ((size_t)pair * bands + band);
  if constexpr (SCORE) {
    const float mx = warp_max(s.mx);
    if (lane == 0) mine[0] = __float_as_int(mx);
  } else {
    Best b{0.0f, INT_MAX, INT_MAX};
    s.fold(b);
    b = warp_best(b);
    if (lane == 0) {
      mine[0] = __float_as_int(b.v);
      mine[1] = b.i;
      mine[2] = b.j;
    }
  }
  __threadfence();
  int prev = 0;
  if (lane == 0) prev = atomicAdd(wk.done + pair, 1);
  prev = __shfl_sync(FULL, prev, 0);
  if (prev == bands - 1) {
    __threadfence();
    const int* all = wk.bests + 3 * (size_t)pair * bands;
    if constexpr (SCORE) {
      float mx = 0.0f;
      for (int k = lane; k < bands; k += 32)
        mx = fmaxf(mx, __int_as_float(ld_relaxed(all + 3 * k)));
      mx = warp_max(mx);
      if (lane == 0) best[pair] = mx;
    } else {
      Best b{0.0f, INT_MAX, INT_MAX};
      for (int k = lane; k < bands; k += 32) {
        const Best c{__int_as_float(ld_relaxed(all + 3 * k)),
                     ld_relaxed(all + 3 * k + 1), ld_relaxed(all + 3 * k + 2)};
        if (better(c, b)) b = c;
      }
      b = warp_best(b);
      if (lane == 0) {
        const bool hit = b.v > 0.0f;
        best[pair] = hit ? b.v : 0.0f;
        best_i[pair] = hit ? b.i : 0;
        best_j[pair] = hit ? b.j : 0;
      }
    }
  }
  if (stats != nullptr && lane == 0) atomicSub(stats, 1);
}

template <int R, int NF, bool SCORE>
cudaError_t launch(const uint8_t* prof, const uint8_t* prof_b,
                   const int64_t* ia, const int64_t* ib, const float* tables,
                   int tab_floats, const Tables& tt, int L, int B, int LA,
                   int LB, float open_, float ext, float* best, int* bi,
                   int* bj, void* tb, float* scratch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)((tab_floats + 3) & ~3) +
                      sizeof(uint16_t) * MAX_F * (size_t)LB;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sw_align_kernel<R, NF, SCORE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (LA + 32 * R - 1) / (32 * R);
  const int warps = tiles < MAX_WARPS ? tiles : MAX_WARPS;
  sw_align_kernel<R, NF, SCORE><<<B, warps * 32, smem, stream>>>(
      prof, prof_b, ia, ib, tables, tab_floats, tt, L, LA, LB, open_, ext,
      best, bi, bj, static_cast<typename Word<R>::T*>(tb), scratch);
  return cudaGetLastError();
}

// The band kernel's launch: the column words, the boundaries set to the
// sentinel and the work (and stats) buffer to 0, then B x bands blocks of
// one warp.
template <int R, int NF, bool SCORE>
cudaError_t launch_bands(const uint8_t* prof, const uint8_t* prof_b,
                         const int64_t* ia, const int64_t* ib,
                         const float* tables, int tab_floats, const Tables& tt,
                         int L, int B, int LA, int LB, float open_, float ext,
                         float* best, int* bi, int* bj, void* tb, float* bnd,
                         uint4* gcol, int* work, int* stats,
                         cudaStream_t stream) {
  const int bands = (LA + 32 * R - 1) / (32 * R);
  const size_t cols = (size_t)B * LB;
  const int grid = (int)((cols + 255) / 256 < 4096 ? (cols + 255) / 256
                                                    : 4096);
  column_words_kernel<<<grid, 256, 0, stream>>>(prof_b, ib, tt, L, B, LB,
                                                gcol);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bands > 1) {
    err = cudaMemsetAsync(bnd, 0xff,
                          sizeof(float) * 3 * cols * (size_t)(bands - 1),
                          stream);
    if (err != cudaSuccess) return err;
  }
  err = cudaMemsetAsync(work, 0, sizeof(int) * work_words(B, bands), stream);
  if (err != cudaSuccess) return err;
  if (stats != nullptr) {
    err = cudaMemsetAsync(stats, 0, sizeof(int) * stats_words(B), stream);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = sizeof(float) * (size_t)tab_floats;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(band_kernel<R, NF, SCORE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  band_kernel<R, NF, SCORE><<<B * bands, 32, smem, stream>>>(
      prof, ia, tables, tab_floats, tt, L, B, LA, LB, bands, open_, ext, best,
      bi, bj, static_cast<typename Word<R>::T*>(tb), bnd, gcol, work, stats);
  return cudaGetLastError();
}

// The feature tables' layout from the alphabet sizes; false if the shape
// or the tables are outside what the kernel takes (bands: the band
// kernel, any LB; else LB <= MAX_LB).
bool tables_of(const int* sizes, int F, int tab_floats, int L, int LA,
               int LB, bool bands, Tables* tt) {
  if (F < 1 || F > MAX_F || LA < 1 || LB < 1 || LA > L || LB > L ||
      (!bands && LB > MAX_LB))
    return false;
  *tt = Tables{};
  tt->nf = F;
  int off = 0;
  for (int f = 0; f < F; ++f) {
    tt->size[f] = sizes[f];
    tt->off[f] = off;
    off += (sizes[f] + 1) * (sizes[f] + 1);
  }
  return off == tab_floats && off <= 16383;
}

// One entry for the four kinds: SCORE (no traceback, no best cell) and
// BANDS (the band kernel, the _long entries: scratch is bnd).
template <bool SCORE, bool BANDS>
int entry(const void* prof, const void* prof_b, const void* ia,
          const void* ib, const void* tables, int tab_floats,
          const int* sizes, int F, int L, int B, int LA, int LB,
          int rows_per_lane, float open_, float ext, void* best,
          void* best_i, void* best_j, void* tb, void* scratch, void* gcol,
          void* work, void* stats, void* stream) {
  if (B <= 0) return 0;
  Tables tt;
  if (!tables_of(sizes, F, tab_floats, L, LA, LB, BANDS, &tt) ||
      (BANDS && (gcol == nullptr || work == nullptr)))
    return (int)cudaErrorInvalidValue;
  const uint8_t* p = static_cast<const uint8_t*>(prof);
  const uint8_t* q = static_cast<const uint8_t*>(prof_b);
  const int64_t* pia = static_cast<const int64_t*>(ia);
  const int64_t* pib = static_cast<const int64_t*>(ib);
  const float* tab = static_cast<const float*>(tables);
  float* pb = static_cast<float*>(best);
  int* pi = static_cast<int*>(best_i);
  int* pj = static_cast<int*>(best_j);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RESEEK_LAUNCH(R, NF)                                                 \
  (BANDS ? launch_bands<R, NF, SCORE>(                                       \
               p, q, pia, pib, tab, tab_floats, tt, L, B, LA, LB, open_, ext, \
               pb, pi, pj, tb, sc, static_cast<uint4*>(gcol),                \
               static_cast<int*>(work), static_cast<int*>(stats), st)        \
         : launch<R, NF, SCORE>(p, q, pia, pib, tab, tab_floats, tt, L, B,   \
                                LA, LB, open_, ext, pb, pi, pj, tb, sc, st))
  if (rows_per_lane == 4)
    return F == MAX_F ? RESEEK_LAUNCH(4, MAX_F) : RESEEK_LAUNCH(4, 0);
  if (rows_per_lane == 8)
    return F == MAX_F ? RESEEK_LAUNCH(8, MAX_F) : RESEEK_LAUNCH(8, 0);
#undef RESEEK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// prof [N, F, L] uint8 (255 past a chain's end); ia, ib [B] int64 rows of
// prof; tables: the F blocks T_f [(n_f+1) x (n_f+1)] float32, B-major, one
// after another (tab_floats in all); sizes [F] the alphabet sizes (host
// memory).  best [B] float32, best_i/best_j [B] int32; tb: B x tiles x
// (LB + 31) x 32 words of R/2 bytes (R = rows_per_lane, 4 or 8, with
// tiles = ceil(LA / (32 R))); scratch [B, LB, 3] float32 when tiles > 8
// (else unused).  F <= 8, 1 <= LB <= 8192, at most 16,383 table floats
// (byte offsets into them fit 16 bits).
int sw_align(const void* prof, const void* ia, const void* ib,
             const void* tables, int tab_floats, const int* sizes, int F,
             int L, int B, int LA, int LB, int rows_per_lane, float open_,
             float ext, void* best, void* best_i, void* best_j, void* tb,
             void* scratch, void* stream) {
  return entry<false, false>(prof, prof, ia, ib, tables, tab_floats, sizes,
                             F, L, B, LA, LB, rows_per_lane, open_, ext, best,
                             best_i, best_j, tb, scratch, nullptr, nullptr,
                             nullptr, stream);
}

// sw_align by the band kernel, any LB >= 1 (ops/sw_align.py:
// sw_align_uses_bands): tb as
// sw_align's (tiles = bands); bnd [B, bands - 1, LB, 3] float32 (unused
// when bands = 1); gcol B x LB 16-byte words, 16-byte aligned; work
// int32 [1 + B + 3 B bands]; stats null, or int32 [2 + 8 B] for the
// blocks in flight and each pair's SMs.
int sw_align_long(const void* prof, const void* ia, const void* ib,
                  const void* tables, int tab_floats, const int* sizes, int F,
                  int L, int B, int LA, int LB, int rows_per_lane,
                  float open_, float ext, void* best, void* best_i,
                  void* best_j, void* tb, void* bnd, void* gcol, void* work,
                  void* stats, void* stream) {
  return entry<false, true>(prof, prof, ia, ib, tables, tab_floats, sizes, F,
                            L, B, LA, LB, rows_per_lane, open_, ext, best,
                            best_i, best_j, tb, bnd, gcol, work, stats,
                            stream);
}

// Score only: the pairs (prof[ia], prof_b[ib]), prof and prof_b both
// [N, F, L] uint8, as sw_align -> best [B] float32 (>= 0), the maximum H
// floored at 0.  rows_per_lane 4 or 8; scratch [B, LB, 3] float32 when
// ceil(LA / (32 R)) > 8 (else unused).
int sw_score_profiles(const void* prof, const void* prof_b, const void* ia,
                      const void* ib, const void* tables, int tab_floats,
                      const int* sizes, int F, int L, int B, int LA, int LB,
                      int rows_per_lane, float open_, float ext, void* best,
                      void* scratch, void* stream) {
  return entry<true, false>(prof, prof_b, ia, ib, tables, tab_floats, sizes,
                            F, L, B, LA, LB, rows_per_lane, open_, ext, best,
                            nullptr, nullptr, nullptr, scratch, nullptr,
                            nullptr, nullptr, stream);
}

// sw_score_profiles by the band kernel, any LB >= 1: bnd, gcol, work and
// stats as sw_align_long's.
int sw_score_profiles_long(const void* prof, const void* prof_b,
                           const void* ia, const void* ib, const void* tables,
                           int tab_floats, const int* sizes, int F, int L,
                           int B, int LA, int LB, int rows_per_lane,
                           float open_, float ext, void* best, void* bnd,
                           void* gcol, void* work, void* stats,
                           void* stream) {
  return entry<true, true>(prof, prof_b, ia, ib, tables, tab_floats, sizes,
                           F, L, B, LA, LB, rows_per_lane, open_, ext, best,
                           nullptr, nullptr, nullptr, bnd, gcol, work, stats,
                           stream);
}

}  // extern "C"
