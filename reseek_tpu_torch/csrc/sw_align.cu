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
// Per-cell recurrence and tie rules: those of csrc/sw_traceback.cu (the
// Pallas _step, src/sw.cpp:79-212):
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
// issue; it pays only on chunks of a few dozen pairs; 8 rows halves the
// warps).  Taller shapes run several passes of up to eight tiles, the
// last warp writing the pass's bottom boundary to a scratch row that warp
// 0 of the next pass reads, so LA has no limit.  A-side letter indices
// sit in registers; the tables and, per B column, the start of its row in
// each table (16 bytes, one load a step; LB <= 8192) sit in shared
// memory, both as byte offsets, so a lookup is one add and one load.
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
// down a strip, the score sums) leave most issue slots empty.

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

// R rows a lane; NF features, or 0 for tt.nf at run time
template <int R, int NF>
__global__ void __launch_bounds__(MAX_WARPS * 32)
sw_align_kernel(const uint8_t* __restrict__ prof,
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
  const uint8_t* pb = prof + (size_t)ib[pair] * nf * L;
  const int steps = LB + 31;                 // of one tile
  const int tile_rows = 32 * R;
  const int tiles = (LA + tile_rows - 1) / tile_rows;
  const int passes = (tiles + nw - 1) / nw;
  float* sc = scratch + (size_t)pair * 3 * LB;   // [LB][3]: H, H, E
#pragma unroll
  for (int f = 0; f < MAX_F; ++f)
    for (int j = threadIdx.x; j < LB; j += blockDim.x)
      col[j * MAX_F + f] =
          f < nf ? (uint16_t)(4 * (tt.off[f] + letter(pb[(size_t)f * L + j],
                                                      tt.size[f]) *
                                                   (tt.size[f] + 1)))
                 : 0;
  __syncthreads();

  Best b{0.0f, INT_MAX, INT_MAX};
  for (int pass = 0; pass < passes; ++pass) {
    const int tile = pass * nw + w;
    const bool live = tile < tiles;
    const int r0 = tile * tile_rows + lane * R;   // first row of the strip
    // A-side letter indices of the strip; rows of the strip inside LA
    int a[R][MAX_F];
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
    const int rows = max(0, min(R, LA - r0));
    // H of columns j-1 and j-2 and F of column j-1, per row of the strip
    float h1[R], h2[R], f1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) h1[r] = h2[r] = f1[r] = NEG;
    // the rows above the strip: H(r0-1, j-1), H(r0-2, j-1), H(r0-1, j-2)
    float u1 = NEG, u2 = NEG, u1p = NEG;
    // what this lane hands down: H of its last two rows, E of its last
    float oh1 = NEG, oh2 = NEG, oe = NEG;
    const int wlag = (32 + SLACK) * w;      // this warp's first step
    const int lag = wlag + lane;             // j = T - lag
    W* tbw = tb + ((size_t)pair * tiles + tile) * steps * 32 + lane;
    const int total = steps + (32 + SLACK) * (nw - 1);
    // per row of the strip, its best H (> 0) and the first column of it;
    // rows past LA start at +inf and never take a cell
    float bv[R];
    int bc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bv[r] = r < rows ? 0.0f : __int_as_float(0x7f800000);
      bc[r] = 0;
    }
    // the traceback bits of the strip's rows inside LA
    const unsigned rmask = rows >= 8 ? ~0u : (1u << (4 * rows)) - 1u;
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
      float rh1 = __shfl_up_sync(FULL, oh1, 1);
      float rh2 = __shfl_up_sync(FULL, oh2, 1);
      float re1 = __shfl_up_sync(FULL, oe, 1);
      if (lane == 0) {
        rh1 = rh2 = re1 = NEG;
        if (jin) {
          if (w > 0) {
            const float* s = rin + 3 * ((T + GROUP) & (2 * GROUP - 1));
            rh1 = s[0];
            rh2 = s[1];
            re1 = s[2];
          } else if (sc_in) {
            rh1 = sc[3 * j];
            rh2 = sc[3 * j + 1];
            re1 = sc[3 * j + 2];
          }
        }
      }
      unsigned word = 0;
      if (on) {
        const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
        int cb[MAX_F];
#pragma unroll
        for (int f = 0; f < MAX_F; ++f)
          cb[f] = (int)((cw[f >> 1] >> (16 * (f & 1))) & 0xffffu);
        float hn[R], fn[R];
        float e_up = re1;          // E(i-1, j)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const char* tb8 = reinterpret_cast<const char*>(tab);
          float s = *reinterpret_cast<const float*>(tb8 + cb[0] + a[r][0]);
#pragma unroll
          for (int f = 1; f < MAX_F; ++f)
            if (f < nf)
              s = __fadd_rn(s, *reinterpret_cast<const float*>(
                                   tb8 + cb[f] + a[r][f]));
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
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool up = hn[r] > bv[r];
          bv[r] = up ? hn[r] : bv[r];
          bc[r] = up ? j : bc[r];
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
      }
      if (lane == 31) {
        float* s = rout + 3 * (T & (2 * GROUP - 1));
        s[0] = oh1;
        s[1] = oh2;
        s[2] = oe;
        if (sc_out && jin) {
          sc[3 * j] = oh1;
          sc[3 * j + 1] = oh2;
          sc[3 * j + 2] = oe;
        }
      }
      if (live && (unsigned)t < (unsigned)steps)
        tbw[(size_t)t * 32] = (W)(word & rmask);
      if ((T & (GROUP - 1)) == GROUP - 1 || T == total - 1) __syncthreads();
    }
    // rows in order, columns first-seen: ties go to the smaller (i, j)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const Best c{bv[r], r0 + r, bc[r]};
      if (r < rows && bv[r] > 0.0f && better(c, b)) b = c;
    }
  }

#pragma unroll
  for (int sh = 16; sh >= 1; sh >>= 1) {
    const Best o{__shfl_xor_sync(FULL, b.v, sh),
                 __shfl_xor_sync(FULL, b.i, sh),
                 __shfl_xor_sync(FULL, b.j, sh)};
    if (better(o, b)) b = o;
  }
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

template <int R, int NF>
cudaError_t launch(const uint8_t* prof, const int64_t* ia, const int64_t* ib,
                   const float* tables, int tab_floats, const Tables& tt,
                   int L, int B, int LA, int LB, float open_, float ext,
                   float* best, int* bi, int* bj, void* tb, float* scratch,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)((tab_floats + 3) & ~3) +
                      sizeof(uint16_t) * MAX_F * (size_t)LB;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sw_align_kernel<R, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (LA + 32 * R - 1) / (32 * R);
  const int warps = tiles < MAX_WARPS ? tiles : MAX_WARPS;
  sw_align_kernel<R, NF><<<B, warps * 32, smem, stream>>>(
      prof, ia, ib, tables, tab_floats, tt, L, LA, LB, open_, ext, best, bi,
      bj, static_cast<typename Word<R>::T*>(tb), scratch);
  return cudaGetLastError();
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
  if (B <= 0) return 0;
  if (F < 1 || F > MAX_F || LA < 1 || LB < 1 || LA > L || LB > L ||
      LB > MAX_LB)
    return (int)cudaErrorInvalidValue;
  Tables tt{};
  tt.nf = F;
  int off = 0;
  for (int f = 0; f < F; ++f) {
    tt.size[f] = sizes[f];
    tt.off[f] = off;
    off += (sizes[f] + 1) * (sizes[f] + 1);
  }
  if (off != tab_floats || off > 16383) return (int)cudaErrorInvalidValue;
  const uint8_t* p = static_cast<const uint8_t*>(prof);
  const int64_t* pia = static_cast<const int64_t*>(ia);
  const int64_t* pib = static_cast<const int64_t*>(ib);
  const float* tab = static_cast<const float*>(tables);
  float* pb = static_cast<float*>(best);
  int* pi = static_cast<int*>(best_i);
  int* pj = static_cast<int*>(best_j);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RESEEK_LAUNCH(R, NF)                                                \
  launch<R, NF>(p, pia, pib, tab, tab_floats, tt, L, B, LA, LB, open_, ext,  \
                pb, pi, pj, tb, sc, st)
  if (rows_per_lane == 4)
    return F == MAX_F ? RESEEK_LAUNCH(4, MAX_F) : RESEEK_LAUNCH(4, 0);
  if (rows_per_lane == 8)
    return F == MAX_F ? RESEEK_LAUNCH(8, MAX_F) : RESEEK_LAUNCH(8, 0);
#undef RESEEK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
