// Post-alignment kernels of stage 3: the traceback walk and LDDT.
//
// Neither replaces a Pallas kernel: both replace lax.scan code of
// reseek_tpu/ops/postalign_jax.py that eager PyTorch would run as
// hundreds of tiny launches per chunk.
//
// walk_traceback (replaces postalign_jax.walk_traceback_batch): one warp
// per pair walks the traceback backward from the best cell, exactly as the
// scan does on the skewed bytes: the same clamped reads (a read at (i, j)
// goes to skewed location (clip(i+j), clip(i)), i.e. cell (clip(i),
// clip(i+j) - clip(i)), which reads 0 outside 0 <= j < LB), the same state
// machine, the stop-without-decrement rule and done0 = best <= 0, with
// PEND (0) codes after the end.  The traceback is the packed layout of
// csrc/sw_align.cu (4 bits a cell; rows in strips of R per lane, tiles of
// 32 R rows, LB + 31 steps a tile; cell (i, j) of strip k at step j + k).
// Bound on the H100: a chain of dependent reads, one a step (about 700
// at 512 x 512): the latency of a step sets the time, not the bytes.
// The old design, a thread a pair reading device memory, paid an L2
// round trip and the full index arithmetic of the clamped read every step.
// Here a warp walks a pair.  It copies a window of the tile into shared
// memory, NS = W + 31 consecutive steps of all 32 strips (the columns
// [j0 - W + 1, j0] of every row of the tile: one contiguous span, 10 KB
// at W = 128 and R = 4), with 16-byte cp.async copies, and starts copying the
// window to its left at once, so that a path leaving a window sideways
// finds the next one in place; only a move to the tile above waits for a
// copy.  The path only moves up and left, so the step j + k never grows
// inside a tile and the cells read stay inside a window until it leaves
// it below its first step or above its tile.  In the window cell (base +
// rho, c) lies at nibble (c + (rho >> log R) - ws) 32 R + rho, so a step
// is one shared-memory load and a few integer operations: while the load
// is in flight the next cell's place is found for both outcomes (M reads
// the diagonal, D and I the cell itself), and the code picks one.  Reads
// that leave the window or would be clamped take the exact clamped read.
// Every lane runs the same walk on the same values (the window reads are
// broadcasts), so the branches stay uniform and the whole warp is at hand
// for the copies; the code of step t waits in lane t mod 32, and each
// group of 32 goes out as one 32-byte store, the PEND tail from all lanes.
// Pairs are independent, a block each.

// lddt (replaces postalign_jax.lddt_batch, LDDT_mu_fast of src/lddt.cpp):
// each unordered pair of aligned columns once.  Bound on the H100: the
// distance work, n(n-1)/2 pairs of ~24 float ops from coordinates staged
// in shared memory; a column a thread would evaluate every pair from both
// ends, and a block a pair would leave most SMs idle on chunks of a few
// pairs.  The triangle of column
// pairs is cut into 32 x 32 tiles (diagonal tiles keep their upper half);
// a warp takes a tile, lane l its row c, and at step s the column o =
// 32 J + ((l + s) mod 32), so the 32 lanes read 32 distinct columns.  A
// pair's counts (preserved in the low 16 bits, considered in the high 16,
// exact integers whatever the order) go to the lane's row total and to a
// column total that moves one lane down after each step (one shuffle), so
// after the tile lane l holds column 32 J + l's; both are added to the
// block's per-column counts with shared-memory atomics.  A pair is one
// thread-block cluster of C blocks (C = 1..8, ops/postalign.py
// lddt_cluster: more blocks when a launch has few pairs), which deal the
// tiles among their warps; the leader block adds the other blocks' counts
// through distributed shared memory, forms each column's score with
// __fdiv_rn, and one thread adds the scores left to right in float32, the
// reference's order.
// Rounding: d^2 = (dx*dx + dy*dy) + dz*dz with every product and sum
// rounded: -fmad stays at nvcc's default (on), but the explicit _rn
// intrinsics are never contracted into FMAs; d^2 of (c, o) and of (o, c)
// are the same bits (the differences only change sign).  IEEE sqrt and
// division (__fsqrt_rn, __fdiv_rn; built without --use_fast_math).  That is
// the plain PyTorch version's rounding; the reference contracts d^2 into
// two FMAs (reseek_tpu/fp.py), which moves a distance by at most an ulp or
// two, inside the `risky` margins (3e-5 on |d1-d2| at each threshold, 1e-3
// on d^2 at R0^2 = 225) that send a pair to the exact host recompute.
//
// lddt_long (M > 7,680 columns, whose 29 bytes a column no longer fit in
// shared memory; replaces the same scan, postalign_jax.lddt_batch): what
// bounds it on the H100 is the distance work, n(n-1)/2 column pairs a
// pair of ~24 float operations (0.0475 ms at 2 x 12,000 columns at 67
// TFLOP/s).  A cluster of at most 8 blocks a pair, as lddt_kernel runs,
// filled 16 of 132 SMs on two pairs (4.5 ms), and each step of its 32 x 32
// tiles paid 8 shuffles for ~24 float operations.  So the triangle of
// column pairs of every pair of the launch is cut into tiles of 128 rows x
// 128 columns (diagonal tiles keep the pairs with row < column), dealt to
// warps by an atomic ticket over as many blocks as fill the card
// (ops/postalign.py lddt_long_blocks: a few blocks an SM at any B).  A warp
// stages its tile's 128 columns (coordinates and flag, 32 bytes each) in
// shared memory once; lane l holds 4 row columns in registers and at step
// s takes column s by a broadcast read, so one read of a column serves 4
// column pairs and no step shuffles an operand.  Most pairs lie further
// than 15 A apart in both structures: the roots, the thresholds and the
// column total run only where a lane of the warp considers a pair (a warp
// vote), the total by one __reduce_add_sync, kept by lane s mod 32.  Row
// and column totals (preserved in the low 16 bits, considered in the
// high 16, exact integers whatever the order) go to a device-memory
// scratch of 64-bit words, pres in the low and cons in the high 32 bits,
// with one 64-bit atomic a column a tile; the risky flag by atomicOr.  A
// second small launch, a block a pair, forms the scores 2,048 columns at
// a time in shared memory, and one thread adds them left to right, in the
// order of lddt_kernel (columns past the last valid one score 0, and
// adding 0.0 leaves the sum's bits as they are), so both give the same
// bits.  2 x 12,000 columns: 0.39 ms on 528 blocks (11.5x the cluster
// kernel in the same call, 12% of the bound; chip_smoke.py --long,
// NVIDIA H100 80GB HBM3, 700 W), the second launch's one-thread sum of
// ~12,000 dependent adds a pair included (not timed apart).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LDDT_WARPS = 8;
constexpr int WALK_W = 128;   // columns of a walk window (32-256 timed alike)
constexpr unsigned FULL = 0xffffffffu;
constexpr float R0_SQ = 225.0f;
constexpr int LONG_SUM_COLS = 2048;   // lddt_long: scores staged a round
constexpr int LONG_ROWS = 4;          // lddt_long: row columns a lane
constexpr int LONG_TILE = 32 * LONG_ROWS;   // lddt_long: tile edge

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// c ? a : b as a select that stays one: the walk computes both values
// while a read is in flight, and a branch would defer them behind it
__device__ __forceinline__ int pick(bool c, int a, int b) {
  int r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %1, 0;\n"
      " selp.b32 %0, %2, %3, p;\n}"
      : "=r"(r)
      : "r"((int)c), "r"(a), "r"(b));
  return r;
}

template <int R>
__global__ void __launch_bounds__(32)
walk_kernel(const uint8_t* __restrict__ tb, const float* __restrict__ best,
            const int* __restrict__ best_i, const int* __restrict__ best_j,
            int* __restrict__ lo_a, int* __restrict__ lo_b,
            int* __restrict__ plen, uint8_t* __restrict__ path_rev, int LA,
            int LB, int Dp, int NS) {
  // R (rows a lane) and the 32 lanes of a tile are powers of two: a cell's
  // place is shifts and masks
  constexpr int LOG_R = R == 4 ? 2 : 3;
  constexpr int HALF = R / 2;          // bytes of a word
  constexpr int TR = 32 * R;           // rows of a tile; nibbles of a step
  extern __shared__ __align__(16) uint8_t wins[];   // two windows
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const int steps = Dp + 1;
  const int tiles = (LA + TR - 1) / TR;
  const int tile_steps = LB + 31;
  const size_t tile_bytes = (size_t)tile_steps * 32 * HALF;
  const uint8_t* ptb = tb + (size_t)p * tiles * tile_bytes;
  uint8_t* out = path_rev + (size_t)p * steps;
  // the window walked: bytes [cur, cur + half) of wins hold steps [ws, ws
  // + NS) of the tile whose first row is base, cell (base + rho, c) at
  // nibble (c + (rho >> LOG_R) - ws) TR + rho; the other half holds the
  // window to its left, in flight (nbase -1: none)
  const int half = NS * 32 * HALF;
  int cur = 0;
  int base = 0, ws = 1 << 20;
  int nbase = -1, nws = 0;

  // copy steps [s0, s0 + NS) of tile rows b0.. to wins + buf, asynchronously
  auto fetch = [&](int buf, int b0, int s0) {
    const int n = min(NS, tile_steps - s0) * 32 * HALF;   // 64 B a step
    const uint8_t* src =
        ptb + (size_t)(b0 / TR) * tile_bytes + (size_t)s0 * 32 * HALF;
    for (int o = 16 * lane; o < n; o += 16 * 32)
      copy16(wins + buf + o, src + o);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // make the window hold step s of the tile at row b0 (the one in flight
  // if it does), then start copying the window to its left
  auto move_to = [&](int b0, int s) {
    __syncwarp();
    if (b0 == nbase && s >= nws && s < nws + NS) {
      cur = half - cur;
      ws = nws;
    } else {
      ws = max(s - NS + 1, 0);
      fetch(cur, b0, ws);
    }
    base = b0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    nbase = -1;
    if (ws > 0) {
      nbase = base;
      nws = max(ws - NS, 0);
      fetch(half - cur, base, nws);
    }
  };
  // the code of skewed location (clip(i+j), clip(i)), exactly as the scan
  // reads it, through the window
  auto read = [&](int i, int j) -> int {
    const int d = min(max(i + j, 0), Dp - 1);
    const int ic = min(max(i, 0), LA - 1);
    const int jc = d - ic;
    if (jc < 0 || jc >= LB) return 0;
    const int rho = ic & (TR - 1);
    const int s = jc + (rho >> LOG_R);
    if (ic - rho != base || s < ws || s >= ws + NS) move_to(ic - rho, s);
    const int nib = (s - ws) * TR + rho;
    return (wins[cur + (nib >> 1)] >> ((nib & 1) << 2)) & 15;
  };
  // cell (i, j)'s byte in wins and nibble shift, and whether it lies in
  // the window and is read unclamped (i, j >= 0: i <= LA-1 and j <= LB-1
  // hold, as the walk never moves down or right)
  struct Place {
    int at, sh, in;
  };
  auto locate = [&](int i, int j) -> Place {
    const int rho = i - base;
    const int s = j + (rho >> LOG_R);
    const int nib = (s - ws) * TR + rho;
    return {cur + (nib >> 1), (nib & 1) << 2, rho >= 0 && j >= 0 && s >= ws};
  };

  int i = best_i[p] + 1;
  int j = best_j[p] + 1;
  int st = 0;                    // 0 = M, 1 = D, 2 = I
  int t = 0;
  uint8_t mine = 0;              // the code of step (t & ~31) + lane
  if (best[p] > 0.0f) {          // else done0: no step
    // the cell the next step reads: (i-1, j-1) in M, (i, j) in D and I
    Place q = locate(i - 1, j - 1);
    bool going = true;
    while (going && t < steps) {
      // the steps whose cells lie in the window, to the end of t's group
      // of 32: a shared-memory load, and while it is in flight the place
      // of the next cell for either outcome (M reads the diagonal, D and I
      // the cell itself); the code picks one, with no branch
      const int tg = min((t | 31) + 1, steps);
      while (q.in && t < tg && going) {
        const int i2 = i - (st != 2);
        const int j2 = j - (st != 1);
        const Place qm = locate(i2 - 1, j2 - 1);
        const Place qp = locate(i2, j2);
        const int code = wins[q.at] >> q.sh;   // bits above 3 unused
        // M: src (bits 0-1) in M; D, I: the bit that ends the gap
        const bool hit = (code & (st == 0 ? 3 : 2 << st)) != 0;
        const bool m = hit != (st == 0);         // the next state is M
        const int nst = st == 0 ? (code & 3) : (hit ? 0 : st);
        if ((t & 31) == lane) mine = (uint8_t)(st + 1);   // PM, PD, PI
        ++t;
        going = nst != 3;        // local start: stop without decrement
        q.at = pick(m, qm.at, qp.at);
        q.sh = pick(m, qm.sh, qp.sh);
        q.in = pick(m, qm.in, qp.in);
        i = pick(going, i2, i);
        j = pick(going, j2, j);
        st = pick(going, nst, st);
      }
      if (going && t < tg) {     // outside the window, or a clamped read
        const int code = st == 0 ? read(i - 1, j - 1) : read(i, j);
        const int nst =
            st == 0 ? (code & 3) : (((code >> (st + 1)) & 1) ? 0 : st);
        if ((t & 31) == lane) mine = (uint8_t)(st + 1);
        ++t;
        going = nst != 3;
        if (going) {
          i -= st != 2;
          j -= st != 1;
          st = nst;
          q = st == 0 ? locate(i - 1, j - 1) : locate(i, j);
        }
      }
      if ((t & 31) == 0) out[t - 32 + lane] = mine;   // a whole group
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the last group's codes, then PEND
  for (int q = (t & ~31) + lane; q < steps; q += 32)
    out[q] = q < t ? mine : 0;
  if (lane == 0) {
    lo_a[p] = i - 1;
    lo_b[p] = j - 1;
    plen[p] = t;                 // a code a step
  }
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

__global__ void __launch_bounds__(LDDT_WARPS * 32)
lddt_kernel(const float* __restrict__ cq, const float* __restrict__ ct,
            const uint8_t* __restrict__ valid, const int* __restrict__ ncols,
            float* __restrict__ out, uint8_t* __restrict__ risky, int M,
            int with_risky) {
  extern __shared__ __align__(16) float smem[];
  float* q = smem;                 // [3][M]: x, y, z
  float* t = q + 3 * M;            // [3][M]
  // per-column counts (pres | cons << 16); the leader's become its scores
  int* cnt = reinterpret_cast<int*>(t + 3 * M);
  uint8_t* v = reinterpret_cast<uint8_t*>(cnt + M);   // [M]
  __shared__ int n_cols, any_flag;

  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / nblk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const float* pq = cq + (size_t)pair * M * 3;
  const float* pt = ct + (size_t)pair * M * 3;
  const uint8_t* pv = valid + (size_t)pair * M;
  if (tid == 0) n_cols = 0;
  for (int k = tid; k < 3 * M; k += blockDim.x) {
    const int c = k / 3, d = k - 3 * c;
    q[d * M + c] = pq[k];
    t[d * M + c] = pt[k];
  }
  __syncthreads();
  int last = 0;
  for (int c = tid; c < M; c += blockDim.x) {
    v[c] = pv[c];
    cnt[c] = 0;
    if (pv[c]) last = c + 1;
  }
  atomicMax(&n_cols, last);
  __syncthreads();
  // columns past the last valid one score 0 and add nothing to the sum
  const int n = n_cols;
  const int nt = (n + 31) / 32;
  const int tiles = nt * (nt + 1) / 2;

  int flag = 0;
  for (int k = rank * LDDT_WARPS + w; k < tiles; k += nblk * LDDT_WARPS) {
    // tile k -> (I, J), I <= J: J(J+1)/2 <= k < (J+1)(J+2)/2
    int J = (int)((sqrtf(8.0f * (float)k + 1.0f) - 1.0f) * 0.5f);
    while (J * (J + 1) / 2 > k) --J;
    while ((J + 1) * (J + 2) / 2 <= k) ++J;
    const int I = k - J * (J + 1) / 2;
    const bool diag = I == J;
    const int c = 32 * I + lane;
    const bool rv = c < n && v[c];
    float qx = 0.0f, qy = 0.0f, qz = 0.0f, tx = 0.0f, ty = 0.0f, tz = 0.0f;
    if (rv) {
      qx = q[c]; qy = q[M + c]; qz = q[2 * M + c];
      tx = t[c]; ty = t[M + c]; tz = t[2 * M + c];
    }
    // a diagonal tile's pairs {l, l+s mod 32} once each: s = 1..16, s = 16
    // on the lower half-warp only
    const int s0 = diag ? 1 : 0;
    const int s1 = diag ? 17 : 32;
    int racc = 0, cacc = 0;
    for (int s = s0; s < s1; ++s) {
      const int o = 32 * J + ((lane + s) & 31);
      if (rv && o < n && v[o] && (s < 16 || lane < 16 || !diag)) {
        const float a1 = dist2(qx, qy, qz, q[o], q[M + o], q[2 * M + o]);
        const float a2 = dist2(tx, ty, tz, t[o], t[M + o], t[2 * M + o]);
        if (with_risky && (near(a1, R0_SQ, 1e-3f) || near(a2, R0_SQ, 1e-3f)))
          flag = 1;
        if (!(a1 > R0_SQ && a2 > R0_SQ)) {
          const float dd = fabsf(__fsub_rn(__fsqrt_rn(a1), __fsqrt_rn(a2)));
          const int inc = (dd <= 0.5f) + (dd <= 1.0f) + (dd <= 2.0f) +
                          (dd <= 4.0f) + (4 << 16);
          racc += inc;
          cacc += inc;
          if (with_risky &&
              (near(dd, 0.5f, 3e-5f) || near(dd, 1.0f, 3e-5f) ||
               near(dd, 2.0f, 3e-5f) || near(dd, 4.0f, 3e-5f)))
            flag = 1;
        }
      }
      // lane l holds column (l + s + 1) mod 32's total next
      cacc = __shfl_sync(FULL, cacc, (lane + 1) & 31);
    }
    // after the last step lane l holds column (l + s1) mod 32's total
    if (diag) cacc = __shfl_sync(FULL, cacc, (lane - s1) & 31);
    if (racc) atomicAdd(&cnt[c], racc);
    if (cacc) atomicAdd(&cnt[32 * J + lane], cacc);
  }
  const int f = __syncthreads_or(flag);
  if (tid == 0) any_flag = f;
  // every block's counts are final
  cluster.sync();
  if (rank == 0) {
    for (int c = tid; c < n; c += blockDim.x) {
      int tot = cnt[c];
      for (int r = 1; r < nblk; ++r) tot += cluster.map_shared_rank(cnt, r)[c];
      const int pres = tot & 0xffff, cons = tot >> 16;
      reinterpret_cast<float*>(cnt)[c] =
          cons > 0 ? __fdiv_rn((float)pres, (float)cons) : 0.0f;
    }
    if (tid == 0)
      for (int r = 1; r < nblk; ++r)
        any_flag |= *cluster.map_shared_rank(&any_flag, r);
  }
  // the leader has read the other blocks' shared memory
  cluster.sync();
  if (rank == 0 && tid == 0) {
    const float* score = reinterpret_cast<const float*>(cnt);
    float total = 0.0f;
#pragma unroll 8
    for (int c = 0; c < n; ++c) total = __fadd_rn(total, score[c]);
    out[pair] = __fdiv_rn(total, (float)max(ncols[pair], 1));
    if (with_risky) risky[pair] = (uint8_t)(any_flag != 0);
  }
}

// the row and column totals of a tile ((pres | cons << 16), at most 4 x
// 32 each) as one 64-bit word: pres low, cons high
__device__ __forceinline__ unsigned long long widen(int x) {
  return (unsigned long long)(x & 0xffff) |
         ((unsigned long long)((unsigned)x >> 16) << 32);
}

// The tiles of the launch's B pairs, LONG_TILE x LONG_TILE column pairs
// each (tile t of a pair -> (I, J), I <= J, as lddt_kernel's), taken by
// warps from a ticket.  cnt [B, M] uint64 zeroed (the per-column counts);
// work [1 + B] int64 zeroed: the ticket, then each pair's risky flag.
template <bool RISKY>
__global__ void __launch_bounds__(LDDT_WARPS * 32)
lddt_long_kernel(const float* __restrict__ cq, const float* __restrict__ ct,
                 const uint8_t* __restrict__ valid, unsigned long long* cnt,
                 unsigned long long* work, int B, int M) {
  // a warp's staged columns: (qx, qy, qz, tx), (ty, tz, valid, 0)
  __shared__ float4 stage[LDDT_WARPS][LONG_TILE][2];
  const int lane = threadIdx.x & 31;
  float4(*st)[2] = stage[threadIdx.x >> 5];
  const long long nt = (M + LONG_TILE - 1) / LONG_TILE;
  const long long tp = nt * (nt + 1) / 2;           // tiles a pair
  const unsigned long long total = (unsigned long long)tp * B;
  for (;;) {
    unsigned long long k = 0;
    if (lane == 0) k = atomicAdd(work, 1ull);
    k = __shfl_sync(FULL, k, 0);
    if (k >= total) break;
    const int pair = (int)(k / tp);
    const long long t = (long long)(k - (unsigned long long)pair * tp);
    long long J = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while (J * (J + 1) / 2 > t) --J;
    while ((J + 1) * (J + 2) / 2 <= t) ++J;
    const int I = (int)(t - J * (J + 1) / 2);
    const bool diag = I == J;
    const uint8_t* pv = valid + (size_t)pair * M;
    const float* pq = cq + (size_t)pair * M * 3;
    const float* pt = ct + (size_t)pair * M * 3;
    const int c0 = LONG_TILE * I + LONG_ROWS * lane;   // this lane's rows
    const int o0 = LONG_TILE * (int)J;                 // the tile's columns
    // bit r: row c0 + r valid; bit q: column o0 + 32 q + lane valid
    unsigned rv = 0, ov = 0;
#pragma unroll
    for (int r = 0; r < LONG_ROWS; ++r)
      if (c0 + r < M && pv[c0 + r]) rv |= 1u << r;
#pragma unroll
    for (int q = 0; q < LONG_ROWS; ++q)
      if (o0 + 32 * q + lane < M && pv[o0 + 32 * q + lane]) ov |= 1u << q;
    // a tile with no valid row or no valid column counts nothing
    if (!__any_sync(FULL, rv != 0) || !__any_sync(FULL, ov != 0)) continue;
    __syncwarp();   // the last tile's reads of st are done
#pragma unroll
    for (int q = 0; q < LONG_ROWS; ++q) {
      const int o = o0 + 32 * q + lane;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y = x;
      if ((ov >> q) & 1) {
        x = make_float4(pq[3 * (size_t)o], pq[3 * (size_t)o + 1],
                        pq[3 * (size_t)o + 2], pt[3 * (size_t)o]);
        y = make_float4(pt[3 * (size_t)o + 1], pt[3 * (size_t)o + 2], 1.0f,
                        0.0f);
      }
      st[32 * q + lane][0] = x;
      st[32 * q + lane][1] = y;
    }
    float rx[LONG_ROWS], ry[LONG_ROWS], rz[LONG_ROWS];
    float ux[LONG_ROWS], uy[LONG_ROWS], uz[LONG_ROWS];
#pragma unroll
    for (int r = 0; r < LONG_ROWS; ++r) {
      const bool in = (rv >> r) & 1;
      const size_t c = 3 * (size_t)(c0 + r);
      rx[r] = in ? pq[c] : 0.0f;
      ry[r] = in ? pq[c + 1] : 0.0f;
      rz[r] = in ? pq[c + 2] : 0.0f;
      ux[r] = in ? pt[c] : 0.0f;
      uy[r] = in ? pt[c + 1] : 0.0f;
      uz[r] = in ? pt[c + 2] : 0.0f;
    }
    __syncwarp();   // st written
    int racc[LONG_ROWS] = {};
    int cacc[LONG_ROWS] = {};   // slot q: column o0 + 32 q + lane's total
    int flag = 0;
#pragma unroll
    for (int q = 0; q < LONG_ROWS; ++q) {
      for (int s2 = 0; s2 < 32; ++s2) {
        const int s = 32 * q + s2;
        const float4 x = st[s][0], y = st[s][1];   // broadcasts
        if (y.z == 0.0f) continue;                  // the same in every lane
        float a1[LONG_ROWS], a2[LONG_ROWS];
        bool cons[LONG_ROWS];
        bool any = false;
#pragma unroll
        for (int r = 0; r < LONG_ROWS; ++r) {
          // row c0 + r against column o0 + s: once (row < column on a
          // diagonal tile), both valid
          const bool pv_r =
              ((rv >> r) & 1) && (!diag || LONG_ROWS * lane + r < s);
          a1[r] = dist2(rx[r], ry[r], rz[r], x.x, x.y, x.z);
          a2[r] = dist2(ux[r], uy[r], uz[r], x.w, y.x, y.y);
          if (RISKY && pv_r &&
              (near(a1[r], R0_SQ, 1e-3f) || near(a2[r], R0_SQ, 1e-3f)))
            flag = 1;
          cons[r] = pv_r && !(a1[r] > R0_SQ && a2[r] > R0_SQ);
          any |= cons[r];
        }
        if (!__any_sync(FULL, any)) continue;
        int sum = 0;
#pragma unroll
        for (int r = 0; r < LONG_ROWS; ++r) {
          if (!cons[r]) continue;
          const float dd =
              fabsf(__fsub_rn(__fsqrt_rn(a1[r]), __fsqrt_rn(a2[r])));
          const int inc = (dd <= 0.5f) + (dd <= 1.0f) + (dd <= 2.0f) +
                          (dd <= 4.0f) + (4 << 16);
          racc[r] += inc;
          sum += inc;
          if (RISKY &&
              (near(dd, 0.5f, 3e-5f) || near(dd, 1.0f, 3e-5f) ||
               near(dd, 2.0f, 3e-5f) || near(dd, 4.0f, 3e-5f)))
            flag = 1;
        }
        const int tot = (int)__reduce_add_sync(FULL, (unsigned)sum);
        if (lane == s2) cacc[q] = tot;
      }
    }
    unsigned long long* pc = cnt + (size_t)pair * M;
#pragma unroll
    for (int r = 0; r < LONG_ROWS; ++r)
      if (racc[r]) atomicAdd(&pc[c0 + r], widen(racc[r]));
#pragma unroll
    for (int q = 0; q < LONG_ROWS; ++q)
      if (cacc[q]) atomicAdd(&pc[o0 + 32 * q + lane], widen(cacc[q]));
    if (RISKY && __any_sync(FULL, flag) && lane == 0)
      atomicOr(work + 1 + pair, 1ull);
  }
}

// A block a pair: the scores from the counts of lddt_long_kernel, added
// left to right over the M columns; out, risky as lddt_kernel's.
__global__ void __launch_bounds__(LDDT_WARPS * 32)
lddt_finish_kernel(const unsigned long long* __restrict__ cnt,
                   const unsigned long long* __restrict__ work,
                   const int* __restrict__ ncols, float* __restrict__ out,
                   uint8_t* __restrict__ risky, int M, int with_risky) {
  __shared__ float part[LONG_SUM_COLS];
  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned long long* pc = cnt + (size_t)pair * M;
  float total = 0.0f;
  for (int c0 = 0; c0 < M; c0 += LONG_SUM_COLS) {
    const int c1 = min(M, c0 + LONG_SUM_COLS);
    for (int c = c0 + tid; c < c1; c += blockDim.x) {
      const unsigned long long tot = pc[c];
      const int pres = (int)(tot & 0xffffffffu), cons = (int)(tot >> 32);
      part[c - c0] = cons > 0 ? __fdiv_rn((float)pres, (float)cons) : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll 8
      for (int c = c0; c < c1; ++c) total = __fadd_rn(total, part[c - c0]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[pair] = __fdiv_rn(total, (float)max(ncols[pair], 1));
    if (with_risky) risky[pair] = (uint8_t)(work[1 + pair] != 0);
  }
}

// a cluster launch of B x cluster blocks of LDDT_WARPS warps
template <typename... Params, typename... Args>
cudaError_t launch_lddt(void (*kernel)(Params...), int B, int cluster,
                        size_t smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)cluster);
  cfg.blockDim = dim3(LDDT_WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tb: csrc/sw_align.cu's packed traceback of a [LA, LB] shape with R rows
// a lane, 16-byte aligned; best [B] float32, best_i/best_j [B] int32;
// lo_a/lo_b/plen [B] int32, path_rev [B, Dp+1] uint8 (Dp >= LA+LB-1).
int walk_traceback(const void* tb, const void* best, const void* best_i,
                   const void* best_j, void* lo_a, void* lo_b, void* plen,
                   void* path_rev, int B, int LA, int LB, int Dp, int R,
                   void* stream) {
  if (B <= 0) return 0;
  if (Dp < LA + LB - 1 || (R != 4 && R != 8) ||
      reinterpret_cast<uintptr_t>(tb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int ns = WALK_W + 31;
  // two windows: 40,704 bytes at R = 8
  const size_t smem = 2 * (size_t)ns * 32 * (R / 2);
  auto kernel = R == 4 ? walk_kernel<4> : walk_kernel<8>;
  kernel<<<B, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tb), static_cast<const float*>(best),
      static_cast<const int*>(best_i), static_cast<const int*>(best_j),
      static_cast<int*>(lo_a), static_cast<int*>(lo_b),
      static_cast<int*>(plen), static_cast<uint8_t*>(path_rev), LA, LB, Dp,
      ns);
  return cudaGetLastError();
}

// cq, ct [B, M, 3] float32, valid [B, M] bool (one byte), ncols [B] int32;
// out [B] float32, risky [B] bool (written only when with_risky != 0);
// cluster: blocks per pair, 1 to 8.  M <= 7680 (shared memory).
int lddt(const void* cq, const void* ct, const void* valid, const void* ncols,
         void* out, void* risky, int B, int M, int with_risky, int cluster,
         void* stream) {
  if (B <= 0) return 0;
  if (cluster < 1 || cluster > 8 || M < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (sizeof(float) * 6 + sizeof(int)) * (size_t)M + M;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lddt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return launch_lddt(lddt_kernel, B, cluster, smem, stream,
                     static_cast<const float*>(cq),
                     static_cast<const float*>(ct),
                     static_cast<const uint8_t*>(valid),
                     static_cast<const int*>(ncols), static_cast<float*>(out),
                     static_cast<uint8_t*>(risky), M, with_risky);
}

// lddt for M > 7680 (any M with 0 < M <= 2^20): cnt [B, M] uint64 and
// work [1 + B] int64, both zeroed (the per-column counts; the ticket and
// the risky flags); blocks: the first launch's blocks of LDDT_WARPS warps
// (ops/postalign.py lddt_long_blocks); the other arguments as lddt's.
int lddt_long(const void* cq, const void* ct, const void* valid,
              const void* ncols, void* out, void* risky, void* cnt,
              void* work, int B, int M, int with_risky, int blocks,
              void* stream) {
  if (B <= 0) return 0;
  if (blocks < 1 || M < 1 || M > (1 << 20) || cnt == nullptr ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = with_risky ? lddt_long_kernel<true> : lddt_long_kernel<false>;
  unsigned long long* pc = static_cast<unsigned long long*>(cnt);
  unsigned long long* pw = static_cast<unsigned long long*>(work);
  kernel<<<blocks, LDDT_WARPS * 32, 0, st>>>(
      static_cast<const float*>(cq), static_cast<const float*>(ct),
      static_cast<const uint8_t*>(valid), pc, pw, B, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lddt_finish_kernel<<<B, LDDT_WARPS * 32, 0, st>>>(
      pc, pw, static_cast<const int*>(ncols), static_cast<float*>(out),
      static_cast<uint8_t*>(risky), M, with_risky);
  return cudaGetLastError();
}

}  // extern "C"
