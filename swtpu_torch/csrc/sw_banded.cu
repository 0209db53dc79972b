// Batched fixed-band Smith-Waterman for Hopper (sm_90a): local alignment
// scores restricted to the diagonal corridor |i - j| <= W, linear or
// affine (Gotoh) gaps, uniform or general-matrix scoring, fixed or
// per-pair lengths.
//
// Replaces the fixed-band TPU kernel in its four forms:
//   <false,false>  swtpu/kernels/pallas/sw_banded.py  _kernel, uniform linear  (pallas_call :239)
//   <true, false>  same, uniform affine
//   <false,true >  same, packed-profile lookup (general matrix), linear
//   <true, true >  same, general matrix, affine
// whose entries are sw_banded_static_pallas (:295) and
// sw_banded_profile_pallas (:371).
//
// Design. One thread per pair, reading the codes as the caller holds
// them, [B, n] / [B, m] uint8 (no transposes), and the lengths as int32
// [B] (no code is overwritten with pads on the card). Row i's band holds
// columns i - W + k, k = 0..2W; rows outer, ROWS = 16 rows a sweep as a
// skewed tile in band coordinates: at step s row r computes k = k_lo + s
// - 2r, so its diagonal (k of the row above) comes from row r - 1 two
// steps earlier, its up (k + 1 of the row above) one step earlier and
// its left (k - 1) from itself: the 16 cells of a step are independent,
// where the earlier kernel chained 8 rows a column. Each row's band
// starts two steps after the row above's, one for the band's slope and
// one for the skew. A sweep runs k_lo..k_hi, the offsets at which some
// row of the sweep is inside the matrix (K = k_hi - k_lo + 1 a row); with
// K >= 30 it opens with 30 steps in which row r starts at step 2r, runs
// whole groups of four steps with every row, and closes with 30 steps in
// which row r ends at step 2r + K - 1: the rows of each step are
// compile-time ranges, so no cell is masked. Narrower sweeps (W < 15, or
// tiny matrices) run groups of every row, masked: a cell outside its
// row's range takes the dead values.
//
// Dead is 0. Out-of-band H is exactly 0 (the Pallas kernel's rule,
// sw_banded.py:22-28): an in-band cell's diagonal is in band, and an up
// or left neighbour out of band adds 0 - gap < 0, below the local floor;
// out-of-band E and F are at most -gap_open, so they never win either.
// Hence the guards: uniform scoring needs mismatch < 0 < gap, the profile
// gap > 0 (checked by the wrapper). A row at its band's last offset
// takes the dead values as its up: the row above's band has ended. Cells of the
// skewed sweep that lie outside the matrix are computed with a score <=
// 0 (OUT): left of column 1 they come out exactly as the boundary (H 0,
// E and F <= -gap_open), and right of column m and below row n no cell
// reads them and none exceeds the largest H it was computed from, so the
// best is the best over the matrix. The left-edge diagonal across sweeps
// (row i0 + 1's first diagonal is the previous sweep's last row, not a
// dead 0) comes from the hand-off below.
//
// Cells. H is kept minus the gap open, G = H - go, so a cell is DPX:
// linear H = __vimax3_s32_relu(G_diag + s + go, G_up, G_left), Gotoh
// E = __viaddmax_s32(E, -ge, G_left), F likewise from G_up and
// H = __vimax3_s32_relu(G_diag + s + go, E, F); then G = H - go (ptxas
// turns the linear cell into a max and an add-max). go is folded into
// the two score constants (uniform) or the shared table (profile).
// Uniform scores are a compare and a select: a query pad is held as -1,
// which no target byte equals, and target pads and OUT are codes no query
// code equals, so they score mismatch, which is matrix.min() whenever
// mismatch <= match (and with match < mismatch < 0 every H is 0 whatever
// the pads score). The profile reads the banded extended table
// (kernels/banded_scan.py::_banded_ext_table, pads at matrix.min()) from
// shared memory, with one more row and column for OUT, at the entry's
// address (a row's shared address plus 4 x the code: one add), a step
// ahead: row r + 1's next code is row r's code now, so its lookup leaves
// the chain of cells. (A lane table, each entry 32 times so that a warp's
// lookups never share a bank, ran no faster: 91 KB for BLOSUM62 halve
// the CTAs an SM holds.) The best is tracked over G, two rows at a time
// (__vimax3_s32), and folded from the first pair of rows' best.
//
// Lengths. Where a pad scores <= 0 (always for uniform scoring) rows past
// lq and columns past lt can only lose, so each thread runs its own
// min(lq, n) rows and min(lt, m) columns and a band no wider than its
// matrix; otherwise it runs n x m with pads past the lengths.
//
// Hand-off. Row 0 of a sweep takes the row above it (G and, Gotoh, F at
// offsets k + 1 of the previous sweep's last row) from an [2W + 1, B]
// int32 scratch ([2W + 1, B, 2] for Gotoh, one 8-byte access), a group
// ahead into a ring of four; row 15 writes its offsets into it. The
// first sweep reads none (row 0 is the boundary), the last writes none;
// a slot outside the previous row's band or left of column 1 reads dead.
// The resident threads' slots (2W + 1 words a pair) stay in L2. A CTA
// is 128 threads (CTAs of one warp for small batches, to spread 2048 long
// pairs over 64 SMs instead of 16, ran slower at 32,768 pairs and no
// faster on the 2048).
//
// Bound, by pipe: a cell needs (uniform / profile) the score 2 / 1 (+ one
// shared-memory lookup), linear H 2 (the diagonal's add, the three-way
// max), Gotoh 4 (E, F, the add, the three-way max), G's subtract 1 and
// half of a three-way max for the best. Compares, selects, maxes and DPX
// issue on the ALU pipe (64 lanes an SM a clock); the adds, the subtract
// and the profile's table offset can issue as IMADs on the FMA pipe, and
// an SM issues 128 lanes a clock in all. chip_smoke.py bounds each form by
// the larger of its ALU ops / 64 and all its ops / 128 over the in-band
// cells, and prints the instructions as compiled; the codes are 2 bytes
// per pair-residue. As compiled, a step's refills (row 0's code and row
// above, the hand-off's store) add about 2 instructions a cell and the
// moves of the unrolled group about 0.6.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;             // query rows a sweep
constexpr int GROUP = 4;             // steps a group: the prefetch distance
constexpr int OPEN = 2 * (ROWS - 1); // steps before the last row starts
constexpr int THREADS = 128;
constexpr int MAX_STRIDE = 32;
constexpr int NEG_EF = -(1 << 29);
constexpr int NEG_OUT = -(1 << 20);  // the profile's score of a cell outside the matrix
constexpr int OUT = 0xFF;            // the uniform target code outside the matrix

struct Params {
  int n, m, W;     // W <= max(n, m) (the wrapper clips it)
  int alpha;       // uniform: codes >= alpha are pads
  int hit, miss;   // uniform: match + go, mismatch + go
  int stride;      // profile: the table's stride; index `stride` is OUT
  int trim;        // pads score <= 0: each pair runs its own lengths
  int go, ge;      // linear kernels use go as the gap
};

// the registers of a sweep: row r holds query row i0 + r + 1
struct Tile {
  int qc[ROWS];   // uniform: the code, -1 for a pad; profile: its table row's shared address
  int tc[ROWS];   // the target code (profile: table column x 4) of the row's last cell
  int g[ROWS];    // G = H - go of the row's last cell
  int dg[ROWS];   // G of the diagonal of the row's next cell
  int e[ROWS];
  int f[ROWS];    // F of the row's last cell
  int rb[ROWS / 2];  // the best G of rows 2p and 2p + 1
  int sn[ROWS];   // profile: the score of the row's next cell, looked up a step ahead
};

// row 0's inputs for the steps of a group, slot s % GROUP: the target
// code and the row above (G, F); each slot refills GROUP steps ahead
struct Ring {
  int t[GROUP];
  int g[GROUP];
  int f[GROUP];
};

// what a sweep's steps share; slots and columns are kept as indices and
// turned into addresses only where they are in range
struct Sweep {
  int32_t* slot0;        // this pair's slot 0 of the hand-off (null with one sweep)
  ptrdiff_t col;         // a slot's elements
  const uint8_t* trow;   // this pair's target codes
  int rd;                // the slot of row 0's refill: offset k_lo + s + GROUP + 1
  int wr;                // the slot of row ROWS - 1's hand-off: offset k_lo + s - OPEN
  int j;                 // the refill's column
  int kmax;            // 2W - k_lo - GROUP - 1: refills of the row above past s = kmax are dead
  int K;               // steps a row
  int tK;              // steps whose row-0 code comes from the ring
  int lt, m_b;         // columns with codes, columns inside the matrix
  int pad_t, out_t;    // target codes of a pad and of a column outside
  bool first, last;
};

// a cell's score (go folded in); profile: qc + tc is the entry's shared
// address
template <bool PROFILE>
__device__ __forceinline__ int score_of(const Params& p, int qc, int tc) {
  if (PROFILE) {
    int v;
    asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(qc + tc));
    return v;
  }
  return qc == tc ? p.hit : p.miss;
}

// The cells of a step: rows LO..HI (the rest have not started or are
// done), in descending order so that each reads row r - 1's state of the
// step before; row HI + 1, which starts next step or the one after, takes
// its diagonal, and the rows below LO, which are done, still hand the
// target codes down (row r's column at step s is row 0's at step s - r).
// MASKED: rows LO..HI all compute, and a row outside its K steps takes
// the dead values.
template <bool AFFINE, bool PROFILE, bool MASKED, int LO, int HI, bool DEAD_UP = false>
__device__ __forceinline__ void cells(Tile& T, const Params& p, int s, int K,
                                      int tnew, int g_in, int f_in) {
#pragma unroll
  for (int r = ROWS - 1; r >= LO; --r) {
    if (r > HI) {
      if (r == HI + 1) T.dg[r] = T.g[r - 1];
      continue;
    }
    const int tr = r ? T.tc[r - 1] : tnew;
    // DEAD_UP: row LO is at its band's last offset, past the row above's
    const bool dead_up = DEAD_UP && r == LO;
    const int gu = dead_up ? -p.go : (r ? T.g[r - 1] : g_in);
    // profile: looked up a step ahead, off the chain of cells
    const int sg = PROFILE ? T.sn[r] : score_of<false>(p, T.qc[r], tr);
    if (PROFILE && r < ROWS - 1) T.sn[r + 1] = score_of<true>(p, T.qc[r + 1], tr);
    int h, fn = 0, en = 0;
    if (AFFINE) {
      fn = __viaddmax_s32(dead_up ? NEG_EF : (r ? T.f[r - 1] : f_in), -p.ge, gu);
      en = __viaddmax_s32(T.e[r], -p.ge, T.g[r]);
      h = __vimax3_s32_relu(T.dg[r] + sg, en, fn);
    } else {
      h = __vimax3_s32_relu(T.dg[r] + sg, gu, T.g[r]);
    }
    const int gn = h - p.go;
    const bool valid = !MASKED || static_cast<unsigned>(s - 2 * r) < static_cast<unsigned>(K);
    T.g[r] = valid ? gn : -p.go;
    if (AFFINE) {
      T.e[r] = valid ? en : NEG_EF;
      T.f[r] = valid ? fn : NEG_EF;
    }
    T.dg[r] = gu;
    T.tc[r] = tr;
  }
#pragma unroll
  for (int r = LO - 1; r >= 0; --r) T.tc[r] = r ? T.tc[r - 1] : tnew;
  if (PROFILE && LO > 0) T.sn[LO] = score_of<true>(p, T.qc[LO], T.tc[LO - 1]);
#pragma unroll
  for (int q = 0; q < ROWS / 2; ++q)
    if (2 * q + 1 >= LO && 2 * q <= HI) T.rb[q] = __vimax3_s32(T.rb[q], T.g[2 * q], T.g[2 * q + 1]);
}

// row 0's target code at column j: the code, a pad past the pair's
// length, OUT outside the matrix (profile: the table column x 4)
template <bool PROFILE>
__device__ __forceinline__ int code_at(const Sweep& w, const Params& p, int j) {
  int c = w.out_t;
  if (static_cast<unsigned>(j - 1) < static_cast<unsigned>(w.m_b)) {
    c = j <= w.lt ? __ldg(w.trow + (j - 1)) : w.pad_t;
    if (PROFILE) c = 4 * min(c, p.stride - 1);
  }
  return c;
}

// Step s (slot U = s % GROUP): row 0 (LO == 0) takes the ring's slot U,
// which refills with step s + GROUP: the code while rows still need row
// 0's codes (w.tK), the row above while row 0 runs; past LO = 0 row 0
// hands down `tlate`. Rows LO..HI compute; row ROWS - 1 (HI == ROWS - 1)
// hands its offset to the next sweep. MASKED steps do each only where
// the row runs at step s.
template <bool AFFINE, bool PROFILE, bool MASKED, int LO, int HI, int U, bool DEAD_UP = false>
__device__ __forceinline__ void step(Tile& T, Sweep& w, Ring& ring, const Params& p,
                                     int s, int tlate = 0) {
  int tn = tlate, g_in = 0, f_in = 0, sn0 = 0;
  if (LO == 0) {
    tn = ring.t[U];
    g_in = ring.g[U];
    f_in = ring.f[U];
    // profile: row 0's next score, from the code of step s + 1
    if (PROFILE) sn0 = score_of<true>(p, T.qc[0], ring.t[(U + 1) % GROUP]);
    if (s + GROUP < w.tK) ring.t[U] = code_at<PROFILE>(w, p, w.j);
    if (s + GROUP < w.K) {
      const int j = w.j;
      int gv = -p.go, fv = NEG_EF;
      if (!w.first && j >= 1 && s <= w.kmax) {
        const int32_t* at = w.slot0 + w.rd * w.col;
        if (AFFINE) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(at));
          gv = v.x;
          fv = v.y;
        } else {
          gv = __ldcg(at);
        }
      }
      ring.g[U] = gv;
      ring.f[U] = fv;
    }
  }
  cells<AFFINE, PROFILE, MASKED, LO, HI, DEAD_UP>(T, p, s, w.K, tn, g_in, f_in);
  if (PROFILE && LO == 0) T.sn[0] = sn0;
  if (HI == ROWS - 1 && !w.last &&
      (!MASKED || static_cast<unsigned>(s - OPEN) < static_cast<unsigned>(w.K))) {
    int32_t* at = w.slot0 + w.wr * w.col;
    if (AFFINE)
      __stcg(reinterpret_cast<int2*>(at), make_int2(T.g[ROWS - 1], T.f[ROWS - 1]));
    else
      __stcg(at, T.g[ROWS - 1]);
  }
  ++w.rd;
  ++w.wr;
  ++w.j;
}

// the first OPEN steps: rows 0..S / 2 (row r starts at step 2r)
template <bool AFFINE, bool PROFILE, int S>
__device__ __forceinline__ void opening(Tile& T, Sweep& w, Ring& ring, const Params& p) {
  if constexpr (S < OPEN) {
    step<AFFINE, PROFILE, false, 0, S / 2, S % GROUP>(T, w, ring, p, S);
    opening<AFFINE, PROFILE, S + 1>(T, w, ring, p);
  }
}

// the last OPEN steps, from s = K + E: rows E / 2 + 1..ROWS - 1 (row r
// ends at step 2r + K - 1); at odd E row E / 2 ended two steps ago, and
// row E / 2 + 1, at its last offset, reads past that row's band: dead up
// (writing the dead values into the ended row instead came out wrong
// under nvcc 12.8 -O3 on sm_90a). Row 0's codes for the first ROWS - 1 of
// them are `tail`.
template <bool AFFINE, bool PROFILE, int E>
__device__ __forceinline__ void closing(Tile& T, Sweep& w, Ring& ring, const Params& p,
                                        int s, const int (&tail)[ROWS - 1]) {
  if constexpr (E < OPEN) {
    int tlate = 0;
    if constexpr (E < ROWS - 1) tlate = tail[E];
    step<AFFINE, PROFILE, false, E / 2 + 1, ROWS - 1, 0, E % 2 == 1>(T, w, ring, p, s, tlate);
    closing<AFFINE, PROFILE, E + 1>(T, w, ring, p, s + 1, tail);
  }
}

// GROUP steps with every row from s0; U0 = s0 % GROUP
template <bool AFFINE, bool PROFILE, bool MASKED, int U0>
__device__ __forceinline__ void group(Tile& T, Sweep& w, Ring& ring, const Params& p,
                                      int s0) {
  step<AFFINE, PROFILE, MASKED, 0, ROWS - 1, U0>(T, w, ring, p, s0);
  step<AFFINE, PROFILE, MASKED, 0, ROWS - 1, (U0 + 1) % GROUP>(T, w, ring, p, s0 + 1);
  step<AFFINE, PROFILE, MASKED, 0, ROWS - 1, (U0 + 2) % GROUP>(T, w, ring, p, s0 + 2);
  step<AFFINE, PROFILE, MASKED, 0, ROWS - 1, (U0 + 3) % GROUP>(T, w, ring, p, s0 + 3);
}

template <bool AFFINE, bool PROFILE>
__global__ void __launch_bounds__(THREADS)
sw_banded_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int32_t* __restrict__ table, const int32_t* __restrict__ lens_q,
                 const int32_t* __restrict__ lens_t, int32_t* __restrict__ scratch,
                 int32_t* __restrict__ score, int B, Params p) {
  // profile: the extended table plus an OUT row and column, go folded in
  __shared__ int tab[PROFILE ? (MAX_STRIDE + 1) * (MAX_STRIDE + 1) : 1];
  const int s1 = p.stride + 1;
  if (PROFILE) {
    for (int x = threadIdx.x; x < s1 * s1; x += THREADS) {
      const int a = x / s1, c = x - a * s1;
      tab[x] = (a < p.stride && c < p.stride ? __ldg(table + a * p.stride + c) : NEG_OUT) + p.go;
    }
    __syncthreads();
  }
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int go = p.go;
  const int lq = min(max(lens_q ? lens_q[b] : p.n, 0), p.n);
  const int lt = min(max(lens_t ? lens_t[b] : p.m, 0), p.m);
  const int n_b = p.trim ? lq : p.n;
  const int m_b = p.trim ? lt : p.m;
  const int W = min(p.W, max(n_b, m_b));
  const int n_eff = m_b > 0 ? min(n_b, m_b + W) : 0;  // rows with a cell in the matrix
  const uint8_t* qrow = q + static_cast<size_t>(b) * p.n;
  const uint8_t* trow = t + static_cast<size_t>(b) * p.m;
  // query codes: uniform the code, -1 for a pad or a row past the matrix;
  // profile the shared address of the clamped code's table row, or OUT's
  const int tab0 = static_cast<int>(__cvta_generic_to_shared(tab));
  const int q_pad = PROFILE ? tab0 + 4 * s1 * (p.stride - 1) : -1;
  const int q_out = PROFILE ? tab0 + 4 * s1 * p.stride : -1;
  const ptrdiff_t col = static_cast<ptrdiff_t>(B) * (AFFINE ? 2 : 1);
  int32_t* slot0 = scratch ? scratch + static_cast<ptrdiff_t>(b) * (AFFINE ? 2 : 1) : nullptr;

  Sweep w;
  w.slot0 = slot0;
  w.trow = trow;
  w.col = col;
  w.lt = lt;
  w.m_b = m_b;
  w.pad_t = PROFILE ? p.stride - 1 : p.alpha + 1;  // profile: clamped by code_at
  w.out_t = PROFILE ? 4 * p.stride : OUT;
  Tile T;
#pragma unroll
  for (int x = 0; x < ROWS / 2; ++x) T.rb[x] = -go;
  Ring ring;
  for (int i0 = 0; i0 < n_eff; i0 += ROWS) {
    const int k_lo = max(0, W - i0 - (ROWS - 1));
    const int k_hi = min(2 * W, m_b + W - i0 - 1);
    const int K = k_hi - k_lo + 1;
    const int j0 = k_lo + i0 + 1 - W;  // row 0's first column
    w.K = K;
    w.first = i0 == 0;
    w.last = i0 + ROWS >= n_eff;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r + 1;
      int c;
      if (i <= lq) {
        const int code = __ldg(qrow + i - 1);
        c = PROFILE ? tab0 + 4 * s1 * min(code, p.stride - 1) : (code < p.alpha ? code : -1);
      } else {
        c = i <= n_b ? q_pad : q_out;
      }
      T.qc[r] = c;
      T.tc[r] = w.out_t;
      T.g[r] = -go;  // left of the row's first cell: dead or the boundary
      T.dg[r] = -go;
      T.e[r] = NEG_EF;
      T.f[r] = NEG_EF;
      T.sn[r] = 0;
    }
    // H[i0][j0 - 1]: the previous sweep's last row, dead left of column 1
    if (!w.first && j0 > 1) T.dg[0] = __ldcg(slot0 + k_lo * col);
    // row 0's first GROUP steps: the refill logic of steps -GROUP..-1
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int j = j0 + u;
      ring.t[u] = code_at<PROFILE>(w, p, j);
      ring.g[u] = -go;
      ring.f[u] = NEG_EF;
      if (!w.first && j >= 1 && u <= 2 * W - k_lo - 1 && u < K) {
        const int32_t* at = slot0 + (k_lo + 1 + u) * col;
        if (AFFINE) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(at));
          ring.g[u] = v.x;
          ring.f[u] = v.y;
        } else {
          ring.g[u] = __ldcg(at);
        }
      }
    }
    if (PROFILE) T.sn[0] = score_of<true>(p, T.qc[0], ring.t[0]);
    w.j = j0 + GROUP;
    w.kmax = 2 * W - k_lo - GROUP - 1;
    w.rd = k_lo + GROUP + 1;
    w.wr = k_lo - OPEN;

    if (K >= OPEN) {
      w.tK = K;
      opening<AFFINE, PROFILE, 0>(T, w, ring, p);
      int s0 = OPEN;  // s0 % GROUP == 2
      for (; s0 + GROUP <= K; s0 += GROUP)
        group<AFFINE, PROFILE, false, OPEN % GROUP>(T, w, ring, p, s0);
      const int rest = K - s0;
      if (rest > 0) step<AFFINE, PROFILE, false, 0, ROWS - 1, 2>(T, w, ring, p, s0);
      if (rest > 1) step<AFFINE, PROFILE, false, 0, ROWS - 1, 3>(T, w, ring, p, s0 + 1);
      if (rest > 2) step<AFFINE, PROFILE, false, 0, ROWS - 1, 0>(T, w, ring, p, s0 + 2);
      int tail[ROWS - 1];
#pragma unroll
      for (int x = 0; x < ROWS - 1; ++x)
        tail[x] = code_at<PROFILE>(w, p, j0 + K + x);
      closing<AFFINE, PROFILE, 0>(T, w, ring, p, K, tail);
    } else {
      w.tK = K + ROWS - 1;
      for (int s0 = 0; s0 < K + OPEN; s0 += GROUP)
        group<AFFINE, PROFILE, true, 0>(T, w, ring, p, s0);
    }
  }
  // the fold starts from the first pair of rows' best: started from -go
  // it came out wrong under -O3 on sm_90a (nvcc 12.8; right under -G)
  int best = T.rb[0];
#pragma unroll
  for (int x = 1; x < ROWS / 2; ++x) best = max(best, T.rb[x]);
  score[b] = best + go;
}

template <bool AFFINE, bool PROFILE>
void launch(const void* q, const void* t, const void* table, const void* lens_q,
            const void* lens_t, void* scratch, void* score, int B, const Params& p,
            cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  sw_banded_kernel<AFFINE, PROFILE><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens_q),
      static_cast<const int32_t*>(lens_t), static_cast<int32_t*>(scratch),
      static_cast<int32_t*>(score), B, p);
}

}  // namespace

extern "C" {

// The query rows a sweep and the scratch slots a pair needs for half-width W.
int swtpu_sw_banded_rows() { return ROWS; }
int swtpu_sw_banded_slots(int W) { return 2 * W + 1; }

// Launches one of the four instantiations on `stream` and returns
// cudaGetLastError() (a refused launch never runs, and a later synchronise
// would not report it); cudaErrorInvalidValue for W < 0 or W > max(n, m),
// a table stride outside 2..32, or a missing scratch past one sweep.
// Pointers: q [B, n] uint8, t [B, m] uint8, table [stride, stride] int32
// (profile only, else null), lens_q / lens_t [B] int32 or null for the
// full widths, scratch [2W + 1, B] int32 ([2W + 1, B, 2] affine; null
// when n <= 16), score [B] int32. All on one device, all contiguous; the
// wrapper checks that. `pad_score` is matrix.min(); linear kernels use
// gap_open as the gap.
int swtpu_sw_banded(int affine, const void* q, const void* t, const void* table,
                    const void* lens_q, const void* lens_t, void* scratch, void* score,
                    int B, int n, int m, int W, int alpha, int match, int mismatch,
                    int pad_score, int stride, int gap_open, int gap_extend, void* stream) {
  const bool profile = table != nullptr;
  if (W < 0 || W > (n > m ? n : m) || (profile && (stride < 2 || stride > MAX_STRIDE)) ||
      (n > ROWS && m > 0 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const Params p{n, m, W, alpha, match + gap_open, mismatch + gap_open,
                 profile ? stride : 1, pad_score <= 0, gap_open, gap_extend};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine) {
    if (profile) launch<true, true>(q, t, table, lens_q, lens_t, scratch, score, B, p, s);
    else launch<true, false>(q, t, table, lens_q, lens_t, scratch, score, B, p, s);
  } else {
    if (profile) launch<false, true>(q, t, table, lens_q, lens_t, scratch, score, B, p, s);
    else launch<false, false>(q, t, table, lens_q, lens_t, scratch, score, B, p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
