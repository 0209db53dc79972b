// Batched semi-global and global (Needleman-Wunsch) alignment for Hopper
// (sm_90a): scores and endpoints, linear or affine (Gotoh) gaps, uniform
// scoring or a general substitution matrix, fixed or per-pair lengths.
//
// Replaces the two semi-global TPU kernels, in eight forms:
//   <AFFINE, false, END>  swtpu/kernels/pallas/semiglobal_batch.py    _kernel (pallas_call :194)
//                         with its cross-column _reduce_endpoints (:215)
//   <AFFINE, true,  END>  swtpu/kernels/pallas/semiglobal_profile.py  _kernel (pallas_call :201)
// END = END_PIN reads each pair's (lq, lt) corner instead of the argmax:
// global alignment; the argmax forms have two trackers, END_KEY and, for
// score ranges its key cannot hold, END_SELECT (below). The TPU kernels
// track the argmax of fixed-length batches only, and JAX runs global and
// per-pair lengths on its XLA scan on the device; here both kernels take
// them, so the card never runs the plain tier on this path.
//
// Design. One thread per pair, reading the codes as the caller holds
// them, [B, n] / [B, m] uint8 (no transposes): a thread loads its own
// target row four codes at a time (one 32-bit load a group of four
// steps when m % 4 == 0 and the rows are 4-byte aligned, else four byte
// loads) and its query rows once a sweep. Rows outer, ROWS = 16 query
// rows a sweep in registers, as a skewed tile: at step s row r computes
// column s - r, from its own left state, the H (and F) that row r - 1
// computed at step s - 1 (its up) and at step s - 2 (its diagonal), and
// the target code row r - 1 held, shifted down a row a step. The 16 cells
// of a step are independent (16-way ILP per thread; the unskewed tile
// chained them). With m_b >= ROWS columns a sweep opens with 16 steps in
// which row s starts at step s, runs whole groups of four steps, and
// closes with 15 steps in which row r ends at step m_b + r - 1: the rows
// each step computes are compile-time ranges, so no cell outside the
// matrix is computed or masked. Shorter targets run groups of every row,
// masked where a step has a row outside [0, m_b): there a row keeps its H
// and its tracker, and E, F, the diagonal and the code take any value
// (they reach no real cell; a row's E restarts at -inf at its first
// column, so its first cell takes H[i, 0] - go whatever the sign of ge). Row 0 takes the row above the sweep (H - go and F) from the
// scratch, [m, B] int32 or, affine, [m, B, 2] (one 8-byte load a step),
// loaded a group ahead into a ring of four (the first sweep computes the
// boundary chain instead), and row ROWS - 1 writes it for the next sweep
// (the last sweep writes nothing);
// both walk the scratch with pointers that advance a column a step. H is
// kept minus the gap open (D = H - go), so the linear cell is a DPX
// add-max of the diagonal and the score against up, a max with left and
// the subtract; the Gotoh cell two __viaddmax_s32 (E, F), the diagonal's
// add-max, a max and the subtract; go is folded into the score select
// (uniform) or the table (profile). Semi-global has no 0 floor: no _relu
// form.
//
// Lengths. A pair's rows past lq and columns past lt reach no cell that
// is tracked (argmax) or pinned (global), so each thread runs its own
// n_b = min(lq, n) rows and m_b = min(lt, m) columns, with no per-cell
// length test; in the last sweep rows past n_b are phantom rows (pads,
// never tracked). Scores: PROFILE = false is uniform: a code >= 4 on
// either side scores mismatch, even against an equal code (the rule of
// the XLA tier, this kernel's plain version: kernels/semiglobal_scan.py);
// the query code is held as -1 there, which no target byte equals.
// PROFILE = true looks each cell up in the plain tier's extended table
// (pads -2^20) in shared memory, as a lane table: the codes clamp to the
// alphabet + 1 (the last a pad: the launch's `codes`, 25 for BLOSUM62),
// and each entry is held 32 times, word 32 x entry + lane, so a warp's 32
// lookups hit 32 banks whatever the codes (with one table, entry q x
// stride + t, a warp's lookups on random protein take about 4 passes, a
// numpy estimate). 80 KB for BLOSUM62: two CTAs an SM.
//
// Endpoint (argmax). The first maximum in row-major order over the
// pair's real [0..lq] x [0..lt] region, H[0, 0] = 0 included. The
// tracker starts at the origin (0, 0, 0) and follows interior cells:
// every row keeps its own best and the step of its first cell at that
// best, updated on a strictly greater H while its columns ascend, and
// after each sweep the rows fold in order into the thread's (best, i, j),
// again on strictly greater; the column is the step minus the row. Row 0
// and column 0 are boundary chains, monotone in their index, so each one's
// first maximum is its first cell (ge >= 0) or its last (ge < 0); after
// the DP both merge with the interior's in row-major order (gap 0 ties
// the origin, which comes first). With gaps > 0 every boundary cell is
// negative and never wins; under a gap <= 0 they are >= 0 and can. The
// merge stays out of the sweeps: a per-row fold there, with a masked
// cell's validity test on E, took the affine key forms from 168 registers
// to 255 (two CTAs an SM, not three: ~15% slower at 1M pairs).
// Skewing changes when a
// row sees a column, not the order in which it sees its own columns. A
// phantom row starts at INT_MAX, so it never updates. END_KEY holds both
// in one int32 key (H - go) * 2^k + (2^k - 1 - s), k the bits of the
// steps a sweep: a cell is one IMAD (the step's constant is shared by
// the rows) and one max, and the larger key is the larger H or, at
// equal H, the earlier step. The launch takes it when (n + m + ROWS +
// GROUP) x the largest |score|, |go| or |ge| (a profile form's largest
// |entry|, which the wrapper passes as `match`), plus |go| + 1, fits in
// 31 - k bits, which bounds every |H - go| of the pair, phantom rows
// included (each step of a path moves H by at most that magnitude). Else
// END_SELECT keeps (best, step) apart: a compare and two selects a cell,
// all on the ALU pipe; the key's IMAD issues on the FMA pipe, and the key
// forms ran 1.20-1.31x faster than the select tracker on the same inputs
// (PERF.md). (__vibmax_s32 is no single instruction on sm_90: ptxas emits a compare
// and a select, and keeps the 16 rows' predicates in a register.)
//
// Endpoint (PIN). H[lq, lt] and (lq, lt); a corner on the boundary
// (lq = 0 or lt = 0) is its chain value, with no DP; an interior corner
// is the last H of row lq, whose columns end at lt (no per-cell work); a
// corner outside the matrix gives (-2^30, 0, 0), as the plain tier does.
//
// Guards: exact for every n, m >= 0, every B and any lengths, for gaps of
// either sign and any entries, as the plain tier is, while H stays within
// int32 (the plain tier's type). E and F start at -2^29, pads score -2^20
// + go, and D, E, F stay within the boundary chains and the matches.
//
// Bound, by pipe: a cell needs (uniform / profile) the score 2 / 1 (+ one
// shared-memory lookup), linear H 3, Gotoh 5 (E, F, the add, the 3-way
// max, D), the argmax key 2. Compares, selects, maxes and DPX add-maxes
// issue on the ALU pipe (64 lanes an SM a clock); D's subtract, the key's
// multiply-add and the profile's table offset can issue as IMADs on the
// FMA pipe beside it (64 more), and an SM issues 128 lanes a clock in
// all. chip_smoke.py bounds each form by the larger of its ALU ops / 64
// and all its ops / 128, and prints the instructions as compiled by pipe;
// the inputs are 2 bytes per pair-residue.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;   // query rows a sweep
constexpr int GROUP = 4;       // steps a group: one code word, the prefetch distance
constexpr int THREADS = 128;
constexpr int MAX_STRIDE = 32;
constexpr int NEG_EF = -(1 << 29);
constexpr int MINUS_INF = -(1 << 30);
// the endpoint a form returns
constexpr int END_KEY = 0;     // argmax, (best, step) in one key
constexpr int END_SELECT = 1;  // argmax, (best, step) apart
constexpr int END_PIN = 2;     // the (lq, lt) corner

struct Scoring {
  int match;     // uniform: two equal codes below 4
  int mismatch;  // uniform: every other cell (the negated penalty)
  int stride;    // profile: the table's row stride
  int codes;     // profile: codes in the lane table, the last a pad (<= stride)
  int go;        // linear kernels use go as the gap
  int ge;
  int kbits;     // END_KEY: the step bits of the key
  int kmul;      // and 2^kbits
};

// H on a boundary chain at distance k >= 1 from the origin
template <bool AFFINE>
__device__ __forceinline__ int chain(int k, int go, int ge) {
  return AFFINE ? -go - (k - 1) * ge : -k * go;
}

// Merges the first maximum of a boundary chain's cells k = 1..len (row 0
// when `row`, else column 0) into (best, i, j), the first maximum in
// row-major order: the chain moves by -ge a cell (linear: ge = go), so its
// first maximum is its last cell when it rises, else its first; a tie
// goes to the earlier cell in row-major order.
template <bool AFFINE>
__device__ __forceinline__ void merge_chain(int len, int go, int ge, bool row, int& best,
                                            int& bi, int& bj) {
  if (len < 1) return;
  const int k = ge < 0 ? len : 1;
  const int v = chain<AFFINE>(k, go, ge);
  const int i = row ? 0 : k, j = row ? k : 0;
  if (v > best || (v == best && (i < bi || (i == bi && j < bj)))) {
    best = v;
    bi = i;
    bj = j;
  }
}

// the registers of a sweep: row r holds query row i0 + r + 1 (an
// instantiation keeps only the arrays it uses: linear no e / f, END_PIN
// no rb, only END_SELECT rs)
struct Tile {
  int qc[ROWS];  // profile: the row's shared address in the lane table; uniform: the code, -1 past 4
  int tc[ROWS];  // the target code of the row's last column (profile: x 128)
  int d[ROWS];   // H - go of the row's last cell
  int dg[ROWS];  // H - go of the diagonal of the row's next cell
  int e[ROWS];
  int f[ROWS];   // F of the row's last cell
  int rb[ROWS];  // the row's best: its key, or H - go; INT_MAX: not tracked
  int rs[ROWS];  // END_SELECT: the step of that best, -1 before one
};

// row 0's up (H - go of the row above the sweep) and F for the steps of a
// group, slot s % GROUP; each slot refills GROUP steps ahead
struct Ring {
  int h[GROUP];
  int f[GROUP];
};

// what a sweep's steps share; the scratch is [m, B] (H - go) or, affine,
// [m, B, 2] (H - go, F), `col` elements a column
struct Sweep {
  const int32_t* rd;  // row 0's refill: column s + GROUP
  int32_t* wr;        // row ROWS - 1's hand-off: column s - ROWS + 1
  ptrdiff_t col;
  int ahead;          // first sweep: the boundary's H - go at column s + GROUP
  int m_b;
  bool first, last;   // the first sweep reads no scratch, the last writes none
  int pad, hit, miss, go, ge, kmul;
};

// a profile score: a word of the lane table at a 32-bit shared address
__device__ __forceinline__ int lane_score(unsigned addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// The cells of step s: row r computes column s - r, rows LO..HI (the rest
// have not started or are done), in descending order so that each reads
// row r - 1's state of the step before; a row HI + 1 that starts next
// step takes its diagonal (row HI's first H - go). MASKED: rows LO..HI
// all compute, and a row outside [0, m_b) keeps its H and its tracker.
template <bool AFFINE, bool PROFILE, int END, bool MASKED, int LO, int HI>
__device__ __forceinline__ void cells(Tile& T, const Sweep& w, int s, int tnew, int up_in,
                                      int f_in) {
  const int ks = w.kmul - 1 - s;  // END_KEY: the step's part of the key
#pragma unroll
  for (int r = ROWS - 1; r >= LO; --r) {
    if (r > HI) {
      if (r == HI + 1) T.dg[r] = T.d[r - 1];
      continue;
    }
    const int tr = r ? T.tc[r - 1] : tnew;
    const int up = r ? T.d[r - 1] : up_in;
    const int sg = PROFILE ? lane_score(T.qc[r] + tr) : (T.qc[r] == tr ? w.hit : w.miss);
    const bool valid =
        !MASKED || static_cast<unsigned>(s - r) < static_cast<unsigned>(w.m_b);
    int h;
    if (AFFINE) {
      const int fu = r ? T.f[r - 1] : f_in;
      const int f = __viaddmax_s32(fu, -w.ge, up);
      // a masked row's E before its first column (step r) is any value: it
      // restarts at -inf there, whatever the sign of ge
      const int ein = MASKED && s == r ? NEG_EF : T.e[r];
      const int e = __viaddmax_s32(ein, -w.ge, T.d[r]);
      h = __vimax3_s32(T.dg[r] + sg, e, f);
      T.f[r] = f;
      T.e[r] = e;
    } else {
      h = __vimax3_s32(T.dg[r] + sg, up, T.d[r]);
    }
    const int dn = h - w.go;
    T.tc[r] = tr;
    T.dg[r] = up;
    if (valid) T.d[r] = dn;
    if (END == END_KEY) {
      const int key = dn * w.kmul + ks;
      if (valid) T.rb[r] = max(T.rb[r], key);
    } else if (END == END_SELECT) {
      if (valid && dn > T.rb[r]) {
        T.rb[r] = dn;
        T.rs[r] = s;
      }
    }
  }
}

// Step s: row 0 (LO == 0) takes code byte U of cw and ring slot U, which
// refills with column s + GROUP; rows LO..HI compute; row ROWS - 1 (HI ==
// ROWS - 1) hands column s - ROWS + 1 to the next sweep.
template <bool AFFINE, bool PROFILE, int END, bool MASKED, int LO, int HI, int U>
__device__ __forceinline__ void step(Tile& T, Sweep& w, Ring& ring, int s, uint32_t cw) {
  int tn = 0, up_in = 0, f_in = 0;
  if (LO == 0) {
    tn = (cw >> (8 * U)) & 0xff;
    if (PROFILE) tn = min(tn, w.pad) * 128;  // the code's row of the lane table
    up_in = ring.h[U];
    f_in = ring.f[U];
    if (!w.first && s + GROUP < w.m_b) {
      if (AFFINE) {
        const int2 v = __ldcg(reinterpret_cast<const int2*>(w.rd));
        ring.h[U] = v.x;
        ring.f[U] = v.y;
      } else {
        ring.h[U] = __ldcg(w.rd);
      }
    }
    if (w.first) ring.h[U] = w.ahead;
    w.ahead -= AFFINE ? w.ge : w.go;
  }
  cells<AFFINE, PROFILE, END, MASKED, LO, HI>(T, w, s, tn, up_in, f_in);
  if (HI == ROWS - 1) {
    const int j = s - (ROWS - 1);
    if (!w.last && (!MASKED || (j >= 0 && j < w.m_b))) {
      if (AFFINE)
        __stcg(reinterpret_cast<int2*>(w.wr), make_int2(T.d[ROWS - 1], T.f[ROWS - 1]));
      else
        __stcg(w.wr, T.d[ROWS - 1]);
    }
  }
  w.rd += w.col;
  w.wr += w.col;
}

// four target codes from column j on (bytes past m_b are never scored)
__device__ __forceinline__ uint32_t codes4(const uint8_t* __restrict__ row, int j, int m_b,
                                           bool vec) {
  if (j >= m_b) return 0;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + j));
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < GROUP; ++k)
    if (j + k < m_b) w |= static_cast<uint32_t>(__ldg(row + j + k)) << (8 * k);
  return w;
}

// steps s0 .. s0 + GROUP - 1 with every row (MASKED: whatever their columns)
template <bool AFFINE, bool PROFILE, int END, bool MASKED>
__device__ __forceinline__ void group(Tile& T, Sweep& w, Ring& ring, int s0, uint32_t cw) {
  step<AFFINE, PROFILE, END, MASKED, 0, ROWS - 1, 0>(T, w, ring, s0, cw);
  step<AFFINE, PROFILE, END, MASKED, 0, ROWS - 1, 1>(T, w, ring, s0 + 1, cw);
  step<AFFINE, PROFILE, END, MASKED, 0, ROWS - 1, 2>(T, w, ring, s0 + 2, cw);
  step<AFFINE, PROFILE, END, MASKED, 0, ROWS - 1, 3>(T, w, ring, s0 + 3, cw);
}

// the first ROWS steps, group K: rows 0..s (row s starts at step s)
template <bool AFFINE, bool PROFILE, int END, int K>
__device__ __forceinline__ void opening(Tile& T, Sweep& w, Ring& ring, uint32_t cw) {
  step<AFFINE, PROFILE, END, false, 0, 4 * K, 0>(T, w, ring, 4 * K, cw);
  step<AFFINE, PROFILE, END, false, 0, 4 * K + 1, 1>(T, w, ring, 4 * K + 1, cw);
  step<AFFINE, PROFILE, END, false, 0, 4 * K + 2, 2>(T, w, ring, 4 * K + 2, cw);
  step<AFFINE, PROFILE, END, false, 0, 4 * K + 3, 3>(T, w, ring, 4 * K + 3, cw);
}

// the last ROWS - 1 steps, from s = m_b + E: rows E + 1..ROWS - 1 (row r
// ends at step m_b + r - 1)
template <bool AFFINE, bool PROFILE, int END, int E>
__device__ __forceinline__ void closing(Tile& T, Sweep& w, Ring& ring, int s) {
  if constexpr (E < ROWS - 1) {
    step<AFFINE, PROFILE, END, false, E + 1, ROWS - 1, 0>(T, w, ring, s, 0);
    closing<AFFINE, PROFILE, END, E + 1>(T, w, ring, s + 1);
  }
}

template <bool AFFINE, bool PROFILE, int END>
__global__ void __launch_bounds__(THREADS)
sw_semiglobal_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ lens_q,
                     const int32_t* __restrict__ lens_t, int32_t* __restrict__ scratch,
                     int32_t* __restrict__ score, int32_t* __restrict__ end_i,
                     int32_t* __restrict__ end_j, int B, int n, int m, Scoring sc,
                     bool vec) {
  // profile: the lane table, entry (q, t) of the scores (the gap open
  // folded in: H is kept minus it) 32 times, word 32 (q x codes + t) +
  // lane, so a warp's lookups never share a bank
  extern __shared__ int32_t lane_tab[];
  const int go = sc.go;
  const int ge = sc.ge;
  const int nc = sc.codes;
  if (PROFILE) {
    for (int w = threadIdx.x; w < nc * nc * 32; w += THREADS) {
      const int qi = (w >> 5) / nc, ti = (w >> 5) - qi * nc;
      lane_tab[w] = __ldg(table + qi * sc.stride + ti) + go;
    }
    __syncthreads();
  }

  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const int pad = PROFILE ? nc - 1 : 4;  // the code of a phantom row
  const int kmul = sc.kmul;
  const int lq = lens_q ? lens_q[b] : n;
  const int lt = lens_t ? lens_t[b] : m;
  const uint8_t* qrow = q + b * static_cast<size_t>(n);
  const uint8_t* trow = t + b * static_cast<size_t>(m);

  int best = 0, bi = 0, bj = 0;  // argmax: the origin
  int n_b = min(max(lq, 0), n), m_b = min(max(lt, 0), m);
  if (END == END_PIN) {
    best = MINUS_INF;
    n_b = 0;  // no DP unless the corner is interior
    if (lq >= 0 && lq <= n && lt >= 0 && lt <= m) {
      bi = lq;
      bj = lt;
      if (lq == 0)
        best = lt == 0 ? 0 : chain<AFFINE>(lt, go, ge);
      else if (lt == 0)
        best = chain<AFFINE>(lq, go, ge);
      else
        n_b = lq;
    }
  }
  const int n_col = n_b;  // column 0's cells 1..n_col (argmax, tracked when lt >= 0)
  if (m_b == 0) n_b = 0;

  // a tracked row's start: the origin's H = 0, at a key no step beats
  const int origin = END == END_KEY ? -go * kmul + (kmul - 1) : -go;
  const ptrdiff_t col = static_cast<ptrdiff_t>(B) * (AFFINE ? 2 : 1);
  Sweep w{nullptr, nullptr, col, 0, m_b, true, false, pad, sc.match + go,
          sc.mismatch + go, go, ge, kmul};
  // this lane's word of entry 0 of the lane table
  const unsigned lane0 = static_cast<unsigned>(__cvta_generic_to_shared(lane_tab)) +
                         4 * (threadIdx.x & 31);
  Tile T;
  Ring ring;
  for (int i0 = 0; i0 < n_b; i0 += ROWS) {
    w.first = i0 == 0;
    w.last = i0 + ROWS >= n_b;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r + 1;  // 1-based DP row
      const int c = i <= n_b ? qrow[i - 1] : pad;
      T.qc[r] = PROFILE ? lane0 + min(c, pad) * nc * 128 : (c < 4 ? c : -1);
      T.tc[r] = 0;
      T.d[r] = chain<AFFINE>(i, go, ge) - go;
      T.dg[r] = T.d[r];  // any value: row r > 0 takes its diagonal at step r - 1
      if (AFFINE) {
        T.e[r] = NEG_EF;
        T.f[r] = NEG_EF;
      }
      T.rb[r] = i <= n_b ? origin : INT_MAX;
      T.rs[r] = -1;
    }
    T.dg[0] = (w.first ? 0 : chain<AFFINE>(i0, go, ge)) - go;  // H[i0, 0] - go

    // row 0's up and F for columns 0..GROUP - 1: the scratch, or in the
    // first sweep the boundary chain and -inf
    const int32_t* col0 = scratch + static_cast<ptrdiff_t>(b) * (AFFINE ? 2 : 1);
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      ring.h[u] = chain<AFFINE>(u + 1, go, ge) - go;
      ring.f[u] = NEG_EF;
      if (!w.first && u < m_b) {
        if (AFFINE) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(col0 + u * col));
          ring.h[u] = v.x;
          ring.f[u] = v.y;
        } else {
          ring.h[u] = __ldcg(col0 + u * col);
        }
      }
    }
    w.ahead = chain<AFFINE>(GROUP + 1, go, ge) - go;
    if (scratch) {
      w.rd = col0 + GROUP * col;
      w.wr = scratch + (static_cast<ptrdiff_t>(b) * (AFFINE ? 2 : 1) - (ROWS - 1) * col);
    }

    uint32_t cw = codes4(trow, 0, m_b, vec);
    if (m_b >= ROWS) {
      // the rows start and end a step apart: no cell outside the matrix
      uint32_t cn = codes4(trow, GROUP, m_b, vec);
      opening<AFFINE, PROFILE, END, 0>(T, w, ring, cw);
      cw = cn;
      cn = codes4(trow, 2 * GROUP, m_b, vec);
      opening<AFFINE, PROFILE, END, 1>(T, w, ring, cw);
      cw = cn;
      cn = codes4(trow, 3 * GROUP, m_b, vec);
      opening<AFFINE, PROFILE, END, 2>(T, w, ring, cw);
      cw = cn;
      cn = codes4(trow, 4 * GROUP, m_b, vec);
      opening<AFFINE, PROFILE, END, 3>(T, w, ring, cw);
      cw = cn;
      int s0 = ROWS;
      for (; s0 + GROUP <= m_b; s0 += GROUP) {
        cn = codes4(trow, s0 + GROUP, m_b, vec);
        group<AFFINE, PROFILE, END, false>(T, w, ring, s0, cw);
        cw = cn;
      }
      const int rest = m_b - s0;  // full steps short of a group
      if (rest > 0) step<AFFINE, PROFILE, END, false, 0, ROWS - 1, 0>(T, w, ring, s0, cw);
      if (rest > 1) step<AFFINE, PROFILE, END, false, 0, ROWS - 1, 1>(T, w, ring, s0 + 1, cw);
      if (rest > 2) step<AFFINE, PROFILE, END, false, 0, ROWS - 1, 2>(T, w, ring, s0 + 2, cw);
      closing<AFFINE, PROFILE, END, 0>(T, w, ring, m_b);
    } else {
      // short targets: groups of every row, masked where a step has a
      // row outside [0, m_b)
      for (int s0 = 0; s0 < m_b + ROWS - 1; s0 += GROUP) {
        const uint32_t cn = codes4(trow, s0 + GROUP, m_b, vec);
        if (s0 < ROWS - 1 || s0 + GROUP > m_b)
          group<AFFINE, PROFILE, END, true>(T, w, ring, s0, cw);
        else
          group<AFFINE, PROFILE, END, false>(T, w, ring, s0, cw);
        cw = cn;
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (END == END_PIN) {
        if (i0 + r + 1 == n_b) best = T.d[r] + go;
        continue;
      }
      // the row's best (H - go) and the step of its first cell at it
      int rb = T.rb[r], rs = T.rs[r];
      if (END == END_KEY && rb != INT_MAX && rb > origin) {
        rs = kmul - 1 - (rb & (kmul - 1));
        rb >>= sc.kbits;
      }
      if (rs >= 0 && rb + go > best) {
        best = rb + go;
        bi = i0 + r + 1;
        bj = rs - r + 1;
      }
    }
  }

  if (END != END_PIN) {
    // the boundary's first maxima, row 0's (j = 1..m_b, tracked when lq >=
    // 0) and column 0's (i = 1..n_col, tracked when lt >= 0), merged after
    // the DP: the interior's fold starts at the origin, so the three first
    // maxima merged in row-major order are the pair's. Kept out of the
    // sweeps, they hold no register there
    if (lq >= 0) merge_chain<AFFINE>(m_b, go, ge, true, best, bi, bj);
    if (lt >= 0) merge_chain<AFFINE>(n_col, go, ge, false, best, bi, bj);
  }
  score[b] = best;
  end_i[b] = bi;
  end_j[b] = bj;
}

template <bool AFFINE, bool PROFILE>
void launch(int end, const void* q, const void* t, const void* table, const void* lens_q,
            const void* lens_t, void* scratch, void* score, void* end_i, void* end_j,
            int B, int n, int m, Scoring sc, bool vec, cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  auto* kernel = end == END_PIN ? sw_semiglobal_kernel<AFFINE, PROFILE, END_PIN>
                 : end == END_KEY ? sw_semiglobal_kernel<AFFINE, PROFILE, END_KEY>
                                  : sw_semiglobal_kernel<AFFINE, PROFILE, END_SELECT>;
  const int smem = PROFILE ? sc.codes * sc.codes * 32 * 4 : 0;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens_q),
      static_cast<const int32_t*>(lens_t), static_cast<int32_t*>(scratch),
      static_cast<int32_t*>(score), static_cast<int32_t*>(end_i),
      static_cast<int32_t*>(end_j), B, n, m, sc, vec);
}

}  // namespace

extern "C" {

// The query rows a sweep (the wrapper needs the scratch past one sweep).
int swtpu_sw_semiglobal_rows() { return ROWS; }

// The step bits of END_KEY's key for an argmax launch of these sizes and
// scores, or -1 when the key cannot hold them (END_SELECT runs). A profile
// launch passes its matrix's largest |entry| as `match` (and 0 as
// `mismatch`).
int swtpu_sw_semiglobal_key_bits(int n, int m, int match, int mismatch, int gap_open,
                                 int gap_extend) {
  int kbits = 0;
  while ((1LL << kbits) < static_cast<long long>(m) + ROWS + GROUP) ++kbits;
  long long mag = std::max(llabs(match), llabs(mismatch));
  mag = std::max(mag, std::max(llabs(gap_open), llabs(gap_extend)));
  const long long span =
      (static_cast<long long>(n) + m + ROWS + GROUP) * mag + llabs(gap_open) + 1;
  return kbits < 31 && span < (1LL << (31 - kbits)) ? kbits : -1;
}

// Launches one of the instantiations on `stream` and returns
// cudaGetLastError() (a refused launch never runs, and a later synchronise
// would not report it); cudaErrorInvalidValue for an `end` outside 0..2
// (END_KEY: the argmax, with the packed key where it holds these sizes and
// scores, else END_SELECT; END_SELECT: the argmax with (best, step) apart
// whatever the scores, which chip_smoke.py times beside the key; END_PIN:
// the pinned corner), a profile table stride outside 1..32 or codes
// outside 1..stride (the codes the lane table holds, the last a pad: the
// alphabet + 1; codes past it score as that pad), or a missing scratch
// past one sweep. Pointers: q [B, n] uint8, t [B, m] uint8, table
// [stride, stride] int32 (profile only),
// lens_q / lens_t [B] int32 or null for the full widths, scratch [m, B]
// int32 (linear: H - go) or [m, B, 2] int32 (affine: H - go, F), unused
// (null) when n <= ROWS or m == 0, score / end_i / end_j [B] int32. All
// on one device, all contiguous; the wrapper checks that. `mismatch` is
// the score of a mismatch (negative for a penalty; a profile launch: 0,
// with `match` its matrix's largest |entry|, the key's bound); linear
// kernels use gap_open as the gap. Gaps of any sign.
int swtpu_sw_semiglobal(int affine, int profile, int end, const void* q,
                        const void* t, const void* table, const void* lens_q,
                        const void* lens_t, void* scratch, void* score,
                        void* end_i, void* end_j, int B, int n, int m, int match,
                        int mismatch, int stride, int codes, int gap_open,
                        int gap_extend, void* stream) {
  if (end < END_KEY || end > END_PIN ||
      (profile && (stride < 1 || stride > MAX_STRIDE || codes < 1 || codes > stride)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > ROWS && m > 0 && !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int kbits =
      end == END_KEY ? swtpu_sw_semiglobal_key_bits(n, m, match, mismatch, gap_open, gap_extend)
                     : -1;
  if (end == END_KEY && kbits < 0) end = END_SELECT;
  const int kb = kbits < 0 ? 0 : kbits;
  const Scoring sc{match, mismatch, stride, profile ? codes : 5, gap_open, gap_extend, kb,
                   1 << kb};
  // whole 32-bit code words: every target row 4-byte aligned
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine && profile)
    launch<true, true>(end, q, t, table, lens_q, lens_t, scratch, score, end_i,
                       end_j, B, n, m, sc, vec, s);
  else if (affine)
    launch<true, false>(end, q, t, table, lens_q, lens_t, scratch, score, end_i,
                        end_j, B, n, m, sc, vec, s);
  else if (profile)
    launch<false, true>(end, q, t, table, lens_q, lens_t, scratch, score, end_i,
                        end_j, B, n, m, sc, vec, s);
  else
    launch<false, false>(end, q, t, table, lens_q, lens_t, scratch, score, end_i,
                         end_j, B, n, m, sc, vec, s);
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
