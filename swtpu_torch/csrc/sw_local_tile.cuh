// The skewed register tile of the local (Smith-Waterman) row-scan, shared
// by csrc/sw_rowscan.cu (uniform scoring), the thread form of
// csrc/sw_profile.cu and the tile form of csrc/sw_general.cu (a general
// matrix through a lane table). Each source defines its own __global__
// kernel and calls local_pair() for the pair its thread owns (the lane
// table's users through profile_pairs(), at the end); kernels/_build.py
// hashes this header with each source that includes it.
//
// One thread per pair, reading the codes as the caller holds them, [B, n]
// / [B, m] uint8 (no transposes): a thread loads its own target row four
// codes at a time (one 32-bit load a group of four steps when m % 4 == 0
// and the rows are 4-byte aligned, else four byte loads) and its query
// rows once a sweep. Rows outer, ROWS = 16 query rows a sweep in
// registers, as a skewed tile: at step s row r computes column s - r,
// from its own left state, the H (and F) that row r - 1 computed at step
// s - 1 (its up) and at step s - 2 (its diagonal), and the target value
// row r - 1 held, shifted down a row a step. The 16 cells of a step are
// independent. With m >= ROWS a sweep opens with 16 steps in which row s
// starts at step s, runs whole groups of four steps, and closes with 15
// steps in which row r ends at step m + r - 1: the rows of each step are
// compile-time ranges, so no cell outside the matrix is computed or
// masked. Shorter targets run groups of every row, masked where a step has
// a row outside [0, m): there a row keeps its H and its tracker, and E,
// F, the diagonal and the target value take any value (they reach no real
// cell; E of a row before its first column stays max(E - ge, H[i, 0] -
// go) = -go, which is what its first cell computes from -inf). Row 0 takes
// the row above the sweep (H - go and F) from the scratch, [m, B] int32
// or, affine, [m, B, 2] (one 8-byte load a step), loaded a group ahead
// into a ring of four (the first sweep keeps the boundary, H = 0 and F =
// -inf), and row ROWS - 1 writes it for the next sweep (the last sweep
// writes nothing). Rows past n in the last sweep are phantom pad rows:
// they come after every real row, so they feed none, and no cell of
// theirs exceeds the real cell it was computed from (their best is not
// tracked for the endpoint; for the score it cannot win).
//
// The cell. H is kept minus the gap open (D = H - go; the boundary's D is
// -go), and go is folded into the score, so the linear cell is the
// diagonal's add and one __vimax3_s32_relu (the 0 floor) of it, up and
// left, the Gotoh cell two __viaddmax_s32 (E, F), the add and the
// three-way max with the floor; then D = H - go.
//
// Scores. PROFILE looks each cell up in the plain tier's extended table
// (pads -2^20), held in shared memory as a lane table: the codes clamp to
// the alphabet + 1 (the last a pad), and each entry is held 32 times, word
// 32 x entry + lane, so a warp's 32 lookups hit 32 banks whatever the
// codes. Uniform scoring keeps, for each row, its code + 2^30 (INT_MIN for
// a pad row: no target value equals it) and its mismatch score (pad rows
// -2^20), and each target value is its code + 2^30 or, for a pad, -2^20
// (+ go): the score is min(row code == target ? match : the row's
// mismatch, target value), a compare, a select and a min, exact while
// -2^20 <= match, mismatch and match + go, mismatch + go <= 2^30 with go <
// 2^20 (narrow). WIDE forms (any other scoring) select the pad instead:
// target value < 0 ? -2^20 : the select (a compare and a select more).
//
// Trackers. END_SCORE keeps the best D of rows 2p and 2p + 1 (a
// three-way max a pair of rows a step). The endpoint is the first
// maximum in row-major order (score 0: (0, 0)): every row keeps its own
// best and the step of its first cell at that best, updated on a strictly
// greater H while its columns ascend, and after each sweep the rows fold
// in order into the thread's (best, i, j), again on strictly greater; the
// column is the step minus the row. END_KEY holds both in one int32 key,
// D x 2^k + (2^k - 1 - s), k the bits of the steps a sweep: one IMAD and
// one max a cell. The launch takes it when key_bits() says the key holds
// every |D| of the pair; else END_SELECT keeps (best, step) apart: a
// compare and two selects a cell. A phantom row's best starts at INT_MAX,
// so it never updates.

#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>

namespace local_tile {

constexpr int ROWS = 16;   // query rows a sweep
constexpr int GROUP = 4;   // steps a group: one code word, the prefetch distance
constexpr int PAD_SCORE = -(1 << 20);
constexpr int NEG_EF = -(1 << 29);
constexpr int REAL = 1 << 30;   // uniform: a real code's offset
constexpr int MAX_ENTRY = 127;  // |profile entry| (sw_profile.profile_refusal)
// the tracker a form runs
constexpr int END_SCORE = 0;   // the score only
constexpr int END_KEY = 1;     // the endpoint, (best, step) in one key
constexpr int END_SELECT = 2;  // the endpoint, (best, step) apart

struct Scoring {
  int alpha;   // uniform: codes >= alpha are pads
  int hit;     // uniform: match + go
  int miss;    // uniform: mismatch + go
  int padgo;   // PAD_SCORE + go
  int pad;     // profile: the pad code, the lane table's last (alphabet)
  int go, ge;  // linear kernels use go as the gap
  int kbits;   // END_KEY: the step bits of the key
  int kmul;    // and 2^kbits
};

// The step bits of END_KEY's key for these sizes and scores (a profile
// entry counts as MAX_ENTRY), or -1 when the key cannot hold every |D|.
inline int key_bits(bool profile, long long n, long long m, long long match,
                    long long mismatch, long long go, long long ge) {
  int kbits = 0;
  while ((1LL << kbits) < m + ROWS + GROUP) ++kbits;
  long long mag = profile ? MAX_ENTRY : std::max(llabs(match), llabs(mismatch));
  mag = std::max(mag, std::max(llabs(go), llabs(ge)));
  const long long span = (n + m + ROWS + GROUP) * mag + go + 1;
  return kbits < 31 && span < (1LL << (31 - kbits)) ? kbits : -1;
}

// Whether the uniform score's min-cap pad rule is exact for these scores.
inline bool narrow(long long match, long long mismatch, long long go) {
  return std::min(match, mismatch) >= PAD_SCORE && std::max(match, mismatch) + go <= REAL &&
         go < -static_cast<long long>(PAD_SCORE);
}

// the registers of a sweep: row r holds query row i0 + r + 1 (an
// instantiation keeps only the arrays it uses)
struct Tile {
  int qc[ROWS];  // profile: the row's shared address in the lane table; uniform: code + REAL
  int mr[ROWS];  // uniform: the row's mismatch score (go folded in; a pad row's padgo)
  int tc[ROWS];  // the target value of the row's last column
  int d[ROWS];   // D = H - go of the row's last cell
  int dg[ROWS];  // D of the diagonal of the row's next cell
  int e[ROWS];
  int f[ROWS];   // F of the row's last cell
  int rb[ROWS];  // the row's best: its key, or D; END_SCORE: rb[p] for rows 2p, 2p + 1
  int rs[ROWS];  // END_SELECT: the step of that best, -1 before one
};

// row 0's up (D of the row above the sweep) and F for the steps of a
// group, slot s % GROUP; each slot refills GROUP steps ahead
struct Ring {
  int h[GROUP];
  int f[GROUP];
};

// what a sweep's steps share; the scratch is [m, B] (D) or, affine,
// [m, B, 2] (D, F), `col` elements a column
struct Sweep {
  const int32_t* rd;  // row 0's refill: column s + GROUP
  int32_t* wr;        // row ROWS - 1's hand-off: column s - ROWS + 1
  ptrdiff_t col;
  int m;
  bool first, last;   // the first sweep reads no scratch, the last writes none
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
// step takes its diagonal (row HI's boundary D). MASKED: rows LO..HI all
// compute, and a row outside [0, m) keeps its H and its tracker.
template <bool AFFINE, bool PROFILE, bool WIDE, int END, bool MASKED, int LO, int HI>
__device__ __forceinline__ void cells(Tile& T, const Sweep& w, const Scoring& sc, int s,
                                      int tnew, int up_in, int f_in) {
  const int ks = sc.kmul - 1 - s;  // END_KEY: the step's part of the key
#pragma unroll
  for (int r = ROWS - 1; r >= LO; --r) {
    if (r > HI) {
      if (r == HI + 1) T.dg[r] = T.d[r - 1];
      continue;
    }
    const int tr = r ? T.tc[r - 1] : tnew;
    const int up = r ? T.d[r - 1] : up_in;
    int sg;
    if (PROFILE) {
      sg = lane_score(T.qc[r] + tr);
    } else {
      const int sel = T.qc[r] == tr ? sc.hit : T.mr[r];
      sg = WIDE ? (tr < 0 ? sc.padgo : sel) : min(sel, tr);
    }
    int h;
    if (AFFINE) {
      const int fu = r ? T.f[r - 1] : f_in;
      const int f = __viaddmax_s32(fu, -sc.ge, up);
      const int e = __viaddmax_s32(T.e[r], -sc.ge, T.d[r]);
      h = __vimax3_s32_relu(T.dg[r] + sg, e, f);
      T.f[r] = f;
      T.e[r] = e;
    } else {
      h = __vimax3_s32_relu(T.dg[r] + sg, up, T.d[r]);
    }
    const int dn = h - sc.go;
    T.tc[r] = tr;
    T.dg[r] = up;
    const bool valid = !MASKED || static_cast<unsigned>(s - r) < static_cast<unsigned>(w.m);
    if (valid) T.d[r] = dn;
    if (END == END_KEY) {
      const int key = dn * sc.kmul + ks;
      if (valid) T.rb[r] = max(T.rb[r], key);
    } else if (END == END_SELECT) {
      if (valid && dn > T.rb[r]) {
        T.rb[r] = dn;
        T.rs[r] = s;
      }
    } else if (r % 2 == 0) {
      // rows r and r + 1 (done first this step, or not started: its D is
      // the boundary's)
      T.rb[r / 2] = __vimax3_s32(T.rb[r / 2], T.d[r], T.d[r | 1]);
    } else if (r == LO) {
      T.rb[r / 2] = max(T.rb[r / 2], T.d[r]);  // row r - 1 is done
    }
  }
}

// Step s: row 0 (LO == 0) takes code byte U of cw and ring slot U, which
// refills with column s + GROUP; rows LO..HI compute; row ROWS - 1 (HI ==
// ROWS - 1) hands column s - ROWS + 1 to the next sweep.
template <bool AFFINE, bool PROFILE, bool WIDE, int END, bool MASKED, int LO, int HI, int U>
__device__ __forceinline__ void step(Tile& T, Sweep& w, Ring& ring, const Scoring& sc, int s,
                                     uint32_t cw) {
  int tn = 0, up_in = 0, f_in = 0;
  if (LO == 0) {
    tn = (cw >> (8 * U)) & 0xff;
    if (PROFILE)
      tn = min(tn, sc.pad) * 128;  // the code's row of the lane table
    else
      tn = tn < sc.alpha ? tn + REAL : (WIDE ? -1 : sc.padgo);
    up_in = ring.h[U];
    f_in = ring.f[U];
    if (!w.first && s + GROUP < w.m) {
      if (AFFINE) {
        const int2 v = __ldcg(reinterpret_cast<const int2*>(w.rd));
        ring.h[U] = v.x;
        ring.f[U] = v.y;
      } else {
        ring.h[U] = __ldcg(w.rd);
      }
    }
  }
  cells<AFFINE, PROFILE, WIDE, END, MASKED, LO, HI>(T, w, sc, s, tn, up_in, f_in);
  if (HI == ROWS - 1) {
    const int j = s - (ROWS - 1);
    if (!w.last && (!MASKED || (j >= 0 && j < w.m))) {
      if (AFFINE)
        __stcg(reinterpret_cast<int2*>(w.wr), make_int2(T.d[ROWS - 1], T.f[ROWS - 1]));
      else
        __stcg(w.wr, T.d[ROWS - 1]);
    }
  }
  w.rd += w.col;
  w.wr += w.col;
}

// four target codes from column j on (bytes past m are never scored)
__device__ __forceinline__ uint32_t codes4(const uint8_t* __restrict__ row, int j, int m,
                                           bool vec) {
  if (j >= m) return 0;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + j));
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < GROUP; ++k)
    if (j + k < m) w |= static_cast<uint32_t>(__ldg(row + j + k)) << (8 * k);
  return w;
}

// steps s0 .. s0 + GROUP - 1 with every row (MASKED: whatever their columns)
template <bool AFFINE, bool PROFILE, bool WIDE, int END, bool MASKED>
__device__ __forceinline__ void group(Tile& T, Sweep& w, Ring& ring, const Scoring& sc,
                                      int s0, uint32_t cw) {
  step<AFFINE, PROFILE, WIDE, END, MASKED, 0, ROWS - 1, 0>(T, w, ring, sc, s0, cw);
  step<AFFINE, PROFILE, WIDE, END, MASKED, 0, ROWS - 1, 1>(T, w, ring, sc, s0 + 1, cw);
  step<AFFINE, PROFILE, WIDE, END, MASKED, 0, ROWS - 1, 2>(T, w, ring, sc, s0 + 2, cw);
  step<AFFINE, PROFILE, WIDE, END, MASKED, 0, ROWS - 1, 3>(T, w, ring, sc, s0 + 3, cw);
}

// the first ROWS steps, group K: rows 0..s (row s starts at step s)
template <bool AFFINE, bool PROFILE, bool WIDE, int END, int K>
__device__ __forceinline__ void opening(Tile& T, Sweep& w, Ring& ring, const Scoring& sc,
                                        uint32_t cw) {
  step<AFFINE, PROFILE, WIDE, END, false, 0, 4 * K, 0>(T, w, ring, sc, 4 * K, cw);
  step<AFFINE, PROFILE, WIDE, END, false, 0, 4 * K + 1, 1>(T, w, ring, sc, 4 * K + 1, cw);
  step<AFFINE, PROFILE, WIDE, END, false, 0, 4 * K + 2, 2>(T, w, ring, sc, 4 * K + 2, cw);
  step<AFFINE, PROFILE, WIDE, END, false, 0, 4 * K + 3, 3>(T, w, ring, sc, 4 * K + 3, cw);
}

// the last ROWS - 1 steps, from s = m + E: rows E + 1..ROWS - 1 (row r
// ends at step m + r - 1)
template <bool AFFINE, bool PROFILE, bool WIDE, int END, int E>
__device__ __forceinline__ void closing(Tile& T, Sweep& w, Ring& ring, const Scoring& sc,
                                        int s) {
  if constexpr (E < ROWS - 1) {
    step<AFFINE, PROFILE, WIDE, END, false, E + 1, ROWS - 1, 0>(T, w, ring, sc, s, 0);
    closing<AFFINE, PROFILE, WIDE, END, E + 1>(T, w, ring, sc, s + 1);
  }
}

// One pair: the n x m local DP of query row qrow against target row trow,
// pair b of B (its column of the scratch). `lane0`: PROFILE, this lane's
// shared address of entry 0 of the lane table. Returns the score and,
// for the endpoint forms, the 1-based first maximum in row-major order.
template <bool AFFINE, bool PROFILE, bool WIDE, int END>
__device__ __forceinline__ void local_pair(const uint8_t* __restrict__ qrow,
                                           const uint8_t* __restrict__ trow,
                                           int32_t* __restrict__ scratch, int b, int n, int m,
                                           ptrdiff_t col, const Scoring& sc, bool vec,
                                           unsigned lane0, int& best, int& bi, int& bj) {
  const int go = sc.go;
  const int kmul = sc.kmul;
  best = 0;
  bi = 0;
  bj = 0;
  if (m == 0) n = 0;

  // a tracked row's start: H = 0, at a key no step beats
  const int origin = END == END_KEY ? -go * kmul + (kmul - 1) : -go;
  Sweep w{nullptr, nullptr, col, m, true, false};
  Tile T;
  Ring ring;
  if (END == END_SCORE) {
#pragma unroll
    for (int p = 0; p < ROWS / 2; ++p) T.rb[p] = -go;
  }
  for (int i0 = 0; i0 < n; i0 += ROWS) {
    w.first = i0 == 0;
    w.last = i0 + ROWS >= n;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r + 1;  // 1-based DP row
      const int c = i <= n ? qrow[i - 1] : (PROFILE ? sc.pad : sc.alpha);
      if (PROFILE) {
        T.qc[r] = lane0 + min(c, sc.pad) * (sc.pad + 1) * 128;
      } else {
        T.qc[r] = c < sc.alpha ? c + REAL : INT_MIN;
        T.mr[r] = c < sc.alpha ? sc.miss : sc.padgo;
      }
      T.tc[r] = 0;
      T.d[r] = -go;  // H[i, 0] = 0
      T.dg[r] = -go;
      if (AFFINE) {
        T.e[r] = NEG_EF;
        T.f[r] = NEG_EF;
      }
      if (END != END_SCORE) T.rb[r] = i <= n ? origin : INT_MAX;
      T.rs[r] = -1;
    }

    // row 0's up and F for columns 0..GROUP - 1: the scratch, or in the
    // first sweep the boundary (H = 0, F = -inf)
    const int32_t* col0 = scratch + static_cast<ptrdiff_t>(b) * (AFFINE ? 2 : 1);
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      ring.h[u] = -go;
      ring.f[u] = NEG_EF;
      if (!w.first && u < m) {
        if (AFFINE) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(col0 + u * col));
          ring.h[u] = v.x;
          ring.f[u] = v.y;
        } else {
          ring.h[u] = __ldcg(col0 + u * col);
        }
      }
    }
    if (scratch) {
      w.rd = col0 + GROUP * col;
      w.wr = scratch + (static_cast<ptrdiff_t>(b) * (AFFINE ? 2 : 1) - (ROWS - 1) * col);
    }

    uint32_t cw = codes4(trow, 0, m, vec);
    if (m >= ROWS) {
      // the rows start and end a step apart: no cell outside the matrix
      uint32_t cn = codes4(trow, GROUP, m, vec);
      opening<AFFINE, PROFILE, WIDE, END, 0>(T, w, ring, sc, cw);
      cw = cn;
      cn = codes4(trow, 2 * GROUP, m, vec);
      opening<AFFINE, PROFILE, WIDE, END, 1>(T, w, ring, sc, cw);
      cw = cn;
      cn = codes4(trow, 3 * GROUP, m, vec);
      opening<AFFINE, PROFILE, WIDE, END, 2>(T, w, ring, sc, cw);
      cw = cn;
      cn = codes4(trow, 4 * GROUP, m, vec);
      opening<AFFINE, PROFILE, WIDE, END, 3>(T, w, ring, sc, cw);
      cw = cn;
      int s0 = ROWS;
      for (; s0 + GROUP <= m; s0 += GROUP) {
        cn = codes4(trow, s0 + GROUP, m, vec);
        group<AFFINE, PROFILE, WIDE, END, false>(T, w, ring, sc, s0, cw);
        cw = cn;
      }
      const int rest = m - s0;  // full steps short of a group
      if (rest > 0)
        step<AFFINE, PROFILE, WIDE, END, false, 0, ROWS - 1, 0>(T, w, ring, sc, s0, cw);
      if (rest > 1)
        step<AFFINE, PROFILE, WIDE, END, false, 0, ROWS - 1, 1>(T, w, ring, sc, s0 + 1, cw);
      if (rest > 2)
        step<AFFINE, PROFILE, WIDE, END, false, 0, ROWS - 1, 2>(T, w, ring, sc, s0 + 2, cw);
      closing<AFFINE, PROFILE, WIDE, END, 0>(T, w, ring, sc, m);
    } else {
      // short targets: groups of every row, masked
      for (int s0 = 0; s0 < m + ROWS - 1; s0 += GROUP) {
        const uint32_t cn = codes4(trow, s0 + GROUP, m, vec);
        group<AFFINE, PROFILE, WIDE, END, true>(T, w, ring, sc, s0, cw);
        cw = cn;
      }
    }

    if (END == END_SCORE) continue;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      // the row's best D and the step of its first cell at it
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
  if (END == END_SCORE) {
#pragma unroll
    for (int p = 0; p < ROWS / 2; ++p) best = max(best, T.rb[p] + go);
  }
}

// The thread form of a PROFILE kernel (csrc/sw_profile.cu's thread form,
// csrc/sw_general.cu's tile form), a block of THREADS pairs: the block
// copies `table` (stride^2 int32, codes 0..sc.pad read) into dynamic
// shared memory as the lane table (entry (q, t) + go, 32 times, word 32 x
// (q x (pad + 1) + t) + lane), then each thread runs local_pair for its
// pair and writes its score and, for the endpoint forms, its endpoint.
template <bool AFFINE, int END, int THREADS>
__device__ __forceinline__ void profile_pairs(
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
    const int32_t* __restrict__ table, int32_t* __restrict__ scratch,
    int32_t* __restrict__ score, int32_t* __restrict__ end_i, int32_t* __restrict__ end_j,
    int B, int n, int m, int stride, const Scoring& sc, bool vec) {
  extern __shared__ int32_t lane_tab[];
  const int nc = sc.pad + 1;
  for (int w = threadIdx.x; w < nc * nc * 32; w += THREADS) {
    const int qi = (w >> 5) / nc, ti = (w >> 5) - qi * nc;
    lane_tab[w] = __ldg(table + qi * stride + ti) + sc.go;
  }
  __syncthreads();
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  // this lane's word of entry 0 of the lane table
  const unsigned lane0 =
      static_cast<unsigned>(__cvta_generic_to_shared(lane_tab)) + 4 * (threadIdx.x & 31);
  int best, bi, bj;
  local_pair<AFFINE, true, false, END>(
      q + b * static_cast<size_t>(n), t + b * static_cast<size_t>(m), scratch, b, n, m,
      static_cast<ptrdiff_t>(B) * (AFFINE ? 2 : 1), sc, vec, lane0, best, bi, bj);
  score[b] = best;
  if (END != END_SCORE) {
    end_i[b] = bi;
    end_j[b] = bj;
  }
}

// Launches `kernel`, a profile_pairs kernel of THREADS threads, on
// `stream` with the lane table's dynamic shared memory (past 48 KB by the
// kernel's attribute).
template <int THREADS, typename Kernel>
void launch_profile_pairs(Kernel kernel, const void* q, const void* t, const void* table,
                          void* scratch, void* score, void* end_i, void* end_j, int B, int n,
                          int m, int stride, const Scoring& sc, bool vec,
                          cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  const int smem = (sc.pad + 1) * (sc.pad + 1) * 32 * 4;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(scratch),
      static_cast<int32_t*>(score), static_cast<int32_t*>(end_i),
      static_cast<int32_t*>(end_j), B, n, m, stride, sc, vec);
}

}  // namespace local_tile
