// Batched fixed-band Smith-Waterman for Hopper (sm_90a): local alignment
// scores restricted to the diagonal corridor |i - j| <= W, linear or
// affine (Gotoh) gaps, uniform or general-matrix scoring.
//
// Replaces the fixed-band TPU kernel in its three modes:
//   <false,false>  swtpu/kernels/pallas/sw_banded.py  _kernel, uniform linear  (pallas_call :239)
//   <true, false>  same, uniform affine
//   <false,true >  same, packed-profile lookup (general matrix), linear
//   <true, true >  same, general matrix, affine
// whose entries are sw_banded_static_pallas (:295) and
// sw_banded_profile_pallas (:371).
//
// Design. The row-scan skeleton of csrc/sw_rowscan.cu restricted to the
// corridor: one thread per pair over [n, B] / [m, B] uint8 codes (a warp
// reads 32 neighbouring bytes), rows outer in sweeps of ROWS rows with
// the left H and E, the diagonal H and each row's score setup in
// registers. A sweep over rows
// i0+1 .. i0+ROWS visits only the columns the corridor reaches,
// max(1, i0+1-W) .. min(m, i0+ROWS+W). The previous sweep's last row
// lives in a per-pair ring of S = 2W + ROWS + 1 int32 slots (column j in
// slot j mod S; F beside it for affine), [S, B] scratch from the wrapper:
// a sweep reads a column's slot before it writes it, the slot it reads
// next belongs to a column the sweep has not reached, and no slot is
// overwritten while a later sweep still needs it. Reads of the previous
// row past its band (j > i0 + W) read a dead 0 instead of the slot.
// The TPU kernel's (8, 128) tiles, its lagged boundary buffer and its
// static chunk unroll are layout, not contract, and are not carried over.
//
// Dead is 0. Out-of-band H is exactly 0 (the Pallas kernel's rule,
// sw_banded.py:22-28): an in-band cell's diagonal is in band, and an up or
// left neighbour out of band adds 0 - gap < 0, below the local floor; out
// of band E and F are computed from those zeros and stay <= -gap_open, so
// they never win either. Hence the guards: uniform scoring needs
// mismatch < 0 < gap, the profile gap > 0 (checked by the wrapper).
// Where trouble hides:
// - the left-edge diagonal across sweeps: row i0+1's first diagonal is
//   H[i0][i0-W], the previous sweep's last row at its leftmost band
//   column (read from the ring), not a dead 0 (sw_banded.py:127-133);
// - the best is taken over in-band cells of real rows only: h is masked
//   to 0 before it is tracked (sw_banded.py:189-200);
// - ragged shapes: any n, m >= 0, no padding; rows past n in the last
//   sweep are masked phantoms.
// Columns where every row of the sweep is in band skip the mask (the
// MASK = false instantiation of the column step); only the two ramps of
// about ROWS columns at each end of a sweep pay it.
//
// Scores: uniform s = match where q == t, else mismatch; the general
// matrix looks up the banded extended table (kernels/banded_scan.py::
// _banded_ext_table, stride 8 or 32) in shared memory. A pad (code >=
// the alphabet) scores matrix.min() in both forms, the banded oracles'
// and the mapper's rule; the Pallas profile kernel scores pads at -128.
//
// Bound: int32 issue (132 SMs x 64 lanes x SM clock) over the in-band
// cells, as in the row-scan kernels; the codes are 2 bytes per
// pair-residue and the ring's traffic about 1 byte per cell, both under
// the ops. As written an in-band cell costs the row-scan's counts: 9 int32
// ops uniform linear (score 3, H 5, best 1), 14 uniform affine (F 3, E 3,
// H 4), 7 and 12 for the profile (its score is one add and one
// shared-memory lookup); ramp cells add 4 (two compares, an and, a
// select). Later work: DPX (__viaddmax_s32), reading the [B, L] layout
// directly, and the ring in shared memory at small W.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;
constexpr int THREADS = 128;
constexpr int MAX_STRIDE = 32;
constexpr int NEG_EF = -(1 << 29);

struct Params {
  int B, n, m, W, S;
  int alpha;     // uniform: alphabet size, codes >= alpha are pads
  int match, mismatch;
  int pad_score; // matrix.min(): a pad against anything
  int stride;    // profile: table stride; codes clamp to stride - 1
  int go, ge;    // linear kernels use go as the gap
};

// A sweep's register state: per-row code (profile: table row offset) and
// score setup, left H, diagonal H and left E, the next column's code and
// previous-row H and F (loaded one column ahead), the ring slot of the
// current column, the running best.
struct Sweep {
  int qv[ROWS], mr[ROWS], xr[ROWS];
  int hl[ROWS], dg[ROWS], el[ROWS];
  int t_next, up_next, f_next;
  int slot, best;
};

// Columns j0 .. j1 of the sweep over rows i0 + 1 .. i0 + ROWS: every row
// in order per column, the previous row's H and F at column j coming in
// as (up, f) and the last row's going out to the ring. MASK zeroes cells
// out of band and phantom rows (r >= live).
template <bool AFFINE, bool PROFILE, bool MASK>
__device__ __forceinline__ void columns(Sweep& w, int j0, int j1, int i0, int jhi, int live,
                                        const Params& p, const int32_t* tab,
                                        const uint8_t* __restrict__ tT,
                                        int32_t* __restrict__ hring,
                                        int32_t* __restrict__ fring, int b) {
  const size_t sB = static_cast<size_t>(p.B);
  for (int j = j0; j <= j1; ++j) {
    const int tc = w.t_next;
    int up = w.up_next;
    int f = w.f_next;
    const int next_slot = (w.slot + 1 == p.S) ? 0 : w.slot + 1;
    if (j < jhi) {  // prefetch column j + 1; the previous row is in band up to i0 + W
      w.t_next = tT[j * sB + b];
      const bool live_up = i0 > 0 && j + 1 <= i0 + p.W;
      w.up_next = live_up ? hring[next_slot * sB + b] : 0;
      if (AFFINE) w.f_next = live_up ? fring[next_slot * sB + b] : NEG_EF;
    }
    const bool tpad = tc >= p.alpha;
    const int tcl = min(tc, p.stride - 1);
    const int d0 = j - i0 - 1;  // j - i of row 0
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      int s;
      if (PROFILE) {
        s = tab[w.qv[r] + tcl];
      } else {
        s = (w.qv[r] == tc) ? w.mr[r] : w.xr[r];
        s = tpad ? p.pad_score : s;
      }
      int h;
      if (AFFINE) {
        f = max(f - p.ge, up - p.go);
        w.el[r] = max(w.el[r] - p.ge, w.hl[r] - p.go);
        h = max(max(w.dg[r] + s, 0), max(w.el[r], f));
      } else {
        h = max(max(w.dg[r] + s, 0), max(up, w.hl[r]) - p.go);
      }
      if (MASK) {
        const int d = d0 - r;
        h = (d >= -p.W && d <= p.W && r < live) ? h : 0;
      }
      w.dg[r] = up;  // H[i - 1][j] is the diagonal of cell (i, j + 1)
      w.hl[r] = h;
      up = h;        // and H[i][j] is the cell above (i + 1, j)
      w.best = max(w.best, h);
    }
    hring[w.slot * sB + b] = up;
    if (AFFINE) fring[w.slot * sB + b] = f;
    w.slot = next_slot;
  }
}

template <bool AFFINE, bool PROFILE>
__global__ void __launch_bounds__(THREADS)
sw_banded_kernel(const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
                 const int32_t* __restrict__ table, int32_t* __restrict__ hring,
                 int32_t* __restrict__ fring, int32_t* __restrict__ score, Params p) {
  __shared__ int32_t tab[PROFILE ? MAX_STRIDE * MAX_STRIDE : 1];
  if (PROFILE) {
    for (int k = threadIdx.x; k < p.stride * p.stride; k += THREADS) tab[k] = table[k];
    __syncthreads();
  }
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= p.B) return;
  const size_t sB = static_cast<size_t>(p.B);
  const int W = p.W, S = p.S;

  Sweep w;
  w.best = 0;
  for (int i0 = 0; i0 < p.n; i0 += ROWS) {
    const int jlo = max(1, i0 + 1 - W);
    const int jhi = min(p.m, i0 + ROWS + W);
    if (jlo > jhi) break;  // the corridor has left the matrix for good
    const int live = min(ROWS, p.n - i0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int c = (r < live) ? qT[(i0 + r) * sB + b] : 255;
      if (PROFILE) {
        w.qv[r] = min(c, p.stride - 1) * p.stride;
      } else {
        const bool pad = c >= p.alpha;
        w.qv[r] = c;
        w.mr[r] = pad ? p.pad_score : p.match;
        w.xr[r] = pad ? p.pad_score : p.mismatch;
      }
      w.hl[r] = 0;
      w.dg[r] = 0;
      w.el[r] = NEG_EF;
    }
    w.slot = jlo % S;
    // H[i0][jlo - 1]: the previous sweep's last row at its leftmost band
    // column, not a dead 0 (row 0 and column 0 are 0)
    if (i0 > 0 && jlo > 1) w.dg[0] = hring[(w.slot == 0 ? S - 1 : w.slot - 1) * sB + b];
    w.t_next = tT[(jlo - 1) * sB + b];
    const bool live_up = i0 > 0 && jlo <= i0 + W;  // false only at W = 0
    w.up_next = live_up ? hring[w.slot * sB + b] : 0;
    w.f_next = (AFFINE && live_up) ? fring[w.slot * sB + b] : NEG_EF;

    // a masked ramp, the columns where every row is in band, a masked
    // ramp; phantom rows in the last sweep mask every column
    const int full_lo = max(jlo, i0 + ROWS - W);
    const int full_hi = (live == ROWS) ? min(jhi, i0 + 1 + W) : jlo - 1;
    const int ramp_end = (full_lo <= full_hi) ? full_lo - 1 : jhi;
    columns<AFFINE, PROFILE, true>(w, jlo, ramp_end, i0, jhi, live, p, tab, tT, hring,
                                   fring, b);
    if (full_lo <= full_hi) {
      columns<AFFINE, PROFILE, false>(w, full_lo, full_hi, i0, jhi, live, p, tab, tT,
                                      hring, fring, b);
      columns<AFFINE, PROFILE, true>(w, full_hi + 1, jhi, i0, jhi, live, p, tab, tT, hring,
                                     fring, b);
    }
  }
  score[b] = w.best;
}

template <bool AFFINE, bool PROFILE>
void launch(const void* qT, const void* tT, const void* table, void* hring, void* fring,
            void* score, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.B + THREADS - 1) / THREADS);
  sw_banded_kernel<AFFINE, PROFILE><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(qT), static_cast<const uint8_t*>(tT),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(hring),
      static_cast<int32_t*>(fring), static_cast<int32_t*>(score), p);
}

}  // namespace

extern "C" {

// Ring slots the kernel needs per pair for half-width W.
int swtpu_sw_banded_ring(int W) { return 2 * W + ROWS + 1; }

// Launches one of the four instantiations on `stream` and returns
// cudaGetLastError() (a refused launch never runs, and a later synchronise
// would not report it); cudaErrorInvalidValue for W < 0 or a table stride
// outside 1..32. Pointers: qT [n, B] uint8, tT [m, B] uint8, table
// [stride, stride] int32 (profile only, else null), hring / fring
// [2W + 9, B] int32 (fring affine only), score [B] int32. All on one
// device, all contiguous; the wrapper checks that. Linear kernels use
// gap_open as the gap.
int swtpu_sw_banded(int affine, const void* qT, const void* tT, const void* table,
                    void* hring, void* fring, void* score, int B, int n, int m, int W,
                    int alpha, int match, int mismatch, int pad_score, int stride,
                    int gap_open, int gap_extend, void* stream) {
  const bool profile = table != nullptr;
  if (W < 0 || (profile && (stride < 1 || stride > MAX_STRIDE)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const Params p{B, n, m, W, 2 * W + ROWS + 1, alpha, match, mismatch, pad_score,
                 profile ? stride : 1, gap_open, gap_extend};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine) {
    if (profile) launch<true, true>(qT, tT, table, hring, fring, score, p, s);
    else launch<true, false>(qT, tT, table, hring, fring, score, p, s);
  } else {
    if (profile) launch<false, true>(qT, tT, table, hring, fring, score, p, s);
    else launch<false, false>(qT, tT, table, hring, fring, score, p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
