// Batched semi-global and global (Needleman-Wunsch) row-scan for Hopper
// (sm_90a): scores and endpoints, linear or affine (Gotoh) gaps, uniform
// scoring or a general substitution matrix, fixed or per-pair lengths.
//
// Replaces the two semi-global TPU kernels, in eight forms:
//   <AFFINE, false, PIN>  swtpu/kernels/pallas/semiglobal_batch.py    _kernel (pallas_call :194)
//                         with its cross-column _reduce_endpoints (:215)
//   <AFFINE, true,  PIN>  swtpu/kernels/pallas/semiglobal_profile.py  _kernel (pallas_call :201)
// PIN = true reads each pair's (lq, lt) corner instead of the argmax:
// global alignment. The TPU kernels track the argmax of fixed-length
// batches only, and JAX runs global and per-pair lengths on its XLA scan
// on the device; here both kernels take them, so the card never runs the
// plain tier on this path.
//
// Design. The skeleton of csrc/sw_rowscan.cu: one thread per pair over
// [n, B] / [m, B] uint8 codes (so a warp's loads coalesce), rows outer,
// ROWS query rows per sweep with the left H and E in registers, an
// [m, B] int32 previous-row scratch (H, and F for affine) read and
// written once per sweep. What differs from local alignment:
//   - no max(., 0);
//   - row 0 of the scratch holds the gap chain H[0, j] (linear -j*gap,
//     affine -go - (j-1)*ge), F on row 0 and E on column 0 are -inf;
//   - each sweep's left H and diagonal start from column 0's chain:
//     H[i, 0] and H[i-1, 0] (0 at i = 1).
// Scores: PROFILE = false is uniform, with the per-row (match or
// mismatch) hoisted; a code >= 4 on either side scores mismatch, even
// against an equal code (the rule of the XLA tier, which is this
// kernel's plain version: kernels/semiglobal_scan.py). PROFILE = true
// looks each cell up in the plain tier's extended table (pads -2^20)
// copied into shared memory, as csrc/sw_profile.cu does.
//
// Endpoint (argmax). The first maximum in row-major order over the
// pair's real [0..lq] x [0..lt] region, H[0, 0] = 0 included. With gaps
// > 0 every boundary cell is negative, so the tracker starts at the
// origin (0, 0, 0) and follows interior cells only: every row keeps its
// own (best, column), updated on a strictly greater H while columns
// ascend, and after each sweep the rows fold in order into the thread's
// (best, i, j), again on strictly greater. A row past lq (or a phantom
// row past n) starts its best at INT_MAX, so it never updates; one
// column compare per column (j < lt) masks the columns past lt. The TPU
// kernel tracked per column instead and reduced across columns after the
// scan; a tracker that shared slots across column chunks once broke the
// row-major tie rule there (its module docstring). Rows never share a
// tracker here.
//
// Endpoint (PIN). H[lq, lt] and (lq, lt); a corner on the boundary
// (lq = 0 or lt = 0) is its chain value, read before the scan; an
// interior corner is caught by one predicated move per cell (on the
// column j + 1 == lt) and picked from its row after the sweep; a corner
// outside the matrix gives (-2^30, 0, 0), as the plain tier does.
//
// Guards: the kernels are exact for every n, m >= 0, every B and any
// lengths, for gaps > 0 (affine: go, ge > 0); the wrappers refuse the
// rest. Phantom rows past n in the last sweep score as pads, are never
// tracked, and start from the chain, so nothing overflows int32 (E and F
// start at -2^29 as in sw_rowscan.cu).
//
// Bound: the int32 rate (132 SMs x 64 lanes x SM clock), as in the other
// row-scans; the inputs are 2 bytes per pair-residue. As written a cell
// costs (uniform / profile): linear 9 / 8, linear pinned 7 / 6, affine
// 14 / 13, affine pinned 12 / 11 int32 ops; the profile forms add one
// shared-memory lookup. Counted in chip_smoke.py.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;
constexpr int THREADS = 128;
constexpr int MAX_STRIDE = 32;
constexpr int NEG_EF = -(1 << 29);
constexpr int MINUS_INF = -(1 << 30);

struct Scoring {
  int match;     // uniform: two equal codes below 4
  int mismatch;  // uniform: every other cell (the negated penalty)
  int stride;    // profile: the table's row stride
  int go;        // linear kernels use go as the gap
  int ge;
};

// H on a boundary chain at distance k >= 1 from the origin
template <bool AFFINE>
__device__ __forceinline__ int chain(int k, int go, int ge) {
  return AFFINE ? -go - (k - 1) * ge : -k * go;
}

template <bool AFFINE, bool PROFILE, bool PIN>
__global__ void __launch_bounds__(THREADS)
sw_semiglobal_kernel(const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
                     const int32_t* __restrict__ table,
                     const int32_t* __restrict__ lens_q,
                     const int32_t* __restrict__ lens_t, int32_t* __restrict__ hrow,
                     int32_t* __restrict__ frow, int32_t* __restrict__ score,
                     int32_t* __restrict__ end_i, int32_t* __restrict__ end_j,
                     int B, int n, int m, Scoring sc) {
  __shared__ int32_t tab[PROFILE ? MAX_STRIDE * MAX_STRIDE : 1];
  if (PROFILE) {
    for (int k = threadIdx.x; k < sc.stride * sc.stride; k += THREADS) tab[k] = table[k];
    __syncthreads();
  }

  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int go = sc.go;
  const int ge = sc.ge;
  const int pad = PROFILE ? sc.stride - 1 : 4;  // the code of a phantom row
  const int lq = lens_q ? lens_q[b] : n;
  const int lt = lens_t ? lens_t[b] : m;

  // row 0: H = the chain, F = -inf
  for (int j = 0; j < m; ++j) {
    hrow[j * sB + b] = chain<AFFINE>(j + 1, go, ge);
    if (AFFINE) frow[j * sB + b] = NEG_EF;
  }

  int best = 0, bi = 0, bj = 0;  // argmax: the origin
  int pin_row = -1;              // PIN: the row whose sweep holds the corner
  if (PIN) {
    best = MINUS_INF;
    if (lq >= 0 && lq <= n && lt >= 0 && lt <= m) {
      bi = lq;
      bj = lt;
      if (lq == 0)
        best = lt == 0 ? 0 : chain<AFFINE>(lt, go, ge);
      else if (lt == 0)
        best = chain<AFFINE>(lq, go, ge);
      else
        pin_row = lq;
    }
  }

  for (int i0 = 0; i0 < n && m > 0; i0 += ROWS) {
    int qc[ROWS], m_r[ROWS];            // code (profile: table offset), match score
    int hl[ROWS], dg[ROWS], el[ROWS];   // left H, diagonal H, left E
    int rb[ROWS], rj[ROWS];             // per-row best and its column (PIN: H at lt)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r + 1;  // 1-based DP row
      const int c = (i <= n) ? qT[(i - 1) * sB + b] : pad;
      if (PROFILE) {
        qc[r] = min(c, pad) * sc.stride;
      } else {
        qc[r] = c;
        m_r[r] = c < 4 ? sc.match : sc.mismatch;
      }
      hl[r] = chain<AFFINE>(i, go, ge);
      dg[r] = i == 1 ? 0 : chain<AFFINE>(i - 1, go, ge);
      el[r] = NEG_EF;
      rb[r] = (PIN || (i <= lq && i <= n)) ? 0 : INT_MAX;
      rj[r] = 0;
    }

    int t_next = tT[b];
    int up_next = hrow[b];
    int f_next = AFFINE ? frow[b] : 0;
    for (int j = 0; j < m; ++j) {
      const int tc = PROFILE ? min(t_next, pad) : t_next;
      const bool col = PIN ? (j + 1 == lt) : (j < lt);  // column tracked
      int up = up_next;  // H[i0][j + 1], then each row's fresh H
      int f = f_next;    // F[i0][j + 1], then each row's F
      if (j + 1 < m) {
        const size_t o = (j + 1) * sB + b;
        t_next = tT[o];
        up_next = hrow[o];
        if (AFFINE) f_next = frow[o];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int s = PROFILE ? tab[qc[r] + tc] : (qc[r] == tc ? m_r[r] : sc.mismatch);
        int h;
        if (AFFINE) {
          f = max(f - ge, up - go);
          el[r] = max(el[r] - ge, hl[r] - go);
          h = max(dg[r] + s, max(el[r], f));
        } else {
          h = max(dg[r] + s, max(up, hl[r]) - go);
        }
        dg[r] = up;  // H[i - 1][j] is the diagonal of cell (i, j + 1)
        hl[r] = h;
        up = h;      // and H[i][j] is the cell above (i + 1, j)
        if (PIN) {
          if (col) rb[r] = h;
        } else if (col && h > rb[r]) {
          rb[r] = h;
          rj[r] = j + 1;
        }
      }
      hrow[j * sB + b] = up;
      if (AFFINE) frow[j * sB + b] = f;
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (PIN) {
        if (i0 + r + 1 == pin_row) best = rb[r];
      } else if (rj[r] != 0 && rb[r] > best) {
        best = rb[r];
        bi = i0 + r + 1;
        bj = rj[r];
      }
    }
  }

  score[b] = best;
  end_i[b] = bi;
  end_j[b] = bj;
}

template <bool AFFINE, bool PROFILE, bool PIN>
void launch(const void* qT, const void* tT, const void* table, const void* lens_q,
            const void* lens_t, void* hrow, void* frow, void* score, void* end_i,
            void* end_j, int B, int n, int m, Scoring sc, cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  sw_semiglobal_kernel<AFFINE, PROFILE, PIN><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(qT), static_cast<const uint8_t*>(tT),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens_q),
      static_cast<const int32_t*>(lens_t), static_cast<int32_t*>(hrow),
      static_cast<int32_t*>(frow), static_cast<int32_t*>(score),
      static_cast<int32_t*>(end_i), static_cast<int32_t*>(end_j), B, n, m, sc);
}

template <bool AFFINE, bool PROFILE>
void launch_pin(int pin, const void* qT, const void* tT, const void* table,
                const void* lens_q, const void* lens_t, void* hrow, void* frow,
                void* score, void* end_i, void* end_j, int B, int n, int m,
                Scoring sc, cudaStream_t s) {
  if (pin)
    launch<AFFINE, PROFILE, true>(qT, tT, table, lens_q, lens_t, hrow, frow, score,
                                  end_i, end_j, B, n, m, sc, s);
  else
    launch<AFFINE, PROFILE, false>(qT, tT, table, lens_q, lens_t, hrow, frow, score,
                                   end_i, end_j, B, n, m, sc, s);
}

}  // namespace

extern "C" {

// Launches one of the eight instantiations on `stream` and returns
// cudaGetLastError() (a refused launch never runs, and a later synchronise
// would not report it); cudaErrorInvalidValue for a profile table stride
// outside 1..32. Pointers: qT [n, B] uint8, tT [m, B] uint8, table
// [stride, stride] int32 (profile only), lens_q / lens_t [B] int32 or
// null for the full widths, hrow [m, B] int32, frow [m, B] int32 (affine
// only), score / end_i / end_j [B] int32. All on one device, all
// contiguous; the wrapper checks that. `mismatch` is the score of a
// mismatch (negative for a penalty); linear kernels use gap_open as the
// gap.
int swtpu_sw_semiglobal(int affine, int profile, int pin, const void* qT,
                        const void* tT, const void* table, const void* lens_q,
                        const void* lens_t, void* hrow, void* frow, void* score,
                        void* end_i, void* end_j, int B, int n, int m, int match,
                        int mismatch, int stride, int gap_open, int gap_extend,
                        void* stream) {
  if (profile && (stride < 1 || stride > MAX_STRIDE))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const Scoring sc{match, mismatch, stride, gap_open, gap_extend};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine) {
    if (profile)
      launch_pin<true, true>(pin, qT, tT, table, lens_q, lens_t, hrow, frow, score,
                             end_i, end_j, B, n, m, sc, s);
    else
      launch_pin<true, false>(pin, qT, tT, table, lens_q, lens_t, hrow, frow, score,
                              end_i, end_j, B, n, m, sc, s);
  } else {
    if (profile)
      launch_pin<false, true>(pin, qT, tT, table, lens_q, lens_t, hrow, frow, score,
                              end_i, end_j, B, n, m, sc, s);
    else
      launch_pin<false, false>(pin, qT, tT, table, lens_q, lens_t, hrow, frow, score,
                               end_i, end_j, B, n, m, sc, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
