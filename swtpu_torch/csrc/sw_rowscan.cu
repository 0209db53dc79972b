// Batched Smith-Waterman row-scan for Hopper (sm_90a): local alignment
// scores and endpoints, linear or affine (Gotoh) gaps, uniform scoring.
//
// Replaces the four TPU kernels on the local-alignment main path:
//   <false,false>  swtpu/kernels/pallas/sw_batch.py   _kernel       (pallas_call :317)
//   <false,true >  swtpu/kernels/pallas/sw_batch.py   _kernel_ends  (pallas_call :215)
//   <true, false>  swtpu/kernels/pallas/sw_affine.py  _kernel       (pallas_call :145)
//   <true, true >  swtpu/kernels/pallas/sw_affine.py  _kernel with rowbits (pallas_call :175)
//
// Design. One thread per pair: the batch is the parallel axis, as in the
// TPU kernels, here spread over 32-thread warps. The wrapper hands the
// codes over transposed ([n, B] and [m, B] uint8), so the 32 threads of a
// warp read 32 neighbouring bytes. Rows go outer and columns inner. ROWS
// query rows advance together through each column: row r + 1 takes row
// r's fresh H from a register, so the previous-row buffer (H, and F for
// affine: [m, B] int32 scratch allocated by the wrapper, 16 MB / 32 MB at
// 32768 pairs, which stays in the 50 MB L2) is read and written once per
// ROWS rows instead of once per row. The left H and E of every row live
// in registers. Each thread's next column is loaded one step ahead.
//
// Scores: s = match where q == t, else mismatch; any code >= alpha is a
// pad and scores -2^20 (the plain tier's convention), so pads can only
// lose and the kernel is exact for every uniform scoring with gap > 0
// (affine: gap_open, gap_extend > 0), mismatch >= 0 included. Rows past
// n in the last group are phantom pad rows: they come after every real
// row, so they can neither feed nor beat one.
//
// Endpoints: every row keeps its own (best, column), updated on a
// strictly greater H while columns ascend; after each group the rows are
// folded in order into the thread's (best, i, j), again on strictly
// greater. That is the first maximum in row-major order, the oracle's
// np.argmax rule; score 0 leaves (0, 0). Values and rows are kept apart,
// so the int32 overflow guard of the TPU kernels' packed (value, row)
// comb (sw_batch.py:290, sw_affine.py:231) does not apply here.
//
// Bound: the work is int32 max-plus arithmetic with no reuse across
// pairs, so the card's INT32 issue rate bounds it (132 SMs x 64 lanes x
// SM clock), not memory: the inputs are 2 bytes per pair-residue. As
// written a cell costs 9 ops (linear scores), 11 (linear ends), 14
// (affine scores) and 16 (affine ends); see chip_smoke.py. Later work:
// DPX (__viaddmax_s32), 16-bit packed _s16x2 tiers, and occupancy at
// small batch (one warp per 32 pairs leaves an SM thinly filled below
// about 2^17 pairs).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;
constexpr int THREADS = 128;
constexpr int PAD_SCORE = -(1 << 20);
constexpr int NEG_EF = -(1 << 29);

struct Scoring {
  int alpha;     // alphabet size: codes >= alpha are pads
  int match;
  int mismatch;
  int gap_open;  // linear kernels use gap_open as the gap
  int gap_extend;
};

template <bool AFFINE, bool ENDS>
__global__ void __launch_bounds__(THREADS)
sw_rowscan_kernel(const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
                  int32_t* __restrict__ hrow, int32_t* __restrict__ frow,
                  int32_t* __restrict__ score, int32_t* __restrict__ end_i,
                  int32_t* __restrict__ end_j, int B, int n, int m, Scoring sc) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int go = sc.gap_open;
  const int ge = sc.gap_extend;

  // row 0: H = 0, F = -inf
  for (int j = 0; j < m; ++j) {
    hrow[j * sB + b] = 0;
    if (AFFINE) frow[j * sB + b] = NEG_EF;
  }

  int best = 0, bi = 0, bj = 0;
  for (int i0 = 0; i0 < n && m > 0; i0 += ROWS) {
    int m_r[ROWS], x_r[ROWS], qc[ROWS];  // per-row match/mismatch score, code
    int hl[ROWS], dg[ROWS], el[ROWS];    // left H, diagonal H, left E
    int rb[ROWS], rj[ROWS];              // per-row best and its column
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int c = (i0 + r < n) ? qT[(i0 + r) * sB + b] : sc.alpha;
      const bool pad = c >= sc.alpha;
      qc[r] = c;
      m_r[r] = pad ? PAD_SCORE : sc.match;
      x_r[r] = pad ? PAD_SCORE : sc.mismatch;
      hl[r] = 0;
      dg[r] = 0;
      el[r] = NEG_EF;
      rb[r] = 0;
      rj[r] = 0;
    }

    int t_next = tT[b];
    int up_next = hrow[b];
    int f_next = AFFINE ? frow[b] : 0;
    for (int j = 0; j < m; ++j) {
      const int tc = t_next;
      int up = up_next;  // H[i0 - 1][j + 1], then each row's fresh H
      int f = f_next;    // F[i0 - 1][j + 1], then each row's F
      if (j + 1 < m) {
        const size_t o = (j + 1) * sB + b;
        t_next = tT[o];
        up_next = hrow[o];
        if (AFFINE) f_next = frow[o];
      }
      const bool tpad = tc >= sc.alpha;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        int s = (qc[r] == tc) ? m_r[r] : x_r[r];
        s = tpad ? PAD_SCORE : s;
        int h;
        if (AFFINE) {
          f = max(f - ge, up - go);
          el[r] = max(el[r] - ge, hl[r] - go);
          h = max(max(dg[r] + s, 0), max(el[r], f));
        } else {
          h = max(max(dg[r] + s, 0), max(up, hl[r]) - go);
        }
        dg[r] = up;  // H[i - 1][j] is the diagonal of cell (i, j + 1)
        hl[r] = h;
        up = h;      // and H[i][j] is the cell above (i + 1, j)
        if (ENDS) {
          if (h > rb[r]) {
            rb[r] = h;
            rj[r] = j + 1;
          }
        } else {
          best = max(best, h);
        }
      }
      hrow[j * sB + b] = up;
      if (AFFINE) frow[j * sB + b] = f;
    }

    if (ENDS) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (rb[r] > best) {
          best = rb[r];
          bi = i0 + r + 1;
          bj = rj[r];
        }
      }
    }
  }

  score[b] = best;
  if (ENDS) {
    end_i[b] = bi;
    end_j[b] = bj;
  }
}

template <bool AFFINE, bool ENDS>
void launch(const void* qT, const void* tT, void* hrow, void* frow, void* score,
            void* end_i, void* end_j, int B, int n, int m, Scoring sc,
            cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  sw_rowscan_kernel<AFFINE, ENDS><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(qT), static_cast<const uint8_t*>(tT),
      static_cast<int32_t*>(hrow), static_cast<int32_t*>(frow),
      static_cast<int32_t*>(score), static_cast<int32_t*>(end_i),
      static_cast<int32_t*>(end_j), B, n, m, sc);
}

}  // namespace

extern "C" {

// Launches one of the four instantiations on `stream` and returns
// cudaGetLastError(): a refused launch never runs, and a later
// synchronise would not report it. Pointers: qT [n, B] uint8, tT [m, B]
// uint8, hrow [m, B] int32, frow [m, B] int32 (affine only), score /
// end_i / end_j [B] int32 (end_* for ends only). All on one device, all
// contiguous; the wrapper checks that.
int swtpu_sw_rowscan(int affine, int ends, const void* qT, const void* tT,
                     void* hrow, void* frow, void* score, void* end_i,
                     void* end_j, int B, int n, int m, int alpha, int match,
                     int mismatch, int gap_open, int gap_extend, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const Scoring sc{alpha, match, mismatch, gap_open, gap_extend};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine) {
    if (ends)
      launch<true, true>(qT, tT, hrow, frow, score, end_i, end_j, B, n, m, sc, s);
    else
      launch<true, false>(qT, tT, hrow, frow, score, end_i, end_j, B, n, m, sc, s);
  } else {
    if (ends)
      launch<false, true>(qT, tT, hrow, frow, score, end_i, end_j, B, n, m, sc, s);
    else
      launch<false, false>(qT, tT, hrow, frow, score, end_i, end_j, B, n, m, sc, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
