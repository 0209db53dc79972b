// Batched local alignment (Smith-Waterman) scores and endpoints for Hopper
// (sm_90a) under any scoring the plain anti-diagonal tier takes: gaps of
// any sign (linear, or Gotoh with a constant or negative extension), any
// int32 matrix entries, up to 30 letters.
//
// Counterpart of JAX's XLA tier, which its TPU dispatch runs wherever the
// Pallas kernels' guards refuse a scoring (swtpu/ops/variants.py
// best_engine / best_ends_engine):
//   linear  swtpu/kernels/xla/sw_scan.py      sw_batch_diag (:126), _ends (:190)
//   Gotoh   swtpu/kernels/xla/affine_scan.py  sw_affine_batch_diag (:131), _ends (:113)
// On the card the row-scan and profile kernels keep every scoring they take
// (gap > 0, entries in [-127, 127]); this kernel takes the rest.
//
// Contract: the plain tier's, cell for cell (kernels/sw_scan.py,
// kernels/affine_scan.py). Its DP runs over anti-diagonals d = 2..n+m of
// slots i = 0..n (row i, column j = d - i), and never masks a cell: the
// boundary row 0 scores the query pad, columns outside 1..m the target
// pad, both -2^20 in the extended table, and diagonals 0 and 1 start at H
// = 0 (E = F = -2^29, Gotoh). With gap > 0 those cells never win; with gap
// <= 0 they grow (a cell of the left region holds -gap (d - 1)) and reach
// the real cells, so the kernel computes every one of them. Above row 0
// the tier's shift fills a diagonal's slot -1 with 0 (linear: H) or -2^29
// (Gotoh: H, F). The score is the max over every cell of diagonals 2..n+m;
// the endpoint the first maximum in row-major order over the same cells
// (the tier's per-diagonal rule reaches the same cell), (0, 0) for score 0.
// Rows past n and diagonals past n + m exist only in the kernel's strips:
// they feed no cell of the tier and are tracked by nothing.
//
// Design (sw_general_kernel<AFFINE, ENDS>): a thread per pair; strips of
// ROWS = 16 rows, their H and E (Gotoh) in registers, swept column by
// column over the strip's diagonals 2 - (i0 + 15) .. n + m - i0 (cells of
// diagonals 0 and 1 and below read as the start values); the strip's last
// row (H, F) goes to an int2 [2n + m + 1, B] scratch for the next strip;
// the extended table in shared memory (stride 8 or 32), one lookup a cell,
// the target code one byte load a column, the query codes one a row a
// strip. No key packing, no folded offsets: the endpoint is tracked on H
// itself, by (value, row) with a strict test, so any int32 score range
// the tier keeps exact is exact here.
//
// Bound: the function needs the n x m real cells a pair, 7 (linear
// scores) to 14 (Gotoh ends) int32 ops each (chip_smoke.py general_ops).
// The kernel sweeps the tier's (n + 1)(n + m - 1) cells instead (129 x 255
// against 16,384 at n = m = 128), each with its diagonal mask and range
// test beside those ops: the price of one schedule for every gap sign.
// Where no gap penalty is negative those cells change neither the score
// nor the endpoint (row 0 and the region left of the matrix keep a zero
// or standard boundary's values; the region right of it only copies real
// values, which lose ties to them), so later work can skip them there:
// the skewed tile of sw_local_tile.cuh with the masks hoisted out of the
// middle columns, over the real cells alone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;     // rows a strip, in registers
constexpr int THREADS = 128;
constexpr int MAX_STRIDE = 32;
constexpr int NEG_EF = -(1 << 29);  // the Gotoh tier's minus infinity

struct Args {
  const uint8_t* q;       // [B, n] codes
  const uint8_t* t;       // [B, m] codes
  const int32_t* table;   // [stride, stride] the extended table
  int2* scratch;          // [2n + m + 1, B] (H, F) of a strip's last row, or null
  int32_t* score;         // [B]
  int32_t* end_i;         // [B] or null (scores only)
  int32_t* end_j;         // [B] or null
  int B, n, m, stride, gap, go, ge;
};

template <bool AFFINE, bool ENDS>
__global__ void __launch_bounds__(THREADS) sw_general_kernel(Args a) {
  __shared__ int32_t tab[MAX_STRIDE * MAX_STRIDE];
  const int stride = a.stride;
  for (int e = threadIdx.x; e < stride * stride; e += THREADS) tab[e] = a.table[e];
  __syncthreads();
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.B) return;
  const int n = a.n, m = a.m, D = n + m;
  const int qpad = stride - 2, tpad = stride - 1;
  const uint8_t* qrow = a.q + static_cast<size_t>(b) * n;
  const uint8_t* trow = a.t + static_cast<size_t>(b) * m;
  const size_t sB = static_cast<size_t>(a.B);
  // row -1 (the tier's shift fill) and the start values of diagonals <= 1
  const int fill = AFFINE ? NEG_EF : 0;

  int best = 0, bi = 0, bj = 0;
  for (int i0 = 0; i0 <= n; i0 += ROWS) {
    int qo[ROWS], hl[ROWS], el[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r;
      const int c = (i >= 1 && i <= n) ? min(static_cast<int>(qrow[i - 1]), qpad) : qpad;
      qo[r] = c * stride;
      hl[r] = 0;
      el[r] = NEG_EF;
    }
    const int jmin = 2 - (i0 + ROWS - 1), jmax = D - i0;
    const bool more = i0 + ROWS <= n;  // a strip below reads this one's last row
    // the row above at column j: the fill above row 0, the start values on
    // diagonals <= 1, else the scratch
    auto up = [&](int j, int& h, int& f) {
      if (i0 == 0) {
        h = fill;
        f = NEG_EF;
      } else if (i0 - 1 + j <= 1) {
        h = 0;
        f = NEG_EF;
      } else {
        const int2 v = a.scratch[static_cast<size_t>(j + n) * sB + b];
        h = v.x;
        f = v.y;
      }
    };
    int hdg, fdg;
    up(jmin - 1, hdg, fdg);
    for (int j = jmin; j <= jmax; ++j) {
      const int tc = (j >= 1 && j <= m) ? min(static_cast<int>(trow[j - 1]), tpad) : tpad;
      int hu, fu;
      up(j, hu, fu);
      int hd = hdg;  // the row above, column j - 1
      hdg = hu;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = i0 + r, d = i + j;
        const int s = tab[qo[r] + tc];
        int h, e = NEG_EF, f = NEG_EF;
        if (AFFINE) {
          e = max(el[r] - a.ge, hl[r] - a.go);
          f = max(fu - a.ge, hu - a.go);
          h = max(max(hd + s, 0), max(e, f));
        } else {
          h = max(max(hd + s, hu - a.gap), max(hl[r] - a.gap, 0));
        }
        if (d < 2) {  // diagonals 0 and 1 (and the cells before them)
          h = 0;
          e = NEG_EF;
          f = NEG_EF;
        }
        const bool tracked = d >= 2 && d <= D && i <= n;
        if (ENDS) {
          if (tracked && (h > best || (h == best && i < bi))) {
            best = h;
            bi = i;
            bj = j;
          }
        } else if (tracked) {
          best = max(best, h);
        }
        hd = hl[r];
        hl[r] = h;
        el[r] = e;
        hu = h;
        fu = f;
      }
      if (more) a.scratch[static_cast<size_t>(j + n) * sB + b] = make_int2(hu, fu);
    }
  }
  a.score[b] = best;
  if (ENDS) {
    a.end_i[b] = best > 0 ? bi : 0;
    a.end_j[b] = best > 0 ? bj : 0;
  }
}

template <bool AFFINE>
void launch(bool ends, const Args& a, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((a.B + THREADS - 1) / THREADS);
  if (ends)
    sw_general_kernel<AFFINE, true><<<grid, THREADS, 0, s>>>(a);
  else
    sw_general_kernel<AFFINE, false><<<grid, THREADS, 0, s>>>(a);
}

}  // namespace

extern "C" {

// Rows a strip: a batch with n + 1 > ROWS needs the scratch.
int swtpu_sw_general_rows() { return ROWS; }

// Launches sw_general_kernel<affine, ends> on `stream` and returns
// cudaGetLastError(); cudaErrorInvalidValue for a table stride outside
// 2..32 or a missing scratch. q [B, n] / t [B, m] uint8 codes, table
// [stride, stride] int32 (kernels/sw_scan.py::_extended_table), scratch
// int32 [2n + m + 1, B, 2] when n + 1 > ROWS (else null), score / end_i /
// end_j [B] int32 (the ends null for scores only). Linear scoring uses
// `gap`, Gotoh gap_open / gap_extend. All on one device, contiguous.
int swtpu_sw_general(int affine, int ends, const void* q, const void* t, const void* table,
                     void* scratch, void* score, void* end_i, void* end_j, int B, int n,
                     int m, int stride, int gap, int gap_open, int gap_extend,
                     void* stream) {
  if (stride < 2 || stride > MAX_STRIDE || (n + 1 > ROWS && !scratch) ||
      (ends && (!end_i || !end_j)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
               static_cast<const int32_t*>(table), static_cast<int2*>(scratch),
               static_cast<int32_t*>(score), static_cast<int32_t*>(end_i),
               static_cast<int32_t*>(end_j), B, n, m, stride, gap, gap_open, gap_extend};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine)
    launch<true>(ends != 0, a, s);
  else
    launch<false>(ends != 0, a, s);
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
