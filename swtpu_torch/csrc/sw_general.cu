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
// (gap > 0, entries in [-127, 127]); this source takes the rest, in two
// forms that kernels/sw_general.py::general_form picks by the gaps' signs.
//
// Contract: the plain tier's, cell for cell (kernels/sw_scan.py,
// kernels/affine_scan.py). Its DP runs over anti-diagonals d = 2..n+m of
// slots i = 0..n (row i, column j = d - i), and never masks a cell: the
// boundary row 0 scores the query pad, columns outside 1..m the target
// pad, both -2^20 in the extended table, and diagonals 0 and 1 start at H
// = 0 (E = F = -2^29, Gotoh). Above row 0 the tier's shift fills a
// diagonal's slot -1 with 0 (linear: H) or -2^29 (Gotoh: H, F). The score
// is the max over every cell of diagonals 2..n+m; the endpoint the first
// maximum in row-major order over the same cells (the tier's per-diagonal
// rule reaches the same cell), (0, 0) for score 0.
//
// The tile form (sw_general_tile_kernel<AFFINE, END>), where no gap
// penalty is negative (linear gap >= 0, Gotoh gap_open, gap_extend >= 0):
// there the cells outside the matrix change neither the score nor the
// endpoint. Row 0 and the region left of the matrix hold what a zero
// boundary holds (H = 0; E and F of a real cell's first gap come out at
// -gap_open, as from -inf), and the region right of it only copies real
// values down and right (a pad diagonal never wins), each at most a real
// value met earlier in row-major order, which it loses the tie to. So the
// function is the standard local DP on the n x m real cells, and the
// kernel is the skewed register tile of csrc/sw_local_tile.cuh (its head
// note has the schedule, the cell and the trackers) with PROFILE scores,
// the profile thread form's instantiation shape (csrc/sw_profile.cu): a
// thread per pair on the caller's [B, n] / [B, m] codes, 16 query rows a
// sweep, skewed, masks only in a sweep's opening and closing steps or for
// targets shorter than 16, target codes four a load, an [m, B] ([m, B, 2]
// Gotoh) hand-off scratch between sweeps, DPX cells on D = H - gap_open.
// Each cell's score is one lookup in the tier's extended table, held in
// dynamic shared memory as a lane table (the alphabet + 1 codes, the last
// a pad; each entry 32 times, word 32 x entry + lane, gap_open folded in;
// 80 KB for 24 letters, up to 123 KB for 30). The lane table has no
// min-cap rule, so entries past +-127 cost nothing but the endpoint key's
// range: END_KEY where local_tile::key_bits holds the pair's scores with
// |entry| at the matrix's own largest, else END_SELECT. The fold D = H -
// go and the 0 floor are exact at go = 0 and ge = 0 (D = H, E = max(E, D)).
//
// The sweep form (sw_general_kernel<AFFINE, ENDS>), for a negative gap
// penalty: there the boundary row and the cells outside the target's
// columns grow (a cell of the left region holds -gap (d - 1)) and reach
// the real cells, so the kernel computes every cell of the tier: a thread
// per pair, strips of ROWS = 16 rows, their H and E (Gotoh) in registers,
// swept column by column over the strip's diagonals 2 - (i0 + 15) .. n +
// m - i0 (cells of diagonals 0 and 1 and below read as the start values);
// the strip's last row (H, F) goes to an int2 [2n + m + 1, B] scratch for
// the next strip; the extended table in shared memory (stride 8 or 32),
// one lookup a cell. The endpoint is tracked on H itself, by (value, row)
// with a strict test, so any int32 score range the tier keeps is exact.
//
// Bound: the function needs the n x m real cells a pair, 7 (linear
// scores) to 14 (Gotoh ends) int32 ops each (chip_smoke.py general_ops)
// and a lookup. The tile form computes exactly those cells, its issue
// slots as the profile thread form's (by pipe, ALU_OPS). The sweep form
// sweeps the tier's (n + 1)(n + m - 1) cells instead (129 x 255 against
// 16,384 at n = m = 128), each with its diagonal mask and range test: the
// price of its one schedule for every gap sign.

#include "sw_local_tile.cuh"

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

using local_tile::END_KEY;
using local_tile::END_SCORE;
using local_tile::END_SELECT;

template <bool AFFINE, int END>
__global__ void __launch_bounds__(THREADS)
sw_general_tile_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                       const int32_t* __restrict__ table, int32_t* __restrict__ scratch,
                       int32_t* __restrict__ score, int32_t* __restrict__ end_i,
                       int32_t* __restrict__ end_j, int B, int n, int m, int stride,
                       local_tile::Scoring sc, bool vec) {
  local_tile::profile_pairs<AFFINE, END, THREADS>(q, t, table, scratch, score, end_i, end_j,
                                                  B, n, m, stride, sc, vec);
}

// the tile form's tracker: the score, or the endpoint in one key where
// key_bits holds scores of magnitude `mag` (the matrix's largest |entry|)
int tile_form(int ends, int select, int n, int m, int mag, int go, int ge) {
  if (!ends) return END_SCORE;
  return !select && local_tile::key_bits(false, n, m, mag, mag, go, ge) >= 0 ? END_KEY
                                                                             : END_SELECT;
}

template <bool AFFINE>
void launch_tile(int end, const void* q, const void* t, const void* table, void* scratch,
                 void* score, void* end_i, void* end_j, int B, int n, int m, int stride,
                 const local_tile::Scoring& sc, bool vec, cudaStream_t stream) {
  local_tile::launch_profile_pairs<THREADS>(
      end == END_KEY      ? sw_general_tile_kernel<AFFINE, END_KEY>
      : end == END_SELECT ? sw_general_tile_kernel<AFFINE, END_SELECT>
                          : sw_general_tile_kernel<AFFINE, END_SCORE>,
      q, t, table, scratch, score, end_i, end_j, B, n, m, stride, sc, vec, stream);
}

}  // namespace

extern "C" {

// Rows a strip: a batch with n + 1 > ROWS needs the scratch.
int swtpu_sw_general_rows() { return ROWS; }

// The sweep form: launches sw_general_kernel<affine, ends> on `stream` and returns
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

// The tile form's tracker for a launch of these sizes and gaps (0 the
// score, 1 the endpoint with its packed key, 2 with (best, step) apart;
// `select` forces 2), `mag` the matrix's largest |entry|.
int swtpu_sw_general_tile_form(int ends, int select, int n, int m, int mag, int gap_open,
                               int gap_extend) {
  return tile_form(ends, select, n, m, mag, gap_open, gap_extend);
}

// The tile form's query rows a sweep (the wrapper needs the scratch past
// one sweep).
int swtpu_sw_general_tile_rows() { return local_tile::ROWS; }

// Launches sw_general_tile_kernel<affine, tracker> on `stream` and returns
// cudaGetLastError(); cudaErrorInvalidValue for a table stride outside
// 1..32, codes outside 1..stride (the lane table's codes, the last a pad:
// the alphabet + 1), a negative gap penalty (the sweep form's scorings) or
// a missing scratch past one sweep. q [B, n] / t [B, m] uint8 codes, table
// [stride, stride] int32 (kernels/sw_scan.py::_extended_table), scratch
// [m, B] int32 (linear: H - gap) or [m, B, 2] (Gotoh: H - gap_open, F),
// null when n <= ROWS or m == 0, score / end_i / end_j [B] int32 (the ends
// null for scores only). Linear kernels use gap_open as the gap. All on
// one device, contiguous.
int swtpu_sw_general_tile(int affine, int ends, int select, const void* q, const void* t,
                          const void* table, void* scratch, void* score, void* end_i,
                          void* end_j, int B, int n, int m, int stride, int codes, int mag,
                          int gap_open, int gap_extend, void* stream) {
  if (stride < 1 || stride > MAX_STRIDE || codes < 1 || codes > stride || gap_open < 0 ||
      gap_extend < 0 || (n > local_tile::ROWS && m > 0 && !scratch) ||
      (ends && (!end_i || !end_j)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int end = tile_form(ends, select, n, m, mag, gap_open, gap_extend);
  const int kb =
      end == END_KEY ? local_tile::key_bits(false, n, m, mag, mag, gap_open, gap_extend) : 0;
  const local_tile::Scoring sc{0, 0, 0, 0, codes - 1, gap_open, gap_extend, kb, 1 << kb};
  // whole 32-bit code words: every target row 4-byte aligned
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine)
    launch_tile<true>(end, q, t, table, scratch, score, end_i, end_j, B, n, m, stride, sc,
                      vec, s);
  else
    launch_tile<false>(end, q, t, table, scratch, score, end_i, end_j, B, n, m, stride, sc,
                       vec, s);
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
