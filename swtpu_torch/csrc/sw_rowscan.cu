// Batched Smith-Waterman row-scan for Hopper (sm_90a): local alignment
// scores and endpoints, linear or affine (Gotoh) gaps, uniform scoring.
//
// Replaces the four TPU kernels on the local-alignment main path:
//   <false, END_SCORE, W>       swtpu/kernels/pallas/sw_batch.py   _kernel       (pallas_call :317)
//   <false, END_KEY | SELECT>   swtpu/kernels/pallas/sw_batch.py   _kernel_ends  (pallas_call :215)
//   <true,  END_SCORE, W>       swtpu/kernels/pallas/sw_affine.py  _kernel       (pallas_call :145)
//   <true,  END_KEY | SELECT>   swtpu/kernels/pallas/sw_affine.py  _kernel with rowbits (pallas_call :175)
//
// Design: the skewed register tile of csrc/sw_local_tile.cuh (its head
// note has the schedule, the cell, the pad rule and the trackers), a
// thread per pair on the caller's [B, n] / [B, m] codes (the wrappers
// transpose nothing), ROWS = 16 query rows a sweep, an [m, B] int32
// hand-off scratch ([m, B, 2] affine) read and written once a sweep. The
// earlier kernel (8 rows a column, a chain of 8 dependent cells a step, an
// [m, B] scratch every 8 rows, [n, B] / [m, B] transposes made by the
// wrapper) is replaced. Scores: any code >= alpha on either side is a
// pad and scores -2^20, internal pads included, so pads can only lose and
// the kernel is exact for every uniform scoring with gap > 0 (affine:
// gap_open, gap_extend > 0), mismatch >= 0 included: the narrow forms
// (WIDE = false) score a pad by a min, the WIDE forms (scores past
// local_tile::narrow) by a select. Endpoints: END_KEY where
// local_tile::key_bits holds the scores, else END_SELECT.
//
// Bound, by pipe: a cell needs the uniform score 3 (compare, select, the
// pad's min), linear H 2 (the diagonal's add, a three-way max with the
// floor), Gotoh 4 (E, F, the add, the three-way max), D's subtract 1, and
// the score's best half a three-way max or the endpoint's key 2 (its IMAD
// and a max). Compares, selects, maxes and DPX issue on the ALU pipe (64
// lanes an SM a clock); the adds, the subtract and the key's multiply-add
// can issue as IMADs on the FMA pipe, and an SM issues 128 lanes a clock in
// all. chip_smoke.py bounds each form by the larger of its ALU ops / 64
// and all its ops / 128 (6.5 / 8 / 8.5 / 10 ops, 4.5 / 5 / 6.5 / 7 on the
// ALU: linear scores / ends, Gotoh scores / ends), and prints the
// instructions a cell as compiled; the inputs are 2 bytes a pair-residue.

#include "sw_local_tile.cuh"

namespace {

using local_tile::END_KEY;
using local_tile::END_SCORE;
using local_tile::END_SELECT;
using local_tile::ROWS;

constexpr int THREADS = 128;

template <bool AFFINE, int END, bool WIDE>
__global__ void __launch_bounds__(THREADS)
sw_rowscan_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  int32_t* __restrict__ scratch, int32_t* __restrict__ score,
                  int32_t* __restrict__ end_i, int32_t* __restrict__ end_j, int B, int n,
                  int m, local_tile::Scoring sc, bool vec) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int best, bi, bj;
  local_tile::local_pair<AFFINE, false, WIDE, END>(
      q + b * static_cast<size_t>(n), t + b * static_cast<size_t>(m), scratch, b, n, m,
      static_cast<ptrdiff_t>(B) * (AFFINE ? 2 : 1), sc, vec, 0u, best, bi, bj);
  score[b] = best;
  if (END != END_SCORE) {
    end_i[b] = bi;
    end_j[b] = bj;
  }
}

template <bool AFFINE>
void launch(int end, bool wide, const void* q, const void* t, void* scratch, void* score,
            void* end_i, void* end_j, int B, int n, int m, const local_tile::Scoring& sc,
            bool vec, cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  auto* kernel = end == END_KEY ? sw_rowscan_kernel<AFFINE, END_KEY, false>
                 : end == END_SELECT
                     ? (wide ? sw_rowscan_kernel<AFFINE, END_SELECT, true>
                             : sw_rowscan_kernel<AFFINE, END_SELECT, false>)
                     : (wide ? sw_rowscan_kernel<AFFINE, END_SCORE, true>
                             : sw_rowscan_kernel<AFFINE, END_SCORE, false>);
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(score),
      static_cast<int32_t*>(end_i), static_cast<int32_t*>(end_j), B, n, m, sc, vec);
}

}  // namespace

extern "C" {

// The query rows a sweep (the wrapper needs the scratch past one sweep).
int swtpu_sw_rowscan_rows() { return ROWS; }

// The form a launch of these sizes and scores runs: END * 2 + WIDE, END 0
// the score, 1 the endpoint with its packed key, 2 the endpoint with
// (best, step) apart (`select` forces it where the key would hold).
int swtpu_sw_rowscan_form(int ends, int select, int n, int m, int match, int mismatch,
                          int gap_open, int gap_extend) {
  const bool wide = !local_tile::narrow(match, mismatch, gap_open);
  int end = END_SCORE;
  if (ends)
    end = !select && !wide &&
                  local_tile::key_bits(false, n, m, match, mismatch, gap_open, gap_extend) >= 0
              ? END_KEY
              : END_SELECT;
  return end * 2 + wide;
}

// Launches one of the instantiations on `stream` and returns
// cudaGetLastError() (a refused launch never runs, and a later synchronise
// would not report it); cudaErrorInvalidValue for a missing scratch past
// one sweep. Pointers: q [B, n] uint8, t [B, m] uint8, scratch [m, B]
// int32 (linear: H - gap) or [m, B, 2] int32 (affine: H - gap_open, F),
// unused (null) when n <= ROWS or m == 0, score [B] int32, end_i / end_j
// [B] int32 (ends only). All on one device, all contiguous; the wrapper
// checks that. `mismatch` is the score of a mismatch; linear kernels use
// gap_open as the gap. `select`: the endpoint with (best, step) apart
// even where the key would hold (timed beside it by chip_smoke.py).
int swtpu_sw_rowscan(int affine, int ends, int select, const void* q, const void* t,
                     void* scratch, void* score, void* end_i, void* end_j, int B, int n,
                     int m, int alpha, int match, int mismatch, int gap_open, int gap_extend,
                     void* stream) {
  if (n > ROWS && m > 0 && !scratch) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int form =
      swtpu_sw_rowscan_form(ends, select, n, m, match, mismatch, gap_open, gap_extend);
  const int end = form / 2;
  const bool wide = form % 2;
  const int kb = end == END_KEY
                     ? local_tile::key_bits(false, n, m, match, mismatch, gap_open, gap_extend)
                     : 0;
  const local_tile::Scoring sc{alpha,
                               match + gap_open,
                               mismatch + gap_open,
                               local_tile::PAD_SCORE + gap_open,
                               0,
                               gap_open,
                               gap_extend,
                               kb,
                               1 << kb};
  // whole 32-bit code words: every target row 4-byte aligned
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine)
    launch<true>(end, wide, q, t, scratch, score, end_i, end_j, B, n, m, sc, vec, s);
  else
    launch<false>(end, wide, q, t, scratch, score, end_i, end_j, B, n, m, sc, vec, s);
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
