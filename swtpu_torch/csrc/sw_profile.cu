// Batched Smith-Waterman row-scan under a general substitution matrix for
// Hopper (sm_90a): local alignment scores and endpoints, linear or affine
// (Gotoh) gaps, any alphabet of up to 30 letters (4x4 DNA matrices,
// protein with BLOSUM62).
//
// Replaces the packed-profile TPU kernel, in its four forms:
//   <false,false>  swtpu/kernels/pallas/sw_profile.py  _kernel, linear  (pallas_call :287)
//   <false,true >  same, linear, with rowbits (ends)                   (pallas_call :353)
//   <true, false>  same, affine                                        (pallas_call :287)
//   <true, true >  same, affine, with rowbits (ends)                   (pallas_call :353)
//
// Design. The skeleton of csrc/sw_rowscan.cu: one thread per pair over
// [n, B] / [m, B] uint8 codes, rows outer, ROWS query rows per sweep with
// the left H and E in registers, an [m, B] int32 previous-row scratch (H,
// and F for affine) read and written once per sweep, per-row strict-'>'
// endpoints folded in row order (the oracle's row-major-first argmax).
// Only the score differs: s = tab[q_i * stride + t_j], from the plain
// tier's extended table (kernels/sw_scan.py::_extended_table, stride 8
// for DNA-sized alphabets, 32 for protein) that each block copies into
// shared memory. Each row's offset q_i * stride is hoisted once per
// sweep, so a cell pays one add and one shared load for its score. The
// TPU kernel's query profile, int8 planes and select tree are TPU layout
// and are not carried over.
//
// Pads: every table entry past the alphabet is -2^20 (the plain tier's
// rule), so a pad on either side, internal ones included, can only lose.
// The TPU kernel scores pads at -128 instead, which differs on internal
// pads; the port follows its plain tier. Codes are clamped to stride - 1,
// a pad, on load (they arrive as uint8 up to 255). Phantom rows past n
// are pad rows and can neither feed nor beat a real row.
//
// Bound: int32 issue (132 SMs x 64 lanes x SM clock), as in the row-scan:
// as written a cell costs 7 int32 ops (linear scores), 9 (linear ends),
// 12 (affine scores) and 14 (affine ends), plus one shared-memory lookup
// (32 lanes per SM per clock, so it binds only past 2 lookups per 7
// ops). The lookup is not free of bank conflicts: with the protein
// table's row stride of 32 the bank is t mod 32, so lanes reading one t
// under different q collide (about 4 passes per warp-wide load on random
// protein, a numpy estimate). The fix is later work: a per-lane
// replicated table, or a register profile of each row's scores packed
// 4 x int8 with __byte_perm sign extension. The DNA table (stride 8)
// puts the 16 real (q, t) pairs on 16 distinct banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;
constexpr int THREADS = 128;
constexpr int MAX_STRIDE = 32;
constexpr int NEG_EF = -(1 << 29);

template <bool AFFINE, bool ENDS>
__global__ void __launch_bounds__(THREADS)
sw_profile_kernel(const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
                  const int32_t* __restrict__ table, int32_t* __restrict__ hrow,
                  int32_t* __restrict__ frow, int32_t* __restrict__ score,
                  int32_t* __restrict__ end_i, int32_t* __restrict__ end_j,
                  int B, int n, int m, int stride, int go, int ge) {
  __shared__ int32_t tab[MAX_STRIDE * MAX_STRIDE];
  for (int k = threadIdx.x; k < stride * stride; k += THREADS) tab[k] = table[k];
  __syncthreads();

  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int pad = stride - 1;  // a code past the alphabet: scores -2^20

  // row 0: H = 0, F = -inf
  for (int j = 0; j < m; ++j) {
    hrow[j * sB + b] = 0;
    if (AFFINE) frow[j * sB + b] = NEG_EF;
  }

  int best = 0, bi = 0, bj = 0;
  for (int i0 = 0; i0 < n && m > 0; i0 += ROWS) {
    int qo[ROWS];                       // row offset into the table
    int hl[ROWS], dg[ROWS], el[ROWS];   // left H, diagonal H, left E
    int rb[ROWS], rj[ROWS];             // per-row best and its column
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int c = (i0 + r < n) ? qT[(i0 + r) * sB + b] : pad;
      qo[r] = min(c, pad) * stride;
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
      const int tc = min(t_next, pad);
      int up = up_next;  // H[i0 - 1][j + 1], then each row's fresh H
      int f = f_next;    // F[i0 - 1][j + 1], then each row's F
      if (j + 1 < m) {
        const size_t o = (j + 1) * sB + b;
        t_next = tT[o];
        up_next = hrow[o];
        if (AFFINE) f_next = frow[o];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int s = tab[qo[r] + tc];
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
void launch(const void* qT, const void* tT, const void* table, void* hrow,
            void* frow, void* score, void* end_i, void* end_j, int B, int n,
            int m, int stride, int go, int ge, cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  sw_profile_kernel<AFFINE, ENDS><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(qT), static_cast<const uint8_t*>(tT),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(hrow),
      static_cast<int32_t*>(frow), static_cast<int32_t*>(score),
      static_cast<int32_t*>(end_i), static_cast<int32_t*>(end_j), B, n, m,
      stride, go, ge);
}

}  // namespace

extern "C" {

// Launches one of the four instantiations on `stream` and returns
// cudaGetLastError() (a refused launch never runs, and a later synchronise
// would not report it); cudaErrorInvalidValue for a table stride outside
// 1..32. Pointers: qT [n, B] uint8, tT [m, B] uint8, table [stride,
// stride] int32, hrow [m, B] int32, frow [m, B] int32 (affine only),
// score / end_i / end_j [B] int32 (end_* for ends only). All on one
// device, all contiguous; the wrapper checks that. Linear kernels use
// gap_open as the gap.
int swtpu_sw_profile(int affine, int ends, const void* qT, const void* tT,
                     const void* table, void* hrow, void* frow, void* score,
                     void* end_i, void* end_j, int B, int n, int m, int stride,
                     int gap_open, int gap_extend, void* stream) {
  if (stride < 1 || stride > MAX_STRIDE) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine) {
    if (ends)
      launch<true, true>(qT, tT, table, hrow, frow, score, end_i, end_j, B, n, m,
                         stride, gap_open, gap_extend, s);
    else
      launch<true, false>(qT, tT, table, hrow, frow, score, end_i, end_j, B, n, m,
                          stride, gap_open, gap_extend, s);
  } else {
    if (ends)
      launch<false, true>(qT, tT, table, hrow, frow, score, end_i, end_j, B, n, m,
                          stride, gap_open, gap_extend, s);
    else
      launch<false, false>(qT, tT, table, hrow, frow, score, end_i, end_j, B, n, m,
                           stride, gap_open, gap_extend, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
