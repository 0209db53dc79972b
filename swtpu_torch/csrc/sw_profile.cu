// Batched Smith-Waterman row-scan under a general substitution matrix for
// Hopper (sm_90a): local alignment scores and endpoints, linear or affine
// (Gotoh) gaps, any alphabet of up to 30 letters (4x4 DNA matrices,
// protein with BLOSUM62).
//
// Replaces the packed-profile TPU kernel, in its four forms, each in two
// forms here (a thread per pair below, a warp per pair further down):
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
// 12 (affine scores) and 14 (affine ends), plus one shared-memory lookup.
// The lookup is not free of bank conflicts: with the protein table's row
// stride of 32 the bank is t mod 32, so lanes reading one t under
// different q collide (about 4 passes per warp-wide load on random
// protein, a numpy estimate); the DNA table (stride 8) puts the 16 real
// (q, t) pairs on 16 distinct banks. A thread per pair also needs the
// batch to fill the card: 128-thread blocks of 2,731 pairs (BASELINE
// config 3's buckets) run on 22 of 132 SMs, each thread a chain of n x m
// cells.
//
// The warp form (sw_profile_warp_kernel<AFFINE, ENDS>), for batches too
// small to fill the card (kernels/sw_profile.py::profile_form picks it by
// shape): a warp per pair, lane l owning WR = 4 consecutive query rows of a
// stripe of 32 x WR rows. Target columns stream through the lanes as a
// skewed wavefront: at step s lane l computes column s - l for its rows,
// top to bottom, and hands its bottom H (and F) to lane l + 1 with one
// __shfl_up_sync a step, the target code with another; lane 0 takes the
// column's code, and past the first stripe the stripe above's last row
// (hrow / frow, [B, m] scratch that lane 31 writes), from windows of 32
// that one coalesced load refills every 32 steps. Columns before a lane's
// first and after the last score as pads: the region before is exactly
// the H = 0 boundary (E there is -go, which acts as the boundary's -inf),
// and every value after it is below a real cell, so no step is masked. A
// lane's WR rows are fixed for a stripe, so it builds once a stripe its
// rows' scores (+ the gap) for every target code in shared memory,
// [code][lane] int4: a step is one conflict-free 16-byte load (a quarter
// warp's 8 lanes hit 32 distinct banks). Entries stay int32, pads -2^20.
// H is kept minus the gap and a cell is a __vimax3_s32_relu (linear) or two
// __viaddmax_s32 and a __vimax3_s32_relu (Gotoh). Endpoints: per row the
// first column on a strict '>', folded in row order within a lane and then
// across lanes (the lowest lane of the stripe's maximum, strictly above
// the stripes before): the oracle's row-major-first cell. It reads the [B,
// n] / [B, m] codes as they are (no transposes). Its chain is a step of
// WR dependent cells and a shuffle; with few pairs the warps on an SM
// (occupancy capped by the profile's 16 KB a warp for protein) hide it.

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

constexpr int WR = 4;              // the warp form's query rows a lane
constexpr int WSTRIPE = 32 * WR;   // rows a stripe
constexpr int WWARPS = 2;          // pairs (warps) a block
constexpr unsigned FULL = 0xffffffffu;

template <bool AFFINE, bool ENDS>
__global__ void __launch_bounds__(32 * WWARPS)
sw_profile_warp_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                       const int32_t* __restrict__ table, int32_t* __restrict__ hrow,
                       int32_t* __restrict__ frow, int32_t* __restrict__ score,
                       int32_t* __restrict__ end_i, int32_t* __restrict__ end_j,
                       int B, int n, int m, int stride, int go, int ge) {
  extern __shared__ int4 prof_all[];  // [WWARPS][stride][32]: a lane's WR scores
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WWARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp; no block barrier below
  int4* prof = prof_all + (threadIdx.x >> 5) * stride * 32;
  const int pad = stride - 1;  // a code past the alphabet: scores -2^20
  const int G = go;            // kept off every stored H (linear: the gap)
  const uint8_t* qr = q + static_cast<size_t>(b) * n;
  const uint8_t* tr = t + static_cast<size_t>(b) * m;
  int32_t* hr = hrow ? hrow + static_cast<size_t>(b) * m : nullptr;
  int32_t* fr = frow ? frow + static_cast<size_t>(b) * m : nullptr;
  const int steps = m + 31;  // lane 31 reaches column m - 1 at step m + 30

  int best = 0, bi = 0, bj = 0;
  for (int i0 = 0; i0 < n && m > 0; i0 += WSTRIPE) {
    const bool first = i0 == 0, last = i0 + WSTRIPE >= n;
    int qo[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const int i = i0 + lane * WR + r;
      qo[r] = min(i < n ? static_cast<int>(qr[i]) : pad, pad) * stride;
    }
    __syncwarp();  // the stripe before is done with the profile and hrow
    for (int c = 0; c < stride; ++c)
      prof[c * 32 + lane] = make_int4(table[qo[0] + c] + G, table[qo[1] + c] + G,
                                      table[qo[2] + c] + G, table[qo[3] + c] + G);
    __syncwarp();

    int hl[WR], el[WR], rb[WR], rj[WR];  // left H - G, left E, row best and column
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      hl[r] = -G;
      el[r] = NEG_EF;
      rb[r] = 0;
      rj[r] = 0;
    }
    int hbot = -G, fbot = NEG_EF, tc = pad, diag = -G;
    // lane 0's windows: the target codes, and the stripe above's last row
    int tw = min(lane < m ? static_cast<int>(tr[lane]) : pad, pad);
    int tw_next = pad;
    if (32 + lane < m) tw_next = tr[32 + lane];
    int hw = -G, hw_next = -G, fw = NEG_EF, fw_next = NEG_EF;
    if (!first) {
      if (lane < m) hw = hr[lane];
      if (32 + lane < m) hw_next = hr[32 + lane];
      if (AFFINE) {
        if (lane < m) fw = fr[lane];
        if (32 + lane < m) fw_next = fr[32 + lane];
      }
    }

    for (int s = 0; s < steps; ++s) {
      const int sl = s & 31;
      if (sl == 0 && s > 0) {
        tw = min(tw_next, pad);
        tw_next = pad;
        if (s + 32 + lane < m) tw_next = tr[s + 32 + lane];
        if (!first) {
          hw = hw_next;
          hw_next = -G;
          if (s + 32 + lane < m) hw_next = hr[s + 32 + lane];
          if (AFFINE) {
            fw = fw_next;
            fw_next = NEG_EF;
            if (s + 32 + lane < m) fw_next = fr[s + 32 + lane];
          }
        }
      }
      // this step's column s - lane: its code and the cell above its top row
      const int t0 = __shfl_sync(FULL, tw, sl);
      const int tin = __shfl_up_sync(FULL, tc, 1);
      const int h0 = __shfl_sync(FULL, hw, sl);
      const int hin = __shfl_up_sync(FULL, hbot, 1);
      tc = lane == 0 ? t0 : tin;
      int up = lane == 0 ? h0 : hin;  // H[top - 1][j] - G
      int f = NEG_EF;
      if (AFFINE) {
        const int f0 = __shfl_sync(FULL, fw, sl);
        const int fin = __shfl_up_sync(FULL, fbot, 1);
        f = lane == 0 ? f0 : fin;  // F[top - 1][j]
      }
      const int4 sc4 = prof[tc * 32 + lane];
      const int sc[WR] = {sc4.x, sc4.y, sc4.z, sc4.w};
      int dg = diag;  // H[top - 1][j - 1] - G
      diag = up;
      const int j1 = s - lane + 1;  // the column, 1-based
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        int h;
        if (AFFINE) {
          f = __viaddmax_s32(f, -ge, up);
          el[r] = __viaddmax_s32(el[r], -ge, hl[r]);
          h = __vimax3_s32_relu(dg + sc[r], el[r], f);
        } else {
          h = __vimax3_s32_relu(dg + sc[r], up, hl[r]);
        }
        dg = hl[r];  // H[i][j - 1] is the diagonal of the row below
        hl[r] = h - G;
        up = hl[r];
        if (ENDS) {
          if (h > rb[r]) {
            rb[r] = h;
            rj[r] = j1;
          }
        } else {
          best = max(best, h);
        }
      }
      hbot = up;
      fbot = f;
      if (!last && lane == 31 && s >= 31) {  // the stripe below's top boundary
        hr[s - 31] = hbot;
        if (AFFINE) fr[s - 31] = fbot;
      }
    }

    if (ENDS) {
      int lb = 0, li = 0, lj = 0;
#pragma unroll
      for (int r = 0; r < WR; ++r) {
        if (rb[r] > lb) {
          lb = rb[r];
          li = i0 + lane * WR + r + 1;
          lj = rj[r];
        }
      }
      const int smax = __reduce_max_sync(FULL, lb);
      if (smax > best) {
        const int w = __ffs(__ballot_sync(FULL, lb == smax)) - 1;
        best = smax;
        bi = __shfl_sync(FULL, li, w);
        bj = __shfl_sync(FULL, lj, w);
      }
    }
  }

  if (!ENDS) best = __reduce_max_sync(FULL, best);
  if (lane == 0) {
    score[b] = best;
    if (ENDS) {
      end_i[b] = bi;
      end_j[b] = bj;
    }
  }
}

template <bool AFFINE, bool ENDS>
void launch_warp(const void* q, const void* t, const void* table, void* hrow, void* frow,
                 void* score, void* end_i, void* end_j, int B, int n, int m, int stride,
                 int go, int ge, cudaStream_t stream) {
  const dim3 grid((B + WWARPS - 1) / WWARPS);
  const size_t smem = sizeof(int4) * WWARPS * stride * 32;  // <= 32 KB
  sw_profile_warp_kernel<AFFINE, ENDS><<<grid, 32 * WWARPS, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(hrow),
      static_cast<int32_t*>(frow), static_cast<int32_t*>(score),
      static_cast<int32_t*>(end_i), static_cast<int32_t*>(end_j), B, n, m, stride, go, ge);
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

// The warp form: the same outputs from q [B, n] and t [B, m] uint8 codes as
// given (no transposes); hrow / frow [B, m] int32 scratch only when n >
// 128 (frow for affine only), else null.
int swtpu_sw_profile_warp(int affine, int ends, const void* q, const void* t,
                          const void* table, void* hrow, void* frow, void* score,
                          void* end_i, void* end_j, int B, int n, int m, int stride,
                          int gap_open, int gap_extend, void* stream) {
  if (stride < 1 || stride > MAX_STRIDE) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine) {
    if (ends)
      launch_warp<true, true>(q, t, table, hrow, frow, score, end_i, end_j, B, n, m, stride,
                              gap_open, gap_extend, s);
    else
      launch_warp<true, false>(q, t, table, hrow, frow, score, end_i, end_j, B, n, m,
                               stride, gap_open, gap_extend, s);
  } else {
    if (ends)
      launch_warp<false, true>(q, t, table, hrow, frow, score, end_i, end_j, B, n, m,
                               stride, gap_open, gap_extend, s);
    else
      launch_warp<false, false>(q, t, table, hrow, frow, score, end_i, end_j, B, n, m,
                                stride, gap_open, gap_extend, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
