// Batched Smith-Waterman row-scan under a general substitution matrix for
// Hopper (sm_90a): local alignment scores and endpoints, linear or affine
// (Gotoh) gaps, any alphabet of up to 30 letters (4x4 DNA matrices,
// protein with BLOSUM62).
//
// Replaces the packed-profile TPU kernel, in its four forms, each in two
// forms here (a thread per pair, sw_profile_kernel<AFFINE, END>, and a
// warp per pair, sw_profile_warp_kernel<AFFINE, ENDS>, further down):
//   <false, END_SCORE> / <false,false>  swtpu/kernels/pallas/sw_profile.py  _kernel, linear  (pallas_call :287)
//   <false, END_KEY | SELECT> / <false,true >  same, linear, with rowbits (ends)     (pallas_call :353)
//   <true,  END_SCORE> / <true, false>  same, affine                                (pallas_call :287)
//   <true,  END_KEY | SELECT> / <true, true >  same, affine, with rowbits (ends)     (pallas_call :353)
//
// Design of the thread form (sw_profile_kernel<AFFINE, END>, for batches
// that fill the card: kernels/sw_profile.py::profile_form picks it by
// shape): the skewed register tile of csrc/sw_local_tile.cuh (its head
// note has the schedule, the cell and the trackers), a thread per pair on
// the caller's [B, n] / [B, m] codes (the wrapper transposes nothing),
// ROWS = 16 query rows a sweep, an [m, B] int32 hand-off scratch ([m, B,
// 2] affine) read and written once a sweep, DPX cells on D = H - go.
// Each cell's score is one lookup in the plain tier's extended table
// (kernels/sw_scan.py::_extended_table: pads -2^20, internal ones
// included), which each CTA copies into shared memory as a lane table
// (the alphabet + 1 codes, the last a pad; each entry 32 times, word 32 x
// entry + lane, with go folded in), so a warp's 32 lookups hit 32 banks
// whatever the codes: 80 KB for BLOSUM62, two CTAs an SM. Codes clamp to
// the pad, so every code past the alphabet, up to 255, scores -2^20.
// Endpoints: END_KEY where local_tile::key_bits holds the pair's scores
// (an entry counts as 127), else END_SELECT. The earlier thread form (8
// rows a column over [L, B] transposes, a table of stride^2 words whose
// protein lookups took about 4 passes a warp) is replaced. The TPU
// kernel's query profile, int8 planes and select tree are TPU layout and
// are not carried over; it scores pads at -128, which differs on internal
// pads: the port follows its plain tier.
//
// Bound of the thread form, by pipe: a cell needs the table offset add 1
// (+ one shared-memory lookup), linear H 2 (the diagonal's add, a
// three-way max with the floor), Gotoh 4 (E, F, the add, the three-way
// max), D's subtract 1, and the score's best half a three-way max or the
// endpoint's key 2 (its IMAD and a max): 4.5 / 6 / 6.5 / 8 ops, 1.5 / 2 /
// 3.5 / 4 on the ALU pipe (linear scores / ends, Gotoh scores / ends);
// chip_smoke.py bounds each form by the larger of its ALU ops / 64 lanes,
// all its ops / 128 and its lookups / 32 banks an SM a clock.
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

#include "sw_local_tile.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_STRIDE = 32;
constexpr int NEG_EF = -(1 << 29);

using local_tile::END_KEY;
using local_tile::END_SCORE;
using local_tile::END_SELECT;

template <bool AFFINE, int END>
__global__ void __launch_bounds__(THREADS)
sw_profile_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  const int32_t* __restrict__ table, int32_t* __restrict__ scratch,
                  int32_t* __restrict__ score, int32_t* __restrict__ end_i,
                  int32_t* __restrict__ end_j, int B, int n, int m, int stride,
                  local_tile::Scoring sc, bool vec) {
  local_tile::profile_pairs<AFFINE, END, THREADS>(q, t, table, scratch, score, end_i, end_j,
                                                  B, n, m, stride, sc, vec);
}

template <bool AFFINE>
void launch(int end, const void* q, const void* t, const void* table, void* scratch,
            void* score, void* end_i, void* end_j, int B, int n, int m, int stride,
            const local_tile::Scoring& sc, bool vec, cudaStream_t stream) {
  local_tile::launch_profile_pairs<THREADS>(
      end == END_KEY      ? sw_profile_kernel<AFFINE, END_KEY>
      : end == END_SELECT ? sw_profile_kernel<AFFINE, END_SELECT>
                          : sw_profile_kernel<AFFINE, END_SCORE>,
      q, t, table, scratch, score, end_i, end_j, B, n, m, stride, sc, vec, stream);
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

// The thread form's query rows a sweep (the wrapper needs the scratch
// past one sweep).
int swtpu_sw_profile_rows() { return local_tile::ROWS; }

// The thread form's tracker for a launch of these sizes and gaps: 0 the
// score, 1 the endpoint with its packed key, 2 the endpoint with (best,
// step) apart (`select` forces it where the key would hold).
int swtpu_sw_profile_form(int ends, int select, int n, int m, int gap_open,
                          int gap_extend) {
  if (!ends) return END_SCORE;
  return !select && local_tile::key_bits(true, n, m, 0, 0, gap_open, gap_extend) >= 0
             ? END_KEY
             : END_SELECT;
}

// Launches one of the thread form's instantiations on `stream` and returns
// cudaGetLastError() (a refused launch never runs, and a later synchronise
// would not report it); cudaErrorInvalidValue for a table stride outside
// 1..32, codes outside 1..stride (the codes the lane table holds, the
// last a pad: the alphabet + 1; codes past it score as that pad) or a
// missing scratch past one sweep. Pointers: q [B, n] uint8, t [B, m]
// uint8, table [stride, stride] int32, scratch [m, B] int32 (linear: H -
// gap) or [m, B, 2] int32 (affine: H - gap_open, F), unused (null) when
// n <= ROWS or m == 0, score [B] int32, end_i / end_j [B] int32 (ends
// only). All on one device, all contiguous; the wrapper checks that.
// Linear kernels use gap_open as the gap. `select`: the endpoint with
// (best, step) apart even where the key would hold.
int swtpu_sw_profile(int affine, int ends, int select, const void* q, const void* t,
                     const void* table, void* scratch, void* score, void* end_i,
                     void* end_j, int B, int n, int m, int stride, int codes,
                     int gap_open, int gap_extend, void* stream) {
  if (stride < 1 || stride > MAX_STRIDE || codes < 1 || codes > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > local_tile::ROWS && m > 0 && !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const int end = swtpu_sw_profile_form(ends, select, n, m, gap_open, gap_extend);
  const int kb =
      end == END_KEY ? local_tile::key_bits(true, n, m, 0, 0, gap_open, gap_extend) : 0;
  const local_tile::Scoring sc{0, 0, 0, 0, codes - 1, gap_open, gap_extend, kb, 1 << kb};
  // whole 32-bit code words: every target row 4-byte aligned
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (affine)
    launch<true>(end, q, t, table, scratch, score, end_i, end_j, B, n, m, stride, sc, vec, s);
  else
    launch<false>(end, q, t, table, scratch, score, end_i, end_j, B, n, m, stride, sc, vec,
                  s);
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
