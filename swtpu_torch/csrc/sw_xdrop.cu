// Batched adaptive-banded X-drop semi-global alignment (forward pass) for
// Hopper (sm_90a): one anti-diagonal band of W cells per round, moved
// right or down by its end cells, X-drop zeroing, per-pair lengths, linear
// or affine (Gotoh) gaps, uniform or general-matrix scoring, optional band
// history (int32, or 8-bit with per-round offsets).
//
// Replaces the two per-round TPU kernels:
//   CPL = 1..3  swtpu/kernels/pallas/banded_batch.py   _kernel  (pallas_call :493, W <= 96)
//   W = 32, 64  swtpu/kernels/pallas/banded_packed.py  _kernel  (pallas_call :412)
// The packed TPU kernel exists because the sublane kernel left 96 of 128
// lanes idle at W = 32 (banded_packed.py:3-9); a warp per pair leaves no
// lane idle at W = 32 or 64, so here both contracts are one kernel, and
// the W = 32 and W = 64 instantiations serve the packed kernel's calls.
// Its CPL = 4 instantiation takes W up to 128, past the TPU kernels' 96.
//
// Design. One warp per pair; the band's W cells sit on the 32 lanes, CPL
// = ceil(W / 32) consecutive cells per lane (cell k on lane k / CPL, a
// template parameter; cells k >= W are kept dead). Each round:
// - the direction comes from cells 0 and W-1 by __shfl_sync (right iff
//   band[0] < band[W-1], ties move down);
// - the band shifts (horizontal / vertical, and the Gotoh E / F bands)
//   move one cell with __shfl_up_sync / __shfl_down_sync across lanes and
//   plain register moves inside a lane;
// - each lane reads its cells' characters from the padded int16 rows at
//   the pair's cursor (qp[y + W-1-k], tp[x - W+1+k]; -1 pads);
// - the round max is a __reduce_max_sync;
// - then the X-drop against the updated max, the termination test, and
//   a history row of W cells (coalesced) plus pos_y and the offset.
// Every state variable but the band is warp-uniform, so a warp never
// diverges, and it retires when its pair ends (boundary overrun before
// the round is written, the per-pair round cap (max(lq, lt) + 1) * 2 - 1,
// or a dead round after it is written). History rounds at and past a
// pair's n_rounds are not written: every reader stops below n_rounds.
// early_exit is therefore a no-op here. The TPU kernels' 128-char
// slabs, lane gathers, refill blocks and VMEM history buffers are TPU
// layout, not contract, and are not carried over.
//
// Contract (oracle/semiglobal.py:325-371, oracle/banded_affine.py, and the
// XLA tier kernels/xla/banded_scan.py, which the plain version copies):
// 0 is dead and never propagates; max_round moves only on a strictly
// greater round max; the X-drop zeroing uses the updated max; uniform
// scoring scores a pad (-1) at -mismatch, even against a pad; the general
// matrix reads the banded extended table (pads matrix.min(); codes clamp
// to stride - 1) from shared memory; Gotoh E/F are dead at -2^28, the
// no-contribution floor is -2^30, and E/F are cleared where H is 0. The
// history is H only (batch.traceback.reconstruct_affine_bands rebuilds
// E/F); the 8-bit form stores v - offset + 1 in [1, X + 1] (X <= 254).
//
// Bound: the rounds are serial within a pair, so a pair is a chain of
// dependent shuffles, loads and max-plus ops; across pairs the card's
// int32 issue rate (132 SMs x 64 lanes x SM clock) over rounds x W cells
// bounds it, the history bytes (4 or 1 per cell) only when written. With
// few pairs (256 warps on 132 SMs) the chain's latency binds instead.
// Later work: characters kept in a sliding register window refilled once
// per 32 rounds instead of two loads per cell per round, and more than
// one pair per warp at W < 32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // pairs per block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_STRIDE = 32;
constexpr int MAX_CPL = 4;
constexpr int EF_DEAD = -(1 << 28);
constexpr int EF_CUT = -(1 << 27);   // EF_DEAD // 2
constexpr int MINF = -(1 << 30);
constexpr int MINF_CUT = -(1 << 29);  // MINF // 2
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int16_t* qp;       // [B, QL] padded query rows, -1 pads
  const int16_t* tp;       // [B, TL] padded target rows
  const int32_t* lens_q;   // [B]
  const int32_t* lens_t;   // [B]
  const int32_t* table;    // [stride, stride] or null (uniform scoring)
  int32_t* score;          // [B]
  int32_t* max_round;      // [B]
  int32_t* n_rounds;       // [B]
  int32_t* hist32;         // [R_cap, B, W] or null
  uint8_t* hist8;          // [R_cap, B, W] or null (compressed)
  int32_t* posy;           // [R_cap, B] or null (with history)
  int32_t* offs;           // [R_cap, B] or null (compressed)
  int B, QL, TL, W, X;
  int match, mismatch, gap, go, ge, stride;
};

// out[k] = a[k - 1], out[0] = fill (the band's horizontal shift)
template <int CPL>
__device__ __forceinline__ void shift_down(const int (&a)[CPL], int (&out)[CPL], int lane,
                                           int fill) {
  const int in = __shfl_up_sync(FULL, a[CPL - 1], 1);
#pragma unroll
  for (int c = CPL - 1; c > 0; --c) out[c] = a[c - 1];
  out[0] = lane == 0 ? fill : in;
}

// out[k] = a[k + 1], out[last] = fill (the band's vertical shift)
template <int CPL>
__device__ __forceinline__ void shift_up(const int (&a)[CPL], int (&out)[CPL], int lane,
                                         int fill) {
  const int in = __shfl_down_sync(FULL, a[0], 1);
#pragma unroll
  for (int c = 0; c < CPL - 1; ++c) out[c] = a[c + 1];
  out[CPL - 1] = lane == 31 ? fill : in;
}

template <int CPL>
__device__ __forceinline__ void write_round(const Args& a, int r, int b, int lane,
                                            const int (&res)[CPL], int y, int off) {
  const size_t row = (static_cast<size_t>(r) * a.B + b);
  const size_t base = row * a.W;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k = lane * CPL + c;
    if (k < a.W) {
      if (a.hist8) {
        a.hist8[base + k] = static_cast<uint8_t>(res[c] > 0 ? res[c] - off + 1 : 0);
      } else {
        a.hist32[base + k] = res[c];
      }
    }
  }
  if (lane == 0) {
    a.posy[row] = y;
    if (a.offs) a.offs[row] = off;
  }
}

template <int CPL, bool AFFINE>
__global__ void __launch_bounds__(THREADS) sw_xdrop_kernel(Args a) {
  __shared__ int32_t tab[MAX_STRIDE * MAX_STRIDE];
  const bool profile = a.table != nullptr;
  if (profile) {
    for (int k = threadIdx.x; k < a.stride * a.stride; k += THREADS) tab[k] = a.table[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp
  const int W = a.W, X = a.X;
  const int lq = a.lens_q[b], lt = a.lens_t[b];
  const int rcap = (max(lq, lt) + 1) * 2 - 1;
  const int16_t* qrow = a.qp + static_cast<size_t>(b) * a.QL;
  const int16_t* trow = a.tp + static_cast<size_t>(b) * a.TL;
  const bool history = a.posy != nullptr;

  int res[CPL], hor[CPL], ver[CPL], eb[CPL], fb[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    res[c] = (lane * CPL + c == W - 1) ? X : 0;
    hor[c] = 0;
    ver[c] = 0;
    eb[c] = EF_DEAD;
    fb[c] = EF_DEAD;
  }
  const int end_lane = (W - 1) / CPL, end_c = (W - 1) % CPL;
  int now_y = 0, now_x = W - 1, max_score = X, max_round = 0, n_rounds = 1;
  if (history) write_round<CPL>(a, 0, b, lane, res, 0, 0);

  for (int r = 1; r < rcap; ++r) {
    int end_v = res[0];
#pragma unroll
    for (int c = 1; c < CPL; ++c) end_v = (c == end_c) ? res[c] : end_v;
    const int band0 = __shfl_sync(FULL, res[0], 0);
    const int bandw = __shfl_sync(FULL, end_v, end_lane);
    const bool right = band0 < bandw;

    int down[CPL], up[CPL], diag[CPL], hn[CPL], vn[CPL];
    shift_down<CPL>(res, down, lane, 0);
    shift_up<CPL>(res, up, lane, 0);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      diag[c] = right ? ver[c] : hor[c];
      hn[c] = right ? res[c] : down[c];
      vn[c] = right ? up[c] : res[c];
    }
    int he[CPL], vf[CPL];
    if (AFFINE) {
      int e_dn[CPL], f_up[CPL];
      shift_down<CPL>(eb, e_dn, lane, EF_DEAD);
      shift_up<CPL>(fb, f_up, lane, EF_DEAD);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        he[c] = right ? eb[c] : e_dn[c];
        vf[c] = right ? f_up[c] : fb[c];
      }
    }
    // a boundary overrun ends the pair before the round is written
    if (right) {
      if (++now_x > 2 * W + lt - 1) break;
    } else {
      if (++now_y > lq + 1) break;
    }

    int rn[CPL], en[CPL], fn[CPL];
    int lmax = 0;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int k = lane * CPL + c;
      int sc = 0;
      if (k < W) {
        const int yc = qrow[now_y + W - 1 - k];
        const int xc = trow[now_x - W + 1 + k];
        if (profile) {
          const int qi = yc >= 0 ? min(yc, a.stride - 1) : a.stride - 2;
          const int ti = xc >= 0 ? min(xc, a.stride - 1) : a.stride - 1;
          sc = tab[qi * a.stride + ti];
        } else {
          sc = (yc >= 0 && xc >= 0 && yc == xc) ? a.match : -a.mismatch;
        }
      }
      int v = diag[c] != 0 ? max(diag[c] + sc, 0) : 0;
      if (AFFINE) {
        en[c] = max(he[c] > EF_CUT ? he[c] - a.ge : MINF, hn[c] != 0 ? hn[c] - a.go : MINF);
        fn[c] = max(vf[c] > EF_CUT ? vf[c] - a.ge : MINF, vn[c] != 0 ? vn[c] - a.go : MINF);
        v = max(v, en[c] > MINF_CUT ? en[c] : 0);
        v = max(v, fn[c] > MINF_CUT ? fn[c] : 0);
      } else {
        v = hn[c] != 0 ? max(v, hn[c] - a.gap) : v;
        v = vn[c] != 0 ? max(v, vn[c] - a.gap) : v;
      }
      rn[c] = k < W ? v : 0;
      lmax = max(lmax, rn[c]);
    }
    const int round_max = __reduce_max_sync(FULL, lmax);
    if (max_score < round_max) {
      max_score = round_max;
      max_round = r;
    }
    const int cut = max_score - X;  // live cells lie in [cut, max_score]
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      res[c] = rn[c] < cut ? 0 : rn[c];
      hor[c] = hn[c];
      ver[c] = vn[c];
      if (AFFINE) {
        eb[c] = res[c] == 0 ? EF_DEAD : en[c];
        fb[c] = res[c] == 0 ? EF_DEAD : fn[c];
      }
    }
    n_rounds = r + 1;
    if (history) write_round<CPL>(a, r, b, lane, res, now_y, cut);
    if (round_max == 0) break;  // a dead round is written, then ends the pair
  }

  if (lane == 0) {
    a.score[b] = max_score - X;
    a.max_round[b] = max_round;
    a.n_rounds[b] = n_rounds;
  }
}

template <int CPL>
void launch(bool affine, const Args& a, cudaStream_t stream) {
  const dim3 grid((a.B + WARPS - 1) / WARPS);
  if (affine)
    sw_xdrop_kernel<CPL, true><<<grid, THREADS, 0, stream>>>(a);
  else
    sw_xdrop_kernel<CPL, false><<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace

extern "C" {

// Launches the instantiation for W (cells per lane ceil(W / 32)) on
// `stream` and returns cudaGetLastError() (a refused launch never runs,
// and a later synchronise would not report it); cudaErrorInvalidValue for
// W outside 1..128 or a table stride outside 1..32. Pointers: qp [B, QL]
// and tp [B, TL] int16 padded rows (QL = 1 + n + W, TL = 2W + m), lens_q /
// lens_t [B] int32, table [stride, stride] int32 or null (uniform), score /
// max_round / n_rounds [B] int32; with history posy [R_cap, B] int32 and
// either hist32 [R_cap, B, W] int32 or hist8 [R_cap, B, W] uint8 with offs
// [R_cap, B] int32, R_cap = (max(n, m) + 1) * 2 - 1 (all null for scores
// only); rounds at and past a pair's n_rounds are left as they were. All
// on one device, all contiguous; the
// wrapper checks that. Linear scoring uses `gap`.
int swtpu_sw_xdrop(int affine, const void* qp, const void* tp, const void* lens_q,
                   const void* lens_t, const void* table, void* score, void* max_round,
                   void* n_rounds, void* hist32, void* hist8, void* posy, void* offs, int B,
                   int QL, int TL, int W, int X, int match, int mismatch, int gap,
                   int gap_open, int gap_extend, int stride, void* stream) {
  if (W < 1 || W > 32 * MAX_CPL || (table && (stride < 1 || stride > MAX_STRIDE)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const int16_t*>(qp), static_cast<const int16_t*>(tp),
               static_cast<const int32_t*>(lens_q), static_cast<const int32_t*>(lens_t),
               static_cast<const int32_t*>(table), static_cast<int32_t*>(score),
               static_cast<int32_t*>(max_round), static_cast<int32_t*>(n_rounds),
               static_cast<int32_t*>(hist32), static_cast<uint8_t*>(hist8),
               static_cast<int32_t*>(posy), static_cast<int32_t*>(offs), B, QL, TL, W, X,
               match, mismatch, gap, gap_open, gap_extend, table ? stride : 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((W + 31) / 32) {
    case 1: launch<1>(affine != 0, a, s); break;
    case 2: launch<2>(affine != 0, a, s); break;
    case 3: launch<3>(affine != 0, a, s); break;
    default: launch<4>(affine != 0, a, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
