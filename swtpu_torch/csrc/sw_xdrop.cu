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
// Its CPL = 4 instantiations take W up to 128, past the TPU kernels' 96.
// From W = 129 to 1024 the wrapper launches the same round body
// (xdrop_pair) as xdrop_wide_warp_kernel (one warp a pair, W <= 256) or
// xdrop_wide_kernel (a CTA a pair, a warp each 128 cells; their note
// below), the counterpart of what JAX's TPU dispatch runs there: its
// XLA forward
//   swtpu/kernels/xla/banded_scan.py  banded_xdrop_batch (_banded_impl :66)
// Past 1024 the card refuses the band (kernels/banded_batch.py).
//
// Design (xdrop_round_kernel<CPL, AFFINE, MATRIX, HIST, EXACT>). One warp
// per pair; CPL = ceil(W / 32) consecutive band cells a lane (cell k on
// lane k / CPL, slot k % CPL). EXACT is W == 32 CPL; otherwise the cells
// k >= W are phantom, capped at 0 every round. The rounds of a pair are a
// chain (direction, the band's move, the max-plus update, the round max),
// and the design keeps everything else off it:
// - No global load on the chain. Each lane holds its cells' query and
//   target codes in registers (matrix mode: the table row offset and the
//   column). A down move shifts the query codes one cell along the band,
//   a right move the target codes; the code that enters at the band's end
//   comes by one shuffle from per-lane windows of that sequence's next 64
//   codes (two registers, a third loading the 32 after them). The rounds
//   run in blocks of 32, which move at most 32 times either way, and a
//   window is refilled by one coalesced load between blocks once a block
//   has used it up, so a round's only branches are its exit and the loop.
//   Positions outside a pair's length or the row read as pads: the kernel
//   takes the raw [B, n] / [B, m] codes and the lengths, no padded rows.
//   The phantom cells hold the target codes ahead of the band, so the
//   entering target code always lands on the last lane.
// - Both moves ahead of the direction. During round r each lane forms
//   round r+1's shifted codes, scores and diagonal terms for both moves;
//   when the direction is known it selects.
// - The cut applied late. The cells' uncut values (minus the gap) shift
//   across lanes while the round max reduces (__reduce_max_sync), and the
//   next round applies the cut to the candidate it selects, so no shuffle
//   waits on the reduction. The direction is right iff band[W-1] >
//   max(band[0], max_score - X - 1) on the uncut end values: the plain rule
//   band[0] < band[W-1] on the cut band (dead = 0, live >= max(cut, 1)).
// - Dead cells fold into the max-plus. A cut or dead H reads as -2^29, so a
//   linear cell is one __vimax3_s32_relu(diag + s, h - g, v - g); Gotoh
//   E = __viaddmax_s32_relu(E, -ge, h - go), F likewise, H =
//   __vimax3_s32_relu(diag + s, E, F). Scores carry + g (the table in shared
//   memory, or match + g / g - mismatch) and H is kept minus g. E and F
//   floor at 0 (a negative E or F never reaches H: H floors at 0 and E - ge
//   < 0) and are cleared with the cell that holds them, through the same
//   cut test as its H. A dead cell's external value stays 0 (history).
// - The per-round bookkeeping (max, cut, direction, cursor, termination) is
//   warp-uniform, so a warp never diverges. A round runs ahead of its
//   overrun test and keeps nothing (selects, not a branch) when it fails;
//   the warp retires when its pair ends (boundary overrun before the round
//   is written, the per-pair round cap (max(lq, lt) + 1) * 2 - 1, or a dead
//   round after it is written). History rounds at and past a
//   pair's n_rounds are not written: every reader stops below n_rounds.
//   early_exit is therefore a no-op here.
// - Grid: one warp a block up to 32 pairs an SM (256 pairs land on all 132
//   SMs), four from there.
// The TPU kernels' 128-char slabs, lane gathers, refill blocks and VMEM
// history buffers are TPU layout, not contract, and are not carried over.
//
// Contract (oracle/semiglobal.py:325-371, oracle/banded_affine.py, and the
// XLA tier kernels/xla/banded_scan.py, which the plain version copies):
// 0 is dead and never propagates; max_round moves only on a strictly
// greater round max; the X-drop zeroing uses the updated max; uniform
// scoring scores a pad at -mismatch, even against a pad; the general
// matrix reads the banded extended table (pads matrix.min(); codes clamp
// to stride - 1); Gotoh E/F are dead at -2^28 and cleared where H is 0
// (the plain version); here their positive parts, all that reaches H. The
// history is H only (batch.traceback.reconstruct_affine_bands rebuilds
// E/F); the 8-bit form stores v - offset + 1 in [1, X + 1] (X <= 254).
//
// Bound: the rounds are serial within a pair, so with few pairs (256 warps
// on 132 SMs) the round's chain binds: after the reduction a max, the
// direction (a 3-input max and a compare), the selects, the cut (compare,
// select) and one or three DPX max-plus ops, then the lane max and the
// reduction. With many pairs the card's int32 issue rate (132 SMs x 64
// lanes x SM clock) over rounds x W cells binds, the shuffles (a dozen a
// round a warp) next; the history bytes (4 or 1 per cell) only when
// written. Later work: more than one pair per warp at W < 32.
//
// Beside it the earlier kernel (sw_xdrop_kernel<CPL, AFFINE>, a warp per
// pair over padded int16 rows, two global code loads a cell a round, the
// cut before the shuffles), off every entry point: chip_smoke.py and the
// card tests time it and hold it beside the kernel above.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_STRIDE = 32;
constexpr int MAX_CPL = 4;       // the warp kernel: W <= 128
constexpr int WIDE_WARP_CPL = 8;  // the wide band's one-warp form: W <= 256
constexpr unsigned FULL = 0xffffffffu;
constexpr int DEAD = -(1 << 29);  // a cut or dead H (kept minus the gap)

struct RoundArgs {
  const uint8_t* q;        // [B, n] raw query codes
  const uint8_t* t;        // [B, m] raw target codes
  const int32_t* lens_q;   // [B] or null (every query n long)
  const int32_t* lens_t;   // [B] or null (every target m long)
  const int32_t* table;    // [stride, stride] or null (uniform scoring)
  int32_t* score;          // [B]
  int32_t* max_round;      // [B]
  int32_t* n_rounds;       // [B]
  int32_t* hist32;         // [R_cap, B, W] or null
  uint8_t* hist8;          // [R_cap, B, W] or null (compressed)
  int32_t* posy;           // [R_cap, B] or null (with history)
  int32_t* offs;           // [R_cap, B] or null (compressed)
  int B, n, m, W, X;
  int match, mismatch, gap, go, ge, stride;
};

// a row's code at idx, `pad` outside [0, len); a predicated load, so a
// window refill's value is not waited for until it is read
__device__ __forceinline__ int raw_at(const uint8_t* row, int idx, int len, int pad) {
  int c = pad;
  if (idx >= 0 && idx < len) c = row[idx];
  return c;
}

// the pads the windows hold: uniform scoring -1 for the query and -2 for
// the target (never equal), the matrix its pad row and column
template <bool MATRIX>
__device__ __forceinline__ int q_pad(int stride) { return MATRIX ? stride - 2 : -1; }
template <bool MATRIX>
__device__ __forceinline__ int t_pad(int stride) { return MATRIX ? stride - 1 : -2; }

// a window's query code as the cells hold it: uniform scoring the code (or
// -1), the matrix the table row offset (codes clamp to stride - 1)
template <bool MATRIX>
__device__ __forceinline__ int q_code(int raw, int stride) {
  return MATRIX ? min(raw, stride - 1) * stride : raw;
}

// a window's target code: the code (or -2), the matrix the table column
template <bool MATRIX>
__device__ __forceinline__ int t_code(int raw, int stride) {
  return MATRIX ? min(raw, stride - 1) : raw;
}

// the score plus the gap folded into the stored H
template <bool MATRIX>
__device__ __forceinline__ int score_g(int qc, int tc, const int32_t* tab, int sm, int smm) {
  if (MATRIX) return tab[qc + tc];
  return qc == tc ? sm : smm;
}

// out[k] = a[k - 1]; out[0] = fill on lane 0
template <int CPL>
__device__ __forceinline__ void shift_dn(const int (&a)[CPL], int (&out)[CPL], int lane,
                                         int fill) {
  const int in = __shfl_up_sync(FULL, a[CPL - 1], 1);
#pragma unroll
  for (int c = CPL - 1; c > 0; --c) out[c] = a[c - 1];
  out[0] = lane == 0 ? fill : in;
}

// out[k] = a[k + 1]; out[last] = fill on lane 31
template <int CPL>
__device__ __forceinline__ void shift_up(const int (&a)[CPL], int (&out)[CPL], int lane,
                                         int fill) {
  const int in = __shfl_down_sync(FULL, a[0], 1);
#pragma unroll
  for (int c = 0; c < CPL - 1; ++c) out[c] = a[c + 1];
  out[CPL - 1] = lane == 31 ? fill : in;
}

// the same without a fill: the band's end cells read them only behind a
// failed cut test
template <int CPL>
__device__ __forceinline__ void shift_dn_any(const int (&a)[CPL], int (&out)[CPL]) {
  const int in = __shfl_up_sync(FULL, a[CPL - 1], 1);
#pragma unroll
  for (int c = CPL - 1; c > 0; --c) out[c] = a[c - 1];
  out[0] = in;
}

template <int CPL>
__device__ __forceinline__ void shift_up_any(const int (&a)[CPL], int (&out)[CPL]) {
  const int in = __shfl_down_sync(FULL, a[0], 1);
#pragma unroll
  for (int c = 0; c < CPL - 1; ++c) out[c] = a[c + 1];
  out[CPL - 1] = in;
}

// history row r: the cut band (dead 0), int32 or 8-bit v - cut + 1; this
// warp's cells from `base`, the row's position and offset by `lead`
template <int CPL, bool EXACT>
__device__ __forceinline__ void write_row(const RoundArgs& a, int r, int b, int lane,
                                          int base, bool lead, const int (&v)[CPL], int cut,
                                          int y) {
  const int cutp = max(cut, 1);
  const size_t row = static_cast<size_t>(r) * a.B + b;
  const size_t at = row * a.W + base;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k = lane * CPL + c;
    if (EXACT || base + k < a.W) {
      const int res = v[c] >= cutp ? v[c] : 0;
      if (a.hist8) {
        a.hist8[at + k] = static_cast<uint8_t>(res ? res - cut + 1 : 0);
      } else {
        a.hist32[at + k] = res;
      }
    }
  }
  if (lead) {
    a.posy[row] = y;
    if (a.offs) a.offs[row] = cut;
  }
}

// a[c] for the lane's slot c (a runtime slot, selected: no local memory)
template <int CPL>
__device__ __forceinline__ int slot_of(const int (&a)[CPL], int c) {
  int x = a[CPL - 1];
#pragma unroll
  for (int i = 0; i < CPL - 1; ++i) x = i == c ? a[i] : x;
  return x;
}

// What crosses warps in the CTA form (xdrop_wide_kernel), a slot a warp,
// one set a round parity: the warp's round max and its edge cells, uncut
// (H - G; F of its first cell, E of its last real one).
constexpr int MAX_WIDE = 1024;        // cells a CTA
constexpr int WIDE_WARPS = MAX_WIDE / 128;
struct Slots {
  int max[WIDE_WARPS];
  int first_h[WIDE_WARPS];
  int first_f[WIDE_WARPS];
  int last_h[WIDE_WARPS];
  int last_e[WIDE_WARPS];
};

// The CTA form's one barrier a round: each warp publishes its round max
// and edge cells into `s`, and after the barrier reads the CTA's round max,
// the band's end cells band[0] and band[W - 1] (uncut, H - G) and its
// neighbours' edge cells, the fills its own shifts left open (a down move's
// cell k - 1 at its first cell, a right move's cell k + 1 at its last).
template <int CPL, bool AFFINE>
__device__ __forceinline__ void cross(Slots& s, int lane, int warp, int nw, int wmax,
                                      const int (&rng)[CPL], const int (&e)[CPL],
                                      const int (&f)[CPL], int end_lane, int end_c,
                                      int (&sd)[CPL], int (&su)[CPL], int (&ed)[CPL],
                                      int (&fu)[CPL], int& rmax, int& b0, int& bw) {
  if (lane == 0) {
    s.max[warp] = wmax;
    s.first_h[warp] = rng[0];
    if (AFFINE) s.first_f[warp] = f[0];
  }
  if (lane == end_lane) {
    s.last_h[warp] = slot_of<CPL>(rng, end_c);
    if (AFFINE) s.last_e[warp] = slot_of<CPL>(e, end_c);
  }
  __syncthreads();
  rmax = __reduce_max_sync(FULL, lane < nw ? s.max[lane] : 0);
  b0 = s.first_h[0];
  bw = s.last_h[nw - 1];
  if (lane == 0 && warp > 0) {
    sd[0] = s.last_h[warp - 1];
    if (AFFINE) ed[0] = s.last_e[warp - 1];
  }
  if (lane == 31 && warp + 1 < nw) {
    su[CPL - 1] = s.first_h[warp + 1];
    if (AFFINE) fu[CPL - 1] = s.first_f[warp + 1];
  }
}

// One pair's rounds on one warp (CTA false: the band is the warp's 32 CPL
// cells) or on warp `warp` of `nw` (CTA: the band's cells 32 CPL warp ..
// 32 CPL (warp + 1) - 1, the other warps' edge cells and maxima through
// `slots`). `tab` is the table (+ G) in shared memory (MATRIX).
template <int CPL, bool AFFINE, bool MATRIX, bool HIST, bool EXACT, bool CTA>
__device__ __forceinline__ void xdrop_pair(const RoundArgs& a, const int32_t* tab, int b,
                                           int lane, int warp, int nw, Slots* slots) {
  const int G = AFFINE ? a.go : a.gap;  // the gap kept off every stored H
  const int W = a.W, X = a.X, stride = a.stride, ge = a.ge;
  const int lq = a.lens_q ? a.lens_q[b] : a.n;
  const int lt = a.lens_t ? a.lens_t[b] : a.m;
  const int rcap = (max(lq, lt) + 1) * 2 - 1;
  const uint8_t* qrow = a.q + static_cast<size_t>(b) * a.n;
  const uint8_t* trow = a.t + static_cast<size_t>(b) * a.m;
  const int sm = a.match + G, smm = G - a.mismatch;
  // this warp's first cell and its last real one (the band's end cell on
  // the band's last warp)
  const int base = CTA ? warp * 32 * CPL : 0;
  const int end_k = min(32 * CPL, W - base) - 1;
  const int end_lane = end_k / CPL, end_c = end_k % CPL;
  const bool lead = lane == 0 && (!CTA || warp == 0);  // the pair's per-round fields
  // cell k holds query code d + W - 2 - k and target code u - W + k after d
  // down and u right moves; the phantom cells' target codes run ahead, so
  // the code a right move brings enters at the warp's last cell, and the
  // one a down move brings at its first
  const int q_lead = W - 1 - base;
  const int t_lead = base + 32 * CPL - W;

  const int qp = q_pad<MATRIX>(stride), tp = t_pad<MATRIX>(stride);
  int q[CPL], t[CPL], v[CPL], rng[CPL], hg[CPL], vg[CPL], cap[CPL];
  int e[CPL], f[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int k = base + lane * CPL + c;
    q[c] = q_code<MATRIX>(raw_at(qrow, W - 2 - k, lq, qp), stride);
    t[c] = t_code<MATRIX>(raw_at(trow, k - W, lt, tp), stride);
    v[c] = k == W - 1 ? X : 0;
    rng[c] = v[c] - G;
    hg[c] = DEAD;
    vg[c] = DEAD;
    e[c] = 0;
    f[c] = 0;
    cap[c] = k < W ? INT_MAX : 0;
  }
  // the entering codes' windows, three registers a sequence: lane l holds
  // query codes q_lead + qb + l (qa), + 32 (qn) and + 64 (ql, its load in
  // flight, not read until it moves up); after d downs the next entering
  // code is window lane d - qb, in [0, 64), and likewise the target's from
  // t_lead + tb after u rights. A shuffle's source lane wraps mod 32.
  int qb = 0, tb = 0;
  int qa = raw_at(qrow, q_lead + lane, lq, qp), qn = raw_at(qrow, q_lead + 32 + lane, lq, qp);
  int ql = raw_at(qrow, q_lead + 64 + lane, lq, qp);
  int ta = raw_at(trow, t_lead + lane, lt, tp), tn = raw_at(trow, t_lead + 32 + lane, lt, tp);
  int tl = raw_at(trow, t_lead + 64 + lane, lt, tp);
  int u = 0;  // right moves so far; every round moves once, so r - 1 - u downs
  int ms = X, max_round = 0;
  if (HIST) write_row<CPL, EXACT>(a, 0, b, lane, base, lead, v, 0, 0);

  // round 1's candidates
  int sd[CPL], su[CPL], qsd[CPL], tsu[CPL], dr[CPL], dd[CPL], ed[CPL], fu[CPL];
  shift_dn<CPL>(rng, sd, lane, DEAD);
  shift_up<CPL>(rng, su, lane, DEAD);
  shift_dn<CPL>(q, qsd, lane, q_code<MATRIX>(__shfl_sync(FULL, qa, 0), stride));
  shift_up<CPL>(t, tsu, lane, t_code<MATRIX>(__shfl_sync(FULL, ta, 0), stride));
  if (AFFINE) {
    shift_dn_any<CPL>(e, ed);
    shift_up_any<CPL>(f, fu);
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    dr[c] = vg[c] + score_g<MATRIX>(q[c], tsu[c], tab, sm, smm);
    dd[c] = hg[c] + score_g<MATRIX>(qsd[c], t[c], tab, sm, smm);
  }
  bool right;
  if constexpr (CTA) {
    int rmax, b0, bw;
    cross<CPL, AFFINE>(slots[0], lane, warp, nw, 0, rng, e, f, end_lane, end_c, sd, su, ed,
                       fu, rmax, b0, bw);
    right = bw > max(b0, -1 - G);
  } else {
    int vend = v[CPL - 1];
    if (!EXACT) vend = slot_of<CPL>(v, end_c);
    right = __shfl_sync(FULL, vend, end_lane) > max(__shfl_sync(FULL, v[0], 0), -1);
  }
  int thr = 1 - G;  // max(ms - X, 1) - G: a stored H below it is cut

  // The rounds run in blocks of 32: a block moves at most 32 times either
  // way, so the two readable windows cover its entering codes, and the
  // refills run between blocks. A round's only branches are its exit and
  // the back-edge; the compiler interleaves four rounds (unroll 4).
  int r = 1;  // after the loop: the rounds written, n_rounds
  bool stop = r >= rcap;
  while (!stop) {
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      // a boundary overrun ends the pair before the round is written; the
      // round runs ahead of the test, and is undone when it fails
      const bool over = right ? u >= W + lt : r - 1 - u > lq;
      int lmax = 0;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int hs = right ? rng[c] : sd[c];
        const int vs = right ? su[c] : rng[c];
        const int dg = right ? dr[c] : dd[c];
        const bool hp = hs >= thr, vp = vs >= thr;
        hg[c] = hp ? hs : DEAD;
        vg[c] = vp ? vs : DEAD;
        int x;
        if (AFFINE) {
          const int es = right ? e[c] : ed[c];
          const int fs = right ? fu[c] : f[c];
          e[c] = __viaddmax_s32_relu(hp ? es : 0, -ge, hg[c]);
          f[c] = __viaddmax_s32_relu(vp ? fs : 0, -ge, vg[c]);
          x = __vimax3_s32_relu(dg, e[c], f[c]);
        } else {
          x = __vimax3_s32_relu(dg, hg[c], vg[c]);
        }
        if (!EXACT) x = min(x, cap[c]);
        v[c] = x;
        rng[c] = x - G;
        lmax = c == 0 ? x : max(lmax, x);
        q[c] = right ? q[c] : qsd[c];
        t[c] = right ? tsu[c] : t[c];
      }
      u += right;
      const int d = r - u;  // down moves so far
      // the round max; meanwhile the next round's operands, uncut (the
      // CTA form's end cells and warp edges come through the slots below)
      int rmax = __reduce_max_sync(FULL, lmax), b0 = 0, bw = 0;
      if constexpr (!CTA) {
        int vend = v[CPL - 1];
        if (!EXACT) vend = slot_of<CPL>(v, end_c);
        b0 = __shfl_sync(FULL, v[0], 0);
        bw = __shfl_sync(FULL, vend, end_lane);
      }
      shift_dn<CPL>(rng, sd, lane, DEAD);
      shift_up<CPL>(rng, su, lane, DEAD);
      if (AFFINE) {
        shift_dn_any<CPL>(e, ed);
        shift_up_any<CPL>(f, fu);
      }
      const int qin = __shfl_sync(FULL, d - qb < 32 ? qa : qn, d);
      const int tin = __shfl_sync(FULL, u - tb < 32 ? ta : tn, u);
      shift_dn<CPL>(q, qsd, lane, q_code<MATRIX>(qin, stride));
      shift_up<CPL>(t, tsu, lane, t_code<MATRIX>(tin, stride));
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        dr[c] = vg[c] + score_g<MATRIX>(q[c], tsu[c], tab, sm, smm);
        dd[c] = hg[c] + score_g<MATRIX>(qsd[c], t[c], tab, sm, smm);
      }
      if constexpr (CTA)
        cross<CPL, AFFINE>(slots[r & 1], lane, warp, nw, rmax, rng, e, f, end_lane, end_c,
                           sd, su, ed, fu, rmax, b0, bw);
      // the next round's cut and direction; an overrun restores what the
      // round changed on its way out, off the chain
      const int ms_before = ms, max_round_before = max_round;
      max_round = rmax > ms ? r : max_round;
      ms = max(ms, rmax);
      const int cut = ms - X;  // live cells lie in [max(cut, 1), ms]
      thr = __viaddmax_s32(ms, -X - G, 1 - G);  // max(cut, 1) - G
      // right iff bw > max(b0, cut - 1) (the CTA's ends are H - G)
      right = bw > __viaddmax_s32(ms, CTA ? -X - 1 - G : -X - 1, b0);
      if (HIST && !over) write_row<CPL, EXACT>(a, r, b, lane, base, lead, v, cut, d);
      // a dead round is written, then ends the pair; so does the round cap
      if (over || rmax == 0 || r + 1 >= rcap) {
        if (over) {
          ms = ms_before;
          max_round = max_round_before;
        } else {
          ++r;
        }
        stop = true;
        break;
      }
      ++r;
    }
    const int d = r - 1 - u;
    if (!stop && d - qb >= 32) {  // uniform: the block used up a query window
      qb += 32;
      qa = qn;
      qn = ql;
      ql = raw_at(qrow, q_lead + 64 + qb + lane, lq, qp);
    }
    if (!stop && u - tb >= 32) {  // ... or a target window
      tb += 32;
      ta = tn;
      tn = tl;
      tl = raw_at(trow, t_lead + 64 + tb + lane, lt, tp);
    }
  }

  if (lead) {
    a.score[b] = ms - X;
    a.max_round[b] = max_round;
    a.n_rounds[b] = r;
  }
}

// A warp per pair, pairs blockDim / 32 a CTA: both one-warp kernels' body.
template <int CPL, bool AFFINE, bool MATRIX, bool HIST, bool EXACT>
__device__ __forceinline__ void warp_pairs(const RoundArgs& a) {
  __shared__ int32_t tab[MATRIX ? MAX_STRIDE * MAX_STRIDE : 1];
  if (MATRIX) {
    const int G = AFFINE ? a.go : a.gap;
    for (int k = threadIdx.x; k < a.stride * a.stride; k += blockDim.x)
      tab[k] = a.table[k] + G;
    __syncthreads();
  }
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp
  xdrop_pair<CPL, AFFINE, MATRIX, HIST, EXACT, false>(a, tab, b, threadIdx.x & 31, 0, 1,
                                                      nullptr);
}

// W <= 128: CPL = 1..4 (the TPU kernels' counterpart)
template <int CPL, bool AFFINE, bool MATRIX, bool HIST, bool EXACT>
__global__ void __launch_bounds__(128) xdrop_round_kernel(RoundArgs a) {
  warp_pairs<CPL, AFFINE, MATRIX, HIST, EXACT>(a);
}

// W = 129..256: CPL = 5..8, the wide band's one-warp form (its note below)
template <int CPL, bool AFFINE, bool MATRIX, bool HIST, bool EXACT>
__global__ void __launch_bounds__(128) xdrop_wide_warp_kernel(RoundArgs a) {
  warp_pairs<CPL, AFFINE, MATRIX, HIST, EXACT>(a);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <int CPL, bool AFFINE, bool MATRIX, bool HIST>
void launch_round(const RoundArgs& a, cudaStream_t stream) {
  // a warp a block while the pairs leave SMs free, four warps from 32 an SM
  const int warps = a.B <= 32 * sm_count() ? 1 : 4;
  const dim3 grid((a.B + warps - 1) / warps), block(32 * warps);
  if constexpr (CPL <= MAX_CPL) {
    if (a.W == 32 * CPL)
      xdrop_round_kernel<CPL, AFFINE, MATRIX, HIST, true><<<grid, block, 0, stream>>>(a);
    else
      xdrop_round_kernel<CPL, AFFINE, MATRIX, HIST, false><<<grid, block, 0, stream>>>(a);
  } else {
    if (a.W == 32 * CPL)
      xdrop_wide_warp_kernel<CPL, AFFINE, MATRIX, HIST, true><<<grid, block, 0, stream>>>(a);
    else
      xdrop_wide_warp_kernel<CPL, AFFINE, MATRIX, HIST, false><<<grid, block, 0, stream>>>(a);
  }
}

template <int CPL>
void launch_cpl(bool affine, bool matrix, bool hist, const RoundArgs& a, cudaStream_t s) {
  if (affine) {
    if (matrix) {
      if (hist) launch_round<CPL, true, true, true>(a, s);
      else launch_round<CPL, true, true, false>(a, s);
    } else {
      if (hist) launch_round<CPL, true, false, true>(a, s);
      else launch_round<CPL, true, false, false>(a, s);
    }
  } else {
    if (matrix) {
      if (hist) launch_round<CPL, false, true, true>(a, s);
      else launch_round<CPL, false, true, false>(a, s);
    } else {
      if (hist) launch_round<CPL, false, false, true>(a, s);
      else launch_round<CPL, false, false, false>(a, s);
    }
  }
}

// -- the wide band: W = 129 to 1024 ------------------------------------------
//
// The counterpart of JAX's XLA forward past the warp kernel's 128 cells,
// in two designs on the same round body (xdrop_pair), which
// kernels/banded_batch.py::banded_form picks by W, each the faster where
// it runs (chip_smoke.py phase 43, tools/xla_tier_times.py):
// - W = 129..256: xdrop_wide_warp_kernel<CPL, ...> above, the warp
//   kernel's one warp a pair with CPL = ceil(W / 32) = 5..8 cells a lane
//   (no barrier; the round's chain grows by the extra cells' ops only);
// - W = 257..1024: xdrop_wide_kernel<AFFINE, MATRIX, HIST, EXACT> below
//   (it takes any W from 1 to MAX_WIDE), a CTA a pair.
//
// xdrop_wide_kernel: one CTA per pair of
// ceil(W / 128) warps; warp w holds band cells 128 w .. 128 w + 127 in
// registers exactly as the warp kernel's CPL = 4 instantiation holds its
// 128 (xdrop_pair above is both kernels' round body): 4 cells a lane, the
// query and target codes in registers with per-warp windows refilled
// between blocks of 32 rounds (each warp's entering codes are its own: a
// down move brings code d + W - 2 - 128 w to its first cell, a right move
// code u - W + 128 w + 127 to its last), both moves formed ahead of the
// direction, the cut applied late on the uncut values, dead cells folded
// into the DPX max-plus, phantom cells past W capped at 0 (EXACT: W a
// multiple of 128, none). What crosses warps goes through a shared-memory
// slot array double-buffered by round parity (Slots, cross()): each
// warp's round max (__reduce_max_sync) and its first and last uncut cell
// (H - G, with F of the first and E of the last under Gotoh). So a round
// has one barrier; after it every warp reads the CTA's round max (max
// score, max round and the cut), band[0] and band[W - 1] for the
// direction, by the warp kernel's rule on uncut end values, and its
// neighbours' edge cells, for a down move's cell k - 1 and a right move's
// cell k + 1. Every warp derives the same max, cut, direction and
// termination, so the CTA stays uniform. A warp writes round r + 2's slots
// (the set round r used) only after round r + 1's barrier, which every
// warp reaches after reading round r's slots, so two sets suffice.
// Bound: a pair's ~2 (n + m) rounds are a chain, and with few pairs (256
// on 132 SMs) the round's latency binds: the warp kernel's chain plus, in
// the CTA, the slot stores, the barrier and the slot loads (which is why
// one warp with up to 8 cells a lane is faster up to W = 256). The
// earlier design (a thread a cell, the band, E and F through shared
// memory, two barriers a round) is replaced; tools/xla_tier_times.py
// times it from a checkout of the parent.

template <bool AFFINE, bool MATRIX, bool HIST, bool EXACT>
__global__ void __launch_bounds__(MAX_WIDE / 4) xdrop_wide_kernel(RoundArgs a) {
  __shared__ int32_t tab[MATRIX ? MAX_STRIDE * MAX_STRIDE : 1];
  __shared__ Slots slots[2];
  if (MATRIX) {
    const int G = AFFINE ? a.go : a.gap;
    for (int k = threadIdx.x; k < a.stride * a.stride; k += blockDim.x)
      tab[k] = a.table[k] + G;
  }
  __syncthreads();
  xdrop_pair<4, AFFINE, MATRIX, HIST, EXACT, true>(a, tab, blockIdx.x, threadIdx.x & 31,
                                                   threadIdx.x >> 5, blockDim.x >> 5, slots);
}

template <bool AFFINE, bool MATRIX, bool HIST>
void launch_wide(const RoundArgs& a, cudaStream_t stream) {
  const int threads = 32 * ((a.W + 127) / 128);
  if (a.W % 128 == 0)
    xdrop_wide_kernel<AFFINE, MATRIX, HIST, true><<<a.B, threads, 0, stream>>>(a);
  else
    xdrop_wide_kernel<AFFINE, MATRIX, HIST, false><<<a.B, threads, 0, stream>>>(a);
}

void launch_wide_any(bool affine, bool matrix, bool hist, const RoundArgs& a,
                     cudaStream_t s) {
  if (affine) {
    if (matrix) {
      if (hist) launch_wide<true, true, true>(a, s);
      else launch_wide<true, true, false>(a, s);
    } else {
      if (hist) launch_wide<true, false, true>(a, s);
      else launch_wide<true, false, false>(a, s);
    }
  } else {
    if (matrix) {
      if (hist) launch_wide<false, true, true>(a, s);
      else launch_wide<false, true, false>(a, s);
    } else {
      if (hist) launch_wide<false, false, true>(a, s);
      else launch_wide<false, false, false>(a, s);
    }
  }
}

// -- the earlier kernel, timed beside the one above ------------------------

namespace earlier {

constexpr int WARPS = 4;  // pairs per block
constexpr int THREADS = 32 * WARPS;
constexpr int EF_DEAD = -(1 << 28);
constexpr int EF_CUT = -(1 << 27);   // EF_DEAD // 2
constexpr int MINF = -(1 << 30);
constexpr int MINF_CUT = -(1 << 29);  // MINF // 2

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

}  // namespace earlier

}  // namespace

extern "C" {

// Launches the instantiation for (W, affine, table, history) on `stream`
// and returns cudaGetLastError() (a refused launch never runs, and a later
// synchronise would not report it); cudaErrorInvalidValue for W outside
// 1..128 or a table stride outside 1..32. Pointers: q [B, n] and t [B, m]
// uint8 raw codes, lens_q / lens_t [B] int32 (each may be null: every pair
// n / m long), table [stride, stride] int32 or null (uniform), score /
// max_round / n_rounds [B] int32; with history posy [R_cap, B] int32 and
// either hist32 [R_cap, B, W] int32 or hist8 [R_cap, B, W] uint8 with offs
// [R_cap, B] int32, R_cap = (max(n, m) + 1) * 2 - 1 (all null for scores
// only); rounds at and past a pair's n_rounds are left as they were. All
// on one device, all contiguous; the wrapper checks that. Linear scoring
// uses `gap`.
int swtpu_sw_xdrop(int affine, const void* q, const void* t, const void* lens_q,
                   const void* lens_t, const void* table, void* score, void* max_round,
                   void* n_rounds, void* hist32, void* hist8, void* posy, void* offs, int B,
                   int n, int m, int W, int X, int match, int mismatch, int gap,
                   int gap_open, int gap_extend, int stride, void* stream) {
  if (W < 1 || W > 32 * MAX_CPL || (table && (stride < 1 || stride > MAX_STRIDE)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const RoundArgs a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
                    static_cast<const int32_t*>(lens_q), static_cast<const int32_t*>(lens_t),
                    static_cast<const int32_t*>(table), static_cast<int32_t*>(score),
                    static_cast<int32_t*>(max_round), static_cast<int32_t*>(n_rounds),
                    static_cast<int32_t*>(hist32), static_cast<uint8_t*>(hist8),
                    static_cast<int32_t*>(posy), static_cast<int32_t*>(offs), B, n, m, W, X,
                    match, mismatch, gap, gap_open, gap_extend, table ? stride : 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool matrix = table != nullptr, hist = posy != nullptr;
  switch ((W + 31) / 32) {
    case 1: launch_cpl<1>(affine != 0, matrix, hist, a, s); break;
    case 2: launch_cpl<2>(affine != 0, matrix, hist, a, s); break;
    case 3: launch_cpl<3>(affine != 0, matrix, hist, a, s); break;
    default: launch_cpl<4>(affine != 0, matrix, hist, a, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The wide band (xdrop_wide_kernel, a CTA of ceil(W / 128) warps a pair):
// the same arguments and outputs as swtpu_sw_xdrop for any W from 1 to
// MAX_WIDE (1024); cudaErrorInvalidValue outside it or for a table stride
// outside 1..32.
int swtpu_sw_xdrop_wide(int affine, const void* q, const void* t, const void* lens_q,
                        const void* lens_t, const void* table, void* score, void* max_round,
                        void* n_rounds, void* hist32, void* hist8, void* posy, void* offs,
                        int B, int n, int m, int W, int X, int match, int mismatch, int gap,
                        int gap_open, int gap_extend, int stride, void* stream) {
  if (W < 1 || W > MAX_WIDE || (table && (stride < 1 || stride > MAX_STRIDE)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const RoundArgs a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
                    static_cast<const int32_t*>(lens_q), static_cast<const int32_t*>(lens_t),
                    static_cast<const int32_t*>(table), static_cast<int32_t*>(score),
                    static_cast<int32_t*>(max_round), static_cast<int32_t*>(n_rounds),
                    static_cast<int32_t*>(hist32), static_cast<uint8_t*>(hist8),
                    static_cast<int32_t*>(posy), static_cast<int32_t*>(offs), B, n, m, W, X,
                    match, mismatch, gap, gap_open, gap_extend, table ? stride : 1};
  launch_wide_any(affine != 0, table != nullptr, posy != nullptr, a,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The wide band's one-warp form (xdrop_wide_warp_kernel, a warp a pair,
// ceil(W / 32) cells a lane): the same arguments and outputs as
// swtpu_sw_xdrop for W from 129 to 256; cudaErrorInvalidValue outside it
// or for a table stride outside 1..32.
int swtpu_sw_xdrop_wide_warp(int affine, const void* q, const void* t, const void* lens_q,
                             const void* lens_t, const void* table, void* score,
                             void* max_round, void* n_rounds, void* hist32, void* hist8,
                             void* posy, void* offs, int B, int n, int m, int W, int X,
                             int match, int mismatch, int gap, int gap_open, int gap_extend,
                             int stride, void* stream) {
  if (W <= 32 * MAX_CPL || W > 32 * WIDE_WARP_CPL ||
      (table && (stride < 1 || stride > MAX_STRIDE)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const RoundArgs a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
                    static_cast<const int32_t*>(lens_q), static_cast<const int32_t*>(lens_t),
                    static_cast<const int32_t*>(table), static_cast<int32_t*>(score),
                    static_cast<int32_t*>(max_round), static_cast<int32_t*>(n_rounds),
                    static_cast<int32_t*>(hist32), static_cast<uint8_t*>(hist8),
                    static_cast<int32_t*>(posy), static_cast<int32_t*>(offs), B, n, m, W, X,
                    match, mismatch, gap, gap_open, gap_extend, table ? stride : 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool matrix = table != nullptr, hist = posy != nullptr;
  switch ((W + 31) / 32) {
    case 5: launch_cpl<5>(affine != 0, matrix, hist, a, s); break;
    case 6: launch_cpl<6>(affine != 0, matrix, hist, a, s); break;
    case 7: launch_cpl<7>(affine != 0, matrix, hist, a, s); break;
    default: launch_cpl<8>(affine != 0, matrix, hist, a, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The earlier kernel, off every entry point: the same outputs from padded
// int16 rows qp [B, QL] and tp [B, TL] (QL = 1 + n + W, TL = 2W + m, -1
// pads, as banded_scan._prep_padded makes them) and lens_q / lens_t [B]
// int32 (not null).
int swtpu_sw_xdrop_earlier(int affine, const void* qp, const void* tp, const void* lens_q,
                           const void* lens_t, const void* table, void* score,
                           void* max_round, void* n_rounds, void* hist32, void* hist8,
                           void* posy, void* offs, int B, int QL, int TL, int W, int X,
                           int match, int mismatch, int gap, int gap_open, int gap_extend,
                           int stride, void* stream) {
  if (W < 1 || W > 32 * MAX_CPL || (table && (stride < 1 || stride > MAX_STRIDE)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const earlier::Args a{
      static_cast<const int16_t*>(qp), static_cast<const int16_t*>(tp),
      static_cast<const int32_t*>(lens_q), static_cast<const int32_t*>(lens_t),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(score),
      static_cast<int32_t*>(max_round), static_cast<int32_t*>(n_rounds),
      static_cast<int32_t*>(hist32), static_cast<uint8_t*>(hist8),
      static_cast<int32_t*>(posy), static_cast<int32_t*>(offs), B, QL, TL, W, X,
      match, mismatch, gap, gap_open, gap_extend, table ? stride : 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((W + 31) / 32) {
    case 1: earlier::launch<1>(affine != 0, a, s); break;
    case 2: earlier::launch<2>(affine != 0, a, s); break;
    case 3: earlier::launch<3>(affine != 0, a, s); break;
    default: earlier::launch<4>(affine != 0, a, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
