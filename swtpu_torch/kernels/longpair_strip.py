"""One R x C tile of a single long pair's DP matrix: the CUDA strip tile
and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/longpair_strip.py`` (``strip_tile``,
``strip_tile_affine`` and the per-tile calls ``tile_strip_linear`` /
``tile_strip_affine``). The kernel is ``csrc/sw_strip.cu``, whose head
note says what it replaces, what bounds it and how. The plain version is
the column-scan tile here (``_tile_colscan``, ``_tile_colscan_affine``:
the XLA tiles of ``swtpu/parallel/longpair.py``, bit-equal to JAX's;
``tile_sw_reference`` is their numpy mirror); the kernel returns the
same tuples bit for bit: the bottom boundary row(s), the right boundary
column(s), the tile best and its 1-based row-major-first endpoint. The
kernel runs the tile in row bands of a warp each on many SMs
(``strip_plan`` picks the bands); ``_tile_pipeline`` mirrors that
decomposition with plain sub-tiles. The earlier one-block kernel stays
beside it (``_one_block_launch_t``, off the main path) to be timed
against it.

Pads follow the column-scan tile (JAX's XLA tier): every code >= the
alphabet size scores -2^20 under any matrix, an in-length ``N`` against
an ``N`` included. JAX's Pallas tile has a uniform shortcut that matches
equal codes, pads too, so the two differ on in-length pads (ROADMAP.md
queue C); the port follows its plain tile.

The per-tile calls run where their tensors lie: on the CPU the plain
tile, on a CUDA device the kernel, which they never replace with the
plain tile; a failed build or launch, or a tile the kernel does not take
(more than 30 letters, more than ``STRIP_ROWS`` rows, a negative penalty
so large that the plain tile's fill reaches its real cells:
:func:`strip_refusal`), raises. Each counts its launches in ``<call>.launches``. The TPU
staging (the skewed target, the (8, 128) slot layout, the one-hot
profile matmul) is layout for the TPU's vregs and is not carried over.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.sw_batch import ptr
from swtpu_torch.kernels.sw_profile import MAX_LETTERS, profile_table
from swtpu_torch.kernels.sw_scan import _extended_table, select_scores
from swtpu_torch.utils.device import resolve_device

SOURCE = "sw_strip.cu"
MAX_THREADS = 1024  # one CUDA block a tile; thread I owns rows [I*br, I*br + br)
NEGB = -(2**20)  # "outside the tile" marker
#: rows of one strip: the one-block kernel's most (1024 threads x 16
#: rows); a longer query is swept strip after strip
STRIP_ROWS = 16384
_BIG = 1 << 30
#: H below it fits the endpoint's packed key (H << 4 and 4 row bits in 31)
KEY_MAX = 1 << 27


def _vec(x, device, dtype=torch.int32) -> torch.Tensor:
    """A 1-D (or 0-D) tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _tile_profile(q_slot, table):
    """[R+1, stride] per-slot substitution profile: one gather per tile."""
    return table[q_slot]


def _prof_select(prof, t_j, n_codes):
    """s[i] = prof[i, t_j] through the shared select tree
    (``sw_scan.select_scores``): every extended-table column >= n_codes
    is all -2^20, the tree's fall-through value."""
    return select_scores(prof, t_j, n_codes)


def _prefix_shifts(R):
    """Shifts 1, 2, 4, ... <= R: ceil(log2(R + 1)) doublings cover the
    vertical chain of R + 1 slots."""
    shifts, sh = [], 1
    while sh <= R:
        shifts.append(sh)
        sh *= 2
    return shifts


def _shift_fill(x, shv):
    """[NEGB] * shv followed by x[:-shv]."""
    return torch.cat([torch.full((shv,), NEGB, dtype=x.dtype, device=x.device),
                      x[:-shv]])


def _tile_setup(q, t, left_col, corner, table):
    dev = table.device
    q = _vec(q, dev, torch.int64)
    t = _vec(t, dev, torch.int64)
    stride = table.shape[0]
    ghost_q = stride - 2
    q_slot = torch.cat([q.new_full((1,), ghost_q), q.clamp(max=ghost_q)])
    prof = _tile_profile(q_slot, table)  # [R+1, stride]
    left_ext = torch.cat([_vec(corner, dev).reshape(1), _vec(left_col, dev)])
    return q.shape[0], t, prof, left_ext


def _tile_end(best_vec, bestj_vec, iota):
    """Row-major-first tile endpoint: max value, then min slot (row),
    then that slot's earliest column; a best <= 0 maps to (0, 0, 0)."""
    vmax = best_vec.max()
    i_at = torch.where(best_vec == vmax, iota, torch.full_like(iota, _BIG)).min()
    bj = bestj_vec[i_at]
    zero = vmax <= 0
    nil = torch.zeros((), dtype=torch.int32, device=best_vec.device)
    best = torch.clamp(vmax, min=0)
    bi = torch.where(zero, nil, i_at.to(torch.int32))
    bj = torch.where(zero, nil, bj)
    return best, bi, bj


def _tile_colscan(q, t, top_row, left_col, corner, table, n_codes, gap):
    """One R x C linear-gap tile on the column-parallel schedule.

    q: [R] strip codes, t: [C] block codes; top_row: [C] = H of the row
    above the tile; left_col: [R] = H of the column left of it; corner:
    H above-left; table: [stride, stride] int32 extended table (on the
    device the tile runs on); n_codes: the alphabet size. Returns
    (bottom_row [C], right_col [R], best, bi, bj): the tile's last row
    and column, its best cell and the 1-based tile-local row-major-first
    endpoint of that best ((0, 0) when it is <= 0).

    The schedule of JAX's ``_tile_colscan``: scan the target positions;
    the query column is one vector whose vertical chain is the
    closed-form max-plus prefix (log-doubling over static shifts); per
    slot a running max with strict '>' keeps each row's earliest column.
    """
    R, t, prof, left_ext = _tile_setup(q, t, left_col, corner, table)
    C = t.shape[0]
    dev = prof.device
    top_row = _vec(top_row, dev)
    iota = torch.arange(R + 1, device=dev)
    g32 = int(gap)
    shifts = _prefix_shifts(R)
    hprev = left_ext
    best_vec = torch.full((R + 1,), NEGB, dtype=torch.int32, device=dev)
    bestj_vec = torch.zeros((R + 1,), dtype=torch.int32, device=dev)
    bottom = torch.empty((C,), dtype=torch.int32, device=dev)
    neg1 = torch.full((1,), NEGB, dtype=torch.int32, device=dev)
    for j in range(1, C + 1):
        s = _prof_select(prof, t[j - 1], n_codes)
        diag = torch.cat([neg1, hprev[:-1]])
        pre = torch.clamp(torch.maximum(diag + s, hprev - g32), min=0)
        # slot 0 is the top boundary value; it seeds the vertical chain
        pre[0] = top_row[j - 1]
        h = pre
        for shv in shifts:
            h = torch.maximum(h, _shift_fill(h, shv) - shv * g32)
        masked = h.clone()
        masked[0] = NEGB
        upd = masked > best_vec
        best_vec = torch.where(upd, masked, best_vec)
        bestj_vec = torch.where(upd, torch.full_like(bestj_vec, j), bestj_vec)
        bottom[j - 1] = h[R]
        hprev = h
    best, bi, bj = _tile_end(best_vec, bestj_vec, iota)
    return bottom, hprev[1:], best, bi, bj


def _tile_colscan_affine(q, t, top_row, top_row_f, left_col, left_col_e,
                         corner, table, n_codes, go, ge, top_pre=None, with_pre=False):
    """One R x C affine (Gotoh) tile on the column-parallel schedule.

    Extra boundary state beside ``_tile_colscan``'s: top_row_f [C] = F of
    the row above (F crosses strip boundaries), left_col_e [R] = E of the
    column to the left (E crosses column blocks). Returns (bottom_row,
    bottom_row_f, right_col, right_col_e, best, bi, bj).

    The F chain inside a column is JAX's decoupled form: a max-plus
    prefix over X[k] = pre[k] - go (slot 0 folds the F boundary), whose
    F-from-F branch through H is dropped. That equals Gotoh's F when
    gap_open >= gap_extend; E is a carried per-slot recurrence.

    ``top_pre`` [C] (default: ``top_row``) is the E-and-diagonal candidate
    of the row above, which the F chain reads: a tile cut out of a taller
    one gets its upper neighbour's, so that the cut is exact for gaps of
    either sign within ``strip_refusal``'s bound. ``with_pre`` appends the bottom row's candidate to the returns.
    """
    R, t, prof, left_ext = _tile_setup(q, t, left_col, corner, table)
    C = t.shape[0]
    dev = prof.device
    top_row = _vec(top_row, dev)
    top_row_f = _vec(top_row_f, dev)
    top_pre = top_row if top_pre is None else _vec(top_pre, dev)
    left_ext_e = torch.cat([torch.full((1,), NEGB, dtype=torch.int32, device=dev),
                            _vec(left_col_e, dev)])
    iota = torch.arange(R + 1, device=dev)
    go32, ge32 = int(go), int(ge)
    shifts = _prefix_shifts(R)
    hprev, eprev = left_ext, left_ext_e
    best_vec = torch.full((R + 1,), NEGB, dtype=torch.int32, device=dev)
    bestj_vec = torch.zeros((R + 1,), dtype=torch.int32, device=dev)
    bots = torch.empty((C,), dtype=torch.int32, device=dev)
    bots_f = torch.empty((C,), dtype=torch.int32, device=dev)
    bots_pre = torch.empty((C,), dtype=torch.int32, device=dev)
    neg1 = torch.full((1,), NEGB, dtype=torch.int32, device=dev)
    for j in range(1, C + 1):
        top_j, top_f_j = top_row[j - 1], top_row_f[j - 1]
        s = _prof_select(prof, t[j - 1], n_codes)
        diag = torch.cat([neg1, hprev[:-1]])
        e_cur = torch.maximum(eprev - ge32, hprev - go32)
        pre = torch.clamp(torch.maximum(diag + s, e_cur), min=0)
        pre[0] = top_j
        # F chain: prefix over X (slot 0 folds the F boundary)
        x = pre - go32
        x[0] = torch.maximum(top_pre[j - 1] - go32, top_f_j - ge32)
        p = x
        for shv in shifts:
            p = torch.maximum(p, _shift_fill(p, shv) - shv * ge32)
        f_cur = torch.cat([neg1, p[:-1]])
        f_cur[0] = top_f_j
        h = torch.maximum(pre, f_cur)
        h[0] = top_j
        masked = h.clone()
        masked[0] = NEGB
        upd = masked > best_vec
        best_vec = torch.where(upd, masked, best_vec)
        bestj_vec = torch.where(upd, torch.full_like(bestj_vec, j), bestj_vec)
        bots[j - 1] = h[R]
        bots_f[j - 1] = f_cur[R]
        bots_pre[j - 1] = pre[R]
        hprev, eprev = h, e_cur
    best, bi, bj = _tile_end(best_vec, bestj_vec, iota)
    out = (bots, bots_f, hprev[1:], eprev[1:], best, bi, bj)
    return out + (bots_pre,) if with_pre else out


def _diag_setup(q, t, top_row, left_col, corner, table):
    """The anti-diagonal tiles' staging: per-slot profile, the reversed
    target between ghost pads, and the extended boundaries (index i of
    ``left_ext``: H[i0 - 1 + i, j0 - 1]; index j of ``top_pad``: H[i0 -
    1, j0 - 1 + j], NEGB past the tile)."""
    R, t, prof, left_ext = _tile_setup(q, t, left_col, corner, table)
    C, dev = t.shape[0], prof.device
    ghost_t = table.shape[0] - 1
    pad = t.new_full((R + 1,), ghost_t)
    t_rev_pad = torch.cat([pad, t.flip(0).clamp(max=ghost_t), pad])
    top_pad = torch.cat([left_ext[:1], _vec(top_row, dev),
                         torch.full((R + 2,), NEGB, dtype=torch.int32, device=dev)])
    return R, C, prof, left_ext, t_rev_pad, top_pad


def _diag_shift1(x):
    """[NEGB, x[0], ..., x[-2]]: slot i reads slot i - 1."""
    return _shift_fill(x, 1)


def _tile_scan(q, t, top_row, left_col, corner, table, n_codes, gap):
    """One R x C linear-gap tile on the anti-diagonal schedule: JAX's
    older XLA tile (``_tile_scan``), which only its tests use; the same
    contract and returns as ``_tile_colscan``, bit-equal. Slot i of a
    diagonal d holds cell (i, d - i); slot 0 the top boundary row."""
    R, C, prof, left_ext, t_rev_pad, top_pad = _diag_setup(q, t, top_row, left_col,
                                                           corner, table)
    dev = prof.device
    iota = torch.arange(R + 1, device=dev)
    neg = torch.full((R + 1,), NEGB, dtype=torch.int32, device=dev)
    prev1, prev2 = neg, neg
    best_vec, bestj_vec, right_vec = neg, torch.zeros_like(neg), neg
    bots = torch.empty((R + C,), dtype=torch.int32, device=dev)
    for d in range(1, R + C + 1):
        t_diag = t_rev_pad[C - d + R + 1:C - d + 2 * R + 2]
        s = _prof_select(prof, t_diag, n_codes)
        diag_n, upper_n, left_n = _diag_shift1(prev2), _diag_shift1(prev1), prev1
        # left-boundary ghosts where j - 1 == 0 (i == d - 1)
        is_j1 = iota == d - 1
        left_n = torch.where(is_j1, left_ext, left_n)
        diag_n = torch.where(is_j1, _diag_shift1(left_ext), diag_n)
        cur = torch.clamp(torch.maximum(torch.maximum(diag_n + s, upper_n - gap),
                                        left_n - gap), min=0)
        cur = torch.where(iota == 0, top_pad[min(d, C + R + 1)], cur)
        j_of = d - iota
        cur = torch.where((iota > 0) & ((j_of < 1) | (j_of > C)), neg, cur)
        masked = torch.where(iota > 0, cur, neg)
        upd = masked > best_vec
        best_vec = torch.where(upd, masked, best_vec)
        bestj_vec = torch.where(upd, j_of.to(torch.int32), bestj_vec)
        right_vec = torch.where(iota == d - C, cur, right_vec)
        bots[d - 1] = cur[R]
        prev1, prev2 = cur, prev1
    best, bi, bj = _tile_end(best_vec, bestj_vec, iota)
    # bottom_row[j - 1] = H[R, j], emitted at diagonal d = R + j
    return bots[R:R + C], right_vec[1:], best, bi, bj


def _tile_scan_affine(q, t, top_row, top_row_f, left_col, left_col_e, corner,
                      table, n_codes, go, ge):
    """One R x C affine (Gotoh) tile on the anti-diagonal schedule: JAX's
    ``_tile_scan_affine``, the same contract and returns as
    ``_tile_colscan_affine``. Unlike the column scan it runs Gotoh's F
    recurrence itself, F from F and from H."""
    R, C, prof, left_ext, t_rev_pad, top_pad = _diag_setup(q, t, top_row, left_col,
                                                           corner, table)
    dev = prof.device
    iota = torch.arange(R + 1, device=dev)
    neg = torch.full((R + 1,), NEGB, dtype=torch.int32, device=dev)
    left_ext_e = torch.cat([neg[:1], _vec(left_col_e, dev)])
    top_f_pad = torch.cat([neg[:1], _vec(top_row_f, dev), neg[:1].expand(R + 2)])
    prev1, prev2, f_prev1, e_prev1 = neg, neg, neg, neg
    best_vec, bestj_vec, right_vec, right_vec_e = neg, torch.zeros_like(neg), neg, neg
    bots = torch.empty((R + C,), dtype=torch.int32, device=dev)
    bots_f = torch.empty((R + C,), dtype=torch.int32, device=dev)
    for d in range(1, R + C + 1):
        t_diag = t_rev_pad[C - d + R + 1:C - d + 2 * R + 2]
        s = _prof_select(prof, t_diag, n_codes)
        diag_n, upper_n, upper_f = _diag_shift1(prev2), _diag_shift1(prev1), _diag_shift1(f_prev1)
        is_j1 = iota == d - 1
        left_n = torch.where(is_j1, left_ext, prev1)
        left_e = torch.where(is_j1, left_ext_e, e_prev1)
        diag_n = torch.where(is_j1, _diag_shift1(left_ext), diag_n)
        e_cur = torch.maximum(left_e - ge, left_n - go)
        f_cur = torch.maximum(upper_f - ge, upper_n - go)
        cur = torch.clamp(torch.maximum(diag_n + s, torch.maximum(e_cur, f_cur)), min=0)
        at = min(d, C + R + 1)
        cur = torch.where(iota == 0, top_pad[at], cur)
        f_cur = torch.where(iota == 0, top_f_pad[at], f_cur)
        j_of = d - iota
        outside = (iota > 0) & ((j_of < 1) | (j_of > C))
        cur = torch.where(outside, neg, cur)
        f_cur = torch.where(outside, neg, f_cur)
        e_cur = torch.where(outside, neg, e_cur)
        masked = torch.where(iota > 0, cur, neg)
        upd = masked > best_vec
        best_vec = torch.where(upd, masked, best_vec)
        bestj_vec = torch.where(upd, j_of.to(torch.int32), bestj_vec)
        at_right = iota == d - C
        right_vec = torch.where(at_right, cur, right_vec)
        right_vec_e = torch.where(at_right, e_cur, right_vec_e)
        bots[d - 1], bots_f[d - 1] = cur[R], f_cur[R]
        prev1, prev2, f_prev1, e_prev1 = cur, prev1, f_cur, e_cur
    best, bi, bj = _tile_end(best_vec, bestj_vec, iota)
    return (bots[R:R + C], bots_f[R:R + C], right_vec[1:], right_vec_e[1:],
            best, bi, bj)


def tile_sw_reference(q, t, top_row, left_col, corner, matrix, gap):
    """numpy mirror of the linear tile for unit tests (matrix: [A, A]
    scores): (bottom_row, right_col, best)."""
    R, C = len(q), len(t)
    H = np.zeros((R + 1, C + 1), np.int64)
    H[0, 0] = corner
    H[0, 1:] = top_row
    H[1:, 0] = left_col
    best = 0
    for i in range(1, R + 1):
        for j in range(1, C + 1):
            s = matrix[q[i - 1], t[j - 1]]
            H[i, j] = max(
                0, H[i - 1, j - 1] + s, H[i - 1, j] - gap, H[i, j - 1] - gap
            )
            best = max(best, H[i, j])
    return H[R, 1:], H[1:, C], best



def rows_per_thread(R: int) -> int:
    """br: the smallest power of two with ceil(R / br) <= 1024 threads
    (the kernel's instantiations: 1, 2, 4, 8, 16)."""
    br = 1
    while -(-R // br) > MAX_THREADS:
        br *= 2
    return br


#: the lanes of a band's warp; a row band is BAND_LANES x br rows
BAND_LANES = 32


def strip_plan(R: int, C: int):
    """(br, bands) of the pipelined tile: the rows a lane holds and the row
    bands of BAND_LANES x br rows, a warp each, on as many SMs. br is the
    power of two in 1..16 nearest 4R / C, so that bands = C / 128: a band
    sweeps C + 31 steps and lags the band above by a few dozen, and a
    step's cost grows with br. The rule is read off the H100: chip_smoke.py
    times every br beside this pick on square, tall, wide and thin tiles
    (PERF.md section 6); square tiles take 4 rows a lane, tall thin ones
    16, wide ones 1."""
    e = round(math.log2(4 * R / C))
    br = 1 << min(4, max(0, e))
    return br, -(-R // (BAND_LANES * br))


def _tile_pipeline(q, t, top_row, top_row_f, left_col, left_col_e, corner, table,
                   n_codes, go, ge, band_rows, cols, affine):
    """Plain mirror of the pipelined kernel's decomposition: the R x C tile
    cut into bands of ``band_rows`` rows and blocks of ``cols`` columns,
    sub-tile (d, b) run by the plain tile at step d + b from band d - 1's
    last row (H; Gotoh also F and the E-and-diagonal candidate the F chain
    reads), block b - 1's right column (H, E) and the corner, the bests
    merged row-major first (value, least row, least column). Returns what
    the whole tile's plain version returns. ``go`` is the linear gap."""
    dev = table.device
    q = _vec(q, dev, torch.int64)
    t = _vec(t, dev, torch.int64)
    R, C = q.shape[0], t.shape[0]
    top = _vec(top_row, dev)
    left = torch.cat([_vec(corner, dev).reshape(1), _vec(left_col, dev)])
    D, NBc = -(-R // band_rows), -(-C // cols)
    below = {}  # (d, b) -> sub-tile (d, b)'s last row: (H, F, pre)
    lcol = {}  # d -> band d's right column so far: (H, E)
    bottom, bottom_f = torch.empty_like(top), torch.empty_like(top)
    right = torch.empty((R,), dtype=torch.int32, device=dev)
    right_e = torch.empty((R,), dtype=torch.int32, device=dev)
    best = (0, _BIG, _BIG)  # value, 0-based row, 0-based column
    for step in range(D + NBc - 1):
        for d in range(max(0, step - NBc + 1), min(D, step + 1)):
            b = step - d
            r0, r1 = d * band_rows, min(R, (d + 1) * band_rows)
            c0, c1 = b * cols, min(C, (b + 1) * cols)
            if d:
                top_b, topf_b, pre_b = below[d - 1, b]
                corner_b = below[d - 1, b - 1][0][-1] if b else left[r0]
            else:
                top_b, pre_b = top[c0:c1], None
                topf_b = _vec(top_row_f, dev)[c0:c1] if affine else None
                corner_b = top[c0 - 1] if b else left[r0]
            hl, el = lcol.get(d, (left[r0 + 1:r1 + 1], _vec(left_col_e, dev)[r0:r1]
                                  if affine else None))
            if affine:
                bot, bot_f, rc, rce, tb, ti, tj, bot_pre = _tile_colscan_affine(
                    q[r0:r1], t[c0:c1], top_b, topf_b, hl, el, corner_b, table, n_codes,
                    go, ge, top_pre=pre_b, with_pre=True)
            else:
                bot, rc, tb, ti, tj = _tile_colscan(q[r0:r1], t[c0:c1], top_b, hl,
                                                    corner_b, table, n_codes, go)
                bot_f = bot_pre = rce = None
            below[d, b] = (bot, bot_f, bot_pre)
            lcol[d] = (rc, rce)
            if d == D - 1:
                bottom[c0:c1] = bot
                if affine:
                    bottom_f[c0:c1] = bot_f
            if b == NBc - 1:
                right[r0:r1] = rc
                if affine:
                    right_e[r0:r1] = rce
            cand = (int(tb), r0 + int(ti) - 1, c0 + int(tj) - 1)
            if cand[0] > best[0] or (cand[0] == best[0] > 0 and cand[1:] < best[1:]):
                best = cand
    i32 = dict(dtype=torch.int32, device=dev)
    found = best[0] > 0
    out3 = (torch.tensor(best[0], **i32),
            torch.tensor(best[1] + 1 if found else 0, **i32),
            torch.tensor(best[2] + 1 if found else 0, **i32))
    if affine:
        return (bottom, bottom_f, right, right_e) + out3
    return (bottom, right) + out3


def fill_reach(params: ScoringParams, R: int) -> int:
    """How far above -2^20 the plain tile's log-doubling fill can climb in
    an R-row tile: the shifts' sum (< 2R) times the negative penalty that
    its vertical chain adds a row (the linear gap, Gotoh's extension); 0
    when that penalty is >= 0."""
    step = params.gap if params.is_linear else params.gap_extend
    return sum(_prefix_shifts(R)) * max(0, -int(step))


def h_reach(params: ScoringParams, R: int, C: int) -> int:
    """How far H can climb above the largest boundary value (or 0) across
    an R x C tile: a path to any cell takes at most R + C steps, each gap
    step adds at most max(0, -gap_open, -gap_extend) and each diagonal one,
    which covers a row and a column, the matrix's largest entry."""
    g = max(0, -int(params.gap_open), -int(params.gap_extend))
    return (R + C) * g + min(R, C) * max(0, int(params.matrix.max()) - 2 * g)


def strip_refusal(params: ScoringParams, R: int, C: int):
    """Why the kernel does not take this tile, or None when it does. It
    takes gaps of either sign while the plain tile's fill stays below
    every real value of its chain (:func:`fill_reach`: below 0 linear,
    below -gap_open Gotoh), where its sequential chain equals the plain
    tile's log-doubling prefix: |gap| <= 32 at 16384 rows."""
    if params.alphabet_size > MAX_LETTERS:
        return (f"the strip kernel takes at most {MAX_LETTERS} letters (got "
                f"{params.alphabet_size}), as the plain tile's extended table does")
    floor = 0 if params.is_linear else -int(params.gap_open)
    if NEGB + fill_reach(params, R) >= floor:
        return (f"the strip kernel's row chain equals the plain tile's log-doubling "
                f"prefix (JAX's XLA tile, whose shifts fill with -2^20) only while the "
                f"fill, -2^20 + {sum(_prefix_shifts(R))} x the negative penalty at {R} "
                f"rows, stays below {floor} (got gaps {params.gap_open}, "
                f"{params.gap_extend}); cut the query into shorter strips or run it on "
                "the CPU (ROADMAP.md queue A notes this bound)")
    if not 1 <= R <= STRIP_ROWS or C < 1:
        return (f"the strip kernel takes 1..{STRIP_ROWS} rows and >= 1 column (got "
                f"{R} x {C}); the long-pair sweep cuts longer queries into strips")
    return None


def stage_codes(x, params: ScoringParams, device) -> torch.Tensor:
    """Codes as the kernel reads them: uint8 on ``device``. uint8 codes
    pass as they are (the kernel clamps them to the table's last code);
    wider ones outside the alphabet map to that code (all -2^20), as the
    plain tile scores them."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.uint8:
        return x.to(device).contiguous()
    x = _vec(x, device, torch.int64)
    pad = _extended_table(params).shape[0] - 1
    ok = (x >= 0) & (x < params.alphabet_size)
    return torch.where(ok, x, torch.full_like(x, pad)).to(torch.uint8)


def _strip_fn(name):
    lib = _build.load(SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "swtpu_strip_tile":
            fn.argtypes = [i, i, p, p, p, i] + [p] * 9 + [i] * 4 + [p]
        else:
            fn.argtypes = [i, i, p, p, p, i] + [p] * 13 + [i] * 6 + [
                ctypes.POINTER(ctypes.c_int), p]
        fn.restype = ctypes.c_int
    return lib, fn


def _check_staged(q, t, table, top, topf, left_ext, left_ext_e, params: ScoringParams):
    """Refuses a tile the kernels do not take and inputs not staged as they
    read them; returns (R, C, affine)."""
    affine = not params.is_linear
    R, C = int(q.shape[0]), int(t.shape[0])
    reason = strip_refusal(params, R, C)
    if reason:
        raise NotImplementedError(reason)
    dev = q.device
    ins = [q, t, table, top, left_ext] + ([topf, left_ext_e] if affine else [])
    want = [(torch.uint8, (R,)), (torch.uint8, (C,)), (torch.int32, None),
            (torch.int32, (C,)), (torch.int32, (R + 1,))] + (
        [(torch.int32, (C,)), (torch.int32, (R + 1,))] if affine else [])
    for x, (dtype, shape) in zip(ins, want):
        if (x.device != dev or x.dtype != dtype or not x.is_contiguous()
                or (shape is not None and tuple(x.shape) != shape)):
            raise ValueError(
                f"the strip kernel takes contiguous {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return R, C, affine


def _outputs_and_args(q, t, table, top, topf, left_ext, left_ext_e, R, C, affine):
    """The tile's output tensors and the pointer arguments both kernels take."""
    i32 = dict(dtype=torch.int32, device=q.device)
    bottom = torch.empty((C,), **i32)
    right = torch.empty((R,), **i32)
    bottom_f = torch.empty((C,), **i32) if affine else bottom
    right_e = torch.empty((R,), **i32) if affine else right
    out3 = torch.empty((3,), **i32)
    args = (ptr(q), ptr(t), ptr(table), table.shape[0], ptr(top),
            ptr(topf if affine else top), ptr(left_ext),
            ptr(left_ext_e if affine else left_ext), ptr(bottom), ptr(bottom_f),
            ptr(right), ptr(right_e), ptr(out3))
    if affine:
        return (bottom, bottom_f, right, right_e, out3[0], out3[1], out3[2]), args
    return (bottom, right, out3[0], out3[1], out3[2]), args


def _pipe_launch(q, t, table, top, topf, left_ext, left_ext_e, params: ScoringParams,
                 br=None):
    """The pipelined kernel on staged inputs (see ``strip_launch_t``) at
    ``br`` rows a lane (default ``strip_plan``'s): (the tile's outputs, the
    warps launched, one a CTA). The kernel packs its endpoint's (value,
    row) in one key where the boundaries' largest value and
    :func:`h_reach` keep every H below KEY_MAX, else keeps them apart."""
    R, C, affine = _check_staged(q, t, table, top, topf, left_ext, left_ext_e, params)
    outs, args = _outputs_and_args(q, t, table, top, topf, left_ext, left_ext_e, R, C,
                                   affine)
    br = strip_plan(R, C)[0] if br is None else br
    bands = -(-R // (BAND_LANES * br))
    dev = q.device
    # band g > 0 reads band g - 1's last row: H, and for Gotoh pre and F
    hand = torch.zeros((max(1, (bands - 1) * (3 if affine else 1) * C),),
                       dtype=torch.int64, device=dev)
    done = torch.zeros((1,), dtype=torch.int32, device=dev)
    cands = torch.empty((3 * bands,), dtype=torch.int32, device=dev)
    # the largest boundary value, on the device (no sync): with h_reach it
    # tells the kernel whether the endpoint's packed key holds every H
    bmax = torch.maximum(top.max(), left_ext.max())
    if affine:
        bmax = torch.maximum(bmax, torch.maximum(topf.max(), left_ext_e.max()))
    reach = min(h_reach(params, R, C), KEY_MAX)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib, fn = _strip_fn("swtpu_strip_pipe")
        err = fn(int(affine), br, *args, ptr(hand), ptr(done), ptr(cands), ptr(bmax), R, C,
                 params.gap_open, params.gap_extend, bands, reach, ctypes.byref(grid),
                 stream)
    _build.check(lib, err, "sw_strip")
    return outs, grid.value


def strip_launch_t(q, t, table, top, topf, left_ext, left_ext_e, params: ScoringParams):
    """The launch alone, on inputs already staged on one CUDA device:
    q [R], t [C] uint8 (``stage_codes``), table the [stride, stride]
    extended table (``sw_profile.profile_table``), top [C], left_ext
    [R + 1] (corner first) int32, and for affine topf [C], left_ext_e
    [R + 1]. Returns the tile's outputs as the plain tile does. The
    pipelined kernel runs the tile in ``strip_plan(R, C)``'s row bands, a
    warp each, on as many SMs."""
    return _pipe_launch(q, t, table, top, topf, left_ext, left_ext_e, params)[0]


def _one_block_launch_t(q, t, table, top, topf, left_ext, left_ext_e,
                        params: ScoringParams):
    """The earlier one-CTA kernel on the same staged inputs and with the
    same returns as ``strip_launch_t``: off the main path, kept to be
    timed beside the pipelined kernel."""
    R, C, affine = _check_staged(q, t, table, top, topf, left_ext, left_ext_e, params)
    outs, args = _outputs_and_args(q, t, table, top, topf, left_ext, left_ext_e, R, C,
                                   affine)
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib, fn = _strip_fn("swtpu_strip_tile")
        err = fn(int(affine), rows_per_thread(R), *args, R, C, params.gap_open,
                 params.gap_extend, stream)
    _build.check(lib, err, "sw_strip")
    return outs


def _cuda_stage(q, t, table, params, dev):
    q = stage_codes(q, params, dev)
    t = stage_codes(t, params, dev)
    if table is None:
        table = profile_table(params, dev)
    return q, t, table


def tile_strip_linear(q, t, top_row, left_ext, params: ScoringParams, table=None):
    """One linear tile: (bottom_row, right_col, best, bi, bj), bit-equal
    to ``_tile_colscan``. ``left_ext`` [R + 1] is the
    corner then the left column; ``table`` (optional, CUDA only) is the
    extended table already on the card. Runs where ``top_row`` lies."""
    if not params.is_linear:
        raise ValueError("tile_strip_linear takes linear scoring")
    dev = top_row.device
    if dev.type == "cpu":
        return _tile_colscan(q, t, top_row, left_ext[1:], left_ext[0],
                             torch.as_tensor(_extended_table(params)),
                             params.alphabet_size, params.gap)
    q, t, table = _cuda_stage(q, t, table, params, dev)
    out = strip_launch_t(q, t, table, top_row, None, left_ext, None, params)
    tile_strip_linear.launches += 1
    return out


def tile_strip_affine(q, t, top_row, top_row_f, left_ext, left_ext_e,
                      params: ScoringParams, table=None):
    """One affine tile: (bottom_row, bottom_row_f, right_col, right_col_e,
    best, bi, bj), bit-equal to ``_tile_colscan_affine``.
    ``left_ext_e`` [R + 1] is -2^20 then the left column's E."""
    dev = top_row.device
    if dev.type == "cpu":
        return _tile_colscan_affine(
            q, t, top_row, top_row_f, left_ext[1:], left_ext_e[1:], left_ext[0],
            torch.as_tensor(_extended_table(params)), params.alphabet_size,
            params.gap_open, params.gap_extend)
    q, t, table = _cuda_stage(q, t, table, params, dev)
    out = strip_launch_t(q, t, table, top_row, top_row_f, left_ext, left_ext_e,
                         params)
    tile_strip_affine.launches += 1
    return out


tile_strip_linear.launches = 0
tile_strip_affine.launches = 0


def _left_ext(first, col, dev):
    """[first, col...] as one contiguous int32 vector on ``dev``."""
    return torch.cat([_vec(first, dev).reshape(1), _vec(col, dev)])


def strip_tile(q, t, top_row, left_col, corner, params: ScoringParams, device=None):
    """Standalone one-tile API: the returns of ``_tile_colscan`` (tensors
    on ``device``, default the card). Linear scoring only."""
    if not params.is_linear:
        raise NotImplementedError("affine standalone tile: use strip_tile_affine")
    dev = resolve_device(device, like=top_row)
    return tile_strip_linear(q, t, _vec(top_row, dev).contiguous(),
                             _left_ext(corner, left_col, dev), params)


def strip_tile_affine(q, t, top_row, top_row_f, left_col, left_col_e, corner,
                      params: ScoringParams, device=None):
    """Affine standalone one-tile API: the ``_tile_colscan_affine``
    7-tuple (tensors on ``device``, default the card)."""
    dev = resolve_device(device, like=top_row)
    return tile_strip_affine(
        q, t, _vec(top_row, dev).contiguous(), _vec(top_row_f, dev).contiguous(),
        _left_ext(corner, left_col, dev), _left_ext(NEGB, left_col_e, dev), params)
