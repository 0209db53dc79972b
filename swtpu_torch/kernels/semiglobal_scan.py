"""Batched semi-global and global (Needleman-Wunsch) alignment over
anti-diagonals: scores and endpoints — the plain PyTorch tier.

Port of ``swtpu/kernels/xla/semiglobal_scan.py``. It is the plain version
of both semi-global kernels (``semiglobal_batch.semiglobal_batch``,
uniform scoring, and ``semiglobal_profile.semiglobal_profile``, a general
matrix): on the CPU it is the engine for every scoring, and on the card
it is what ``chip_smoke.py`` holds the kernels against.

Semantics (≙ ``SemiGlobal_111``, source.cpp:1776-1834, generalized): no
zero floor, the alignment is anchored at the top-left corner, boundaries
are gap chains (H[0, j] = -j*gap, H[i, 0] = -i*gap; affine
-go - (k-1)*ge), and the score and endpoint are the matrix-wide maximum:
the first maximum in row-major scan order over each pair's real
[0..lq] x [0..lt] region, H[0, 0] = 0 included. With ``pin_end`` the
endpoint is each pair's (lq, lt) corner instead: GLOBAL alignment, the
same forward pass read elsewhere.

Schedule: the XLA tier's. Slot i of a diagonal vector holds DP row i;
diagonal d holds cells (i, d - i). Boundary cells are written by masks,
phantom cells (j < 0 or j > m) are clamped to -2^30 every step. Real
cells never read padded cells, so the padded DP is exact and varlen
needs only the masked tracking. Each slot keeps its best value and its
smallest column (strict '>' as d ascends); the final reduction takes the
maximum and, on ties, the smallest row.

Pads follow the XLA tier, which differs from the oracle and the TPU
kernels: under uniform scoring any code >= 4 scores -mismatch, even
against an equal code; under a matrix every pad scores -2^20 (the
extended table of ``sw_scan``).
"""

from __future__ import annotations

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.sw_scan import _shift1, diag_setup, select_scores
from swtpu_torch.utils.device import as_codes, resolve_device

Q_PAD = 4
T_PAD = 5
MINUS_INF = -(2**30)


def _lens_cols(B: int, n: int, m: int, lens_q, lens_t, dev):
    """[B, 1] int32 per-pair real lengths on ``dev`` (defaults: the full
    widths)."""
    lq = np.full(B, n) if lens_q is None else lens_q
    lt = np.full(B, m) if lens_t is None else lens_t
    return (
        torch.as_tensor(lq, dtype=torch.int32, device=dev).reshape(B, 1),
        torch.as_tensor(lt, dtype=torch.int32, device=dev).reshape(B, 1),
    )


def gaps(gap=1, gap_open=None, gap_extend=None):
    """(go, ge, affine) of the uniform entries' gap arguments: affine when
    gap_open is given and differs from gap_extend, else linear with gap
    (or gap_open)."""
    if gap_open is not None and gap_open != gap_extend:
        return int(gap_open), int(gap_extend), True
    g = int(gap if gap_open is None else gap_open)
    return g, g, False


def _uniform_setup(qs, ts, match: int, mismatch: int, dev):
    """The XLA uniform tier's scores: ``s_of(d)`` gives the [B, n + 1]
    int32 scores of diagonal d (match where the codes are equal and
    below 4, else -mismatch; slot 0 is a pad)."""
    qs = as_codes(qs, dev)
    ts = as_codes(ts, dev)
    B, n = qs.shape
    m = ts.shape[1]
    if ts.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {ts.shape[0]} targets")
    q_slot = torch.cat([qs.new_full((B, 1), Q_PAD), qs], dim=1)
    q_real = q_slot < 4
    frame = torch.full((B, n + 1), T_PAD, dtype=torch.uint8, device=dev)
    ts_rev_pad = torch.cat([frame, ts.flip(1), frame], dim=1)
    hit = torch.tensor(int(match), dtype=torch.int32, device=dev)
    miss = torch.tensor(-int(mismatch), dtype=torch.int32, device=dev)

    def s_of(d):
        off = m - d + n + 1
        t_diag = ts_rev_pad[:, off : off + n + 1]
        return torch.where(q_real & (q_slot == t_diag), hit, miss)

    return s_of, B, n, m


def _table_setup(qs, ts, params: ScoringParams, dev):
    """The XLA table tier's scores (pads -2^20), as ``_uniform_setup``."""
    prof, ts_rev_pad, n, m, n_codes = diag_setup(qs, ts, params, dev)

    def s_of(d):
        off = m - d + n + 1
        return select_scores(prof, ts_rev_pad[:, off : off + n + 1], n_codes)

    return s_of, prof.shape[0], n, m


def _scan(s_of, B, n, m, lq, lt, go: int, ge: int, affine: bool,
          pin_end: bool, dev):
    """The forward pass and the endpoint reduction of all four XLA scan
    bodies (linear gap: go == ge). Returns (score, end_i, end_j) int32
    [B]."""
    i32 = dict(dtype=torch.int32, device=dev)
    iota = torch.arange(n + 1, **i32)[None, :]
    h1 = torch.full((B, n + 1), MINUS_INF, **i32)  # diagonal 0: H[0, 0] = 0
    h1[:, 0] = 0
    h2 = torch.full((B, n + 1), MINUS_INF, **i32)
    e1 = f1 = h2
    if pin_end:  # H[0, 0] is the endpoint only of the empty pair
        init = (iota == 0) & (lq == 0) & (lt == 0)
    else:
        init = (iota == 0).expand(B, n + 1)
    best_v = torch.where(init, torch.zeros((), **i32), h2)
    best_j = torch.zeros((B, n + 1), **i32)
    for d in range(1, n + m + 1):
        s = s_of(d)
        bnd = -go - (d - 1) * ge  # H on the boundary chains at distance d
        if affine:
            # Gotoh on anti-diagonals: E's predecessors (i, j-1) sit at the
            # same slot of d-1; F's (i-1, j) one slot down of d-1
            e = torch.maximum(e1 - ge, h1 - go)
            f = torch.maximum(_shift1(f1, MINUS_INF) - ge,
                              _shift1(h1, MINUS_INF) - go)
            cur = torch.maximum(_shift1(h2, MINUS_INF) + s, torch.maximum(e, f))
            e[:, 0] = bnd if d <= m else MINUS_INF
            if d <= n:
                f[:, d] = bnd
        else:
            cur = torch.maximum(
                torch.maximum(_shift1(h2, MINUS_INF) + s,
                              _shift1(h1, MINUS_INF) - go),
                h1 - go,
            )
        cur[:, 0] = bnd if d <= m else MINUS_INF
        if d <= n:
            cur[:, d] = bnd
        j_of = d - iota
        phantom = (j_of < 0) | (j_of > m)
        cur = cur.masked_fill(phantom, MINUS_INF)
        if affine:
            e = e.masked_fill(phantom, MINUS_INF)
            f = f.masked_fill(phantom, MINUS_INF)
        if pin_end:
            upd = (cur > best_v) & (iota == lq) & (j_of == lt)
        else:
            upd = (cur > best_v) & (iota <= lq) & (j_of <= lt) & (j_of >= 0)
        best_v = torch.where(upd, cur, best_v)
        best_j = torch.where(upd, j_of, best_j)
        h2, h1 = h1, cur
        if affine:
            e1, f1 = e, f
    # cross-slot reduction: max value, ties -> smallest i (slot index)
    score = best_v.amax(dim=1)
    is_max = best_v == score[:, None]
    big = torch.full_like(best_v, n + m + 2)
    end_i = torch.where(is_max, iota, big).amin(dim=1)
    end_j = best_j.gather(1, end_i[:, None].long())[:, 0]
    return score, end_i, end_j


def semiglobal_batch_diag(
    qs, ts, match=1, mismatch=1, gap=1, gap_open=None, gap_extend=None,
    lens_q=None, lens_t=None, pin_end=False, device=None,
):
    """Batched semi-global scores + argmax endpoints, uniform scoring.

    qs: [B, n], ts: [B, m] codes (numpy or torch); per-pair real lengths
    via ``lens_q`` / ``lens_t``. ``mismatch`` is a positive penalty
    (scored -mismatch); affine when gap_open is given and differs from
    gap_extend. Returns (score, end_i, end_j) int32 [B] on ``device``
    (default: the card), equal to ``oracle.semiglobal_full`` /
    ``semiglobal_affine_full`` on each pair's unpadded lengths (codes
    below 4). ``pin_end`` reads each pair's (lq, lt) corner: global.
    """
    dev = resolve_device(device, like=qs)
    s_of, B, n, m = _uniform_setup(qs, ts, match, mismatch, dev)
    lq, lt = _lens_cols(B, n, m, lens_q, lens_t, dev)
    return _scan(s_of, B, n, m, lq, lt, *gaps(gap, gap_open, gap_extend),
                 pin_end, dev)


def semiglobal_batch_general(
    qs, ts, params: ScoringParams, lens_q=None, lens_t=None, pin_end=False,
    device=None,
):
    """Batched semi-global scores + endpoints for a general substitution
    matrix (DNA 4x4 or protein/BLOSUM62), linear or affine gaps.

    Same contract as :func:`semiglobal_batch_diag`, scores from
    ``params.matrix``; matches ``oracle.semiglobal_full`` /
    ``semiglobal_affine_full`` with ``matrix=``.
    """
    dev = resolve_device(device, like=qs)
    s_of, B, n, m = _table_setup(qs, ts, params, dev)
    lq, lt = _lens_cols(B, n, m, lens_q, lens_t, dev)
    return _scan(s_of, B, n, m, lq, lt, int(params.gap_open),
                 int(params.gap_extend), not params.is_linear, pin_end, dev)


def nw_batch_diag(
    qs, ts, match=1, mismatch=1, gap=1, gap_open=None, gap_extend=None,
    lens_q=None, lens_t=None, device=None,
):
    """Batched GLOBAL (Needleman-Wunsch) scores, uniform scoring: [B]
    int32, the pinned read-out of :func:`semiglobal_batch_diag`. Matches
    ``oracle.nw_full`` / ``nw_affine_full`` on the unpadded lengths."""
    score, _, _ = semiglobal_batch_diag(
        qs, ts, match, mismatch, gap, gap_open=gap_open,
        gap_extend=gap_extend, lens_q=lens_q, lens_t=lens_t, pin_end=True,
        device=device,
    )
    return score


def nw_batch_general(qs, ts, params: ScoringParams, lens_q=None, lens_t=None,
                     device=None):
    """Batched GLOBAL scores for a general substitution matrix, linear or
    affine gaps — see :func:`nw_batch_diag`."""
    score, _, _ = semiglobal_batch_general(
        qs, ts, params, lens_q=lens_q, lens_t=lens_t, pin_end=True,
        device=device,
    )
    return score
