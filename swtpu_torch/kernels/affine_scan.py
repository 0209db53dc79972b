"""Batched affine-gap (Gotoh) Smith-Waterman — the plain PyTorch tier.

Port of ``swtpu/kernels/xla/affine_scan.py``: the anti-diagonal schedule
of ``sw_scan.py`` with two more carried diagonals (E, F). It is the plain
version of both affine row-scan kernels (``sw_affine.sw_affine`` and
``sw_affine_ends``). The pad-code design again makes phantom and padded
cells unable to beat any real cell, so variable lengths come free.
"""

from __future__ import annotations

import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.sw_scan import (
    _shift1,
    diag_setup,
    select_scores,
    track_endpoint,
)

NEG_EF = -(2**29)


def _affine_scan(qs, ts, params: ScoringParams, device, ends: bool):
    prof, ts_rev_pad, n, m, n_codes = diag_setup(qs, ts, params, device)
    go, ge = int(params.gap_open), int(params.gap_extend)
    B, dev = prof.shape[0], prof.device
    h1 = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    h2 = h1
    e1 = torch.full((B, n + 1), NEG_EF, dtype=torch.int32, device=dev)
    f1 = e1
    best = torch.zeros((B,), dtype=torch.int32, device=dev)
    bi, bj = best, best
    rows = torch.arange(n + 1, dtype=torch.int32, device=dev)[None, :]
    for d in range(2, n + m + 1):
        off = m - d + n + 1
        s = select_scores(prof, ts_rev_pad[:, off : off + n + 1], n_codes)
        e = torch.maximum(e1 - ge, h1 - go)
        f = torch.maximum(_shift1(f1, NEG_EF) - ge, _shift1(h1, NEG_EF) - go)
        h = torch.maximum(
            torch.clamp(_shift1(h2, NEG_EF) + s, min=0), torch.maximum(e, f)
        )
        if ends:
            # same row-major-first endpoint rule as the linear engine
            best, bi, bj = track_endpoint(h, d, rows, best, bi, bj)
        else:
            best = torch.maximum(best, h.amax(dim=1))
        h2, h1, e1, f1 = h1, h, e, f
    if not ends:
        return best
    pos = best > 0
    zero = torch.zeros_like(best)
    return best, torch.where(pos, bi, zero), torch.where(pos, bj, zero)


def sw_affine_batch_diag(qs, ts, params: ScoringParams, device=None):
    """Batched affine-gap local-alignment scores.

    qs: [B, n] uint8 (pad 4), ts: [B, m] uint8 (pad 5) → [B] int32 on
    ``device``, equal to ``oracle.affine.sw_affine_score`` per pair. With
    gap_open == gap_extend, equal to the linear-gap tier.
    """
    return _affine_scan(qs, ts, params, device, ends=False)


def sw_affine_batch_diag_ends(qs, ts, params: ScoringParams, device=None):
    """Batched affine-gap local scores + argmax endpoints.

    Returns (score, end_i, end_j) int32 [B] with the row-major-first
    argmax tie-break of ``oracle.affine.sw_affine_traceback``. Score 0
    maps to (0, 0).
    """
    return _affine_scan(qs, ts, params, device, ends=True)
