"""Batched affine-gap (Gotoh) local scores and endpoints: the CUDA
row-scan kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/sw_affine.py`` (``sw_affine_pallas`` and
``sw_affine_pallas_ends``). The kernel is the affine instantiation of
``csrc/sw_rowscan.cu``: F comes from the previous row, E and H run along
the row, ``NEG_EF = -2^29`` stands for minus infinity. With
gap_open == gap_extend it equals the linear kernel. The plain versions
are ``affine_scan.py``. Same device rule and launch counters as
``sw_batch.py``.
"""

from __future__ import annotations

import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.affine_scan import (
    sw_affine_batch_diag,
    sw_affine_batch_diag_ends,
)
from swtpu_torch.kernels.sw_batch import _uniform_match_mismatch, rowscan_launch
from swtpu_torch.utils.device import resolve_device


def _guard_affine(params: ScoringParams):
    """(match, mismatch) for the affine kernel, or NotImplementedError."""
    mm = _uniform_match_mismatch(params)
    if mm is None:
        raise NotImplementedError(
            "general matrices need the profile kernel, not ported yet "
            "(ROADMAP.md, queue B: sw_profile)"
        )
    if params.gap_open <= 0 or params.gap_extend <= 0:
        raise NotImplementedError(
            "the affine row-scan kernel needs gap_open, gap_extend > 0 (got "
            f"{params.gap_open}, {params.gap_extend}); no kernel in ROADMAP.md "
            "queue B takes a non-positive gap: run it on the CPU"
        )
    return mm


def sw_affine_plain(qs, ts, params: ScoringParams, device=None):
    """Plain PyTorch version of :func:`sw_affine`."""
    return sw_affine_batch_diag(qs, ts, params, device)


def sw_affine_ends_plain(qs, ts, params: ScoringParams, device=None):
    """Plain PyTorch version of :func:`sw_affine_ends`."""
    return sw_affine_batch_diag_ends(qs, ts, params, device)


def sw_affine(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Batched affine-gap local scores, uniform scoring.

    Returns [B] int32 on ``device`` (default: the card), equal to
    ``oracle.affine.sw_affine_score`` per unpadded pair, for any
    match/mismatch and gap_open, gap_extend > 0.
    """
    match, mismatch = _guard_affine(params)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_affine_plain(qs, ts, params, dev)
    out = rowscan_launch(qs, ts, params, match, mismatch, dev, True, False)
    sw_affine.launches += 1
    return out


def sw_affine_ends(qs, ts, params: ScoringParams, device=None):
    """Batched affine-gap local scores + row-major-first argmax endpoints
    (score 0 maps to (0, 0)). Same guards as :func:`sw_affine`."""
    match, mismatch = _guard_affine(params)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_affine_ends_plain(qs, ts, params, dev)
    out = rowscan_launch(qs, ts, params, match, mismatch, dev, True, True)
    sw_affine_ends.launches += 1
    return out


sw_affine.launches = 0
sw_affine_ends.launches = 0
