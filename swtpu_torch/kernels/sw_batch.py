"""Batched local-alignment scores and endpoints, linear gap: the CUDA
row-scan kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/sw_batch.py`` (``sw_batch_pallas`` and
``sw_batch_pallas_ends``). The kernel is ``csrc/sw_rowscan.cu``, whose
head note says what it replaces, what bounds it and how. The plain
versions are the anti-diagonal tier of ``sw_scan.py``.

``sw_batch`` and ``sw_batch_ends`` check the kernel's guards (uniform
matrix, linear gap > 0) and then run where their device says: on the CPU
the plain version, on a CUDA device the kernel. On the card they never
run the plain version; a failed build or launch raises. Each counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.sw_scan import sw_batch_diag, sw_batch_diag_ends
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_rowscan.cu"


def _uniform_match_mismatch(params: ScoringParams):
    """(match, mismatch) if the matrix is uniform, else None."""
    mat = params.matrix
    diag = np.diag(mat)
    off = mat[~np.eye(mat.shape[0], dtype=bool)]
    if (diag == diag[0]).all() and (off == off[0]).all():
        return int(diag[0]), int(off[0])
    return None


def _guard_linear(params: ScoringParams):
    """(match, mismatch) for the linear kernel, or NotImplementedError."""
    if not params.is_linear:
        raise NotImplementedError("affine scoring: use sw_affine")
    mm = _uniform_match_mismatch(params)
    if mm is None:
        raise NotImplementedError(
            "general matrices need the profile kernel, not ported yet "
            "(ROADMAP.md, queue B: sw_profile)"
        )
    if params.gap <= 0:
        raise NotImplementedError(
            f"the row-scan kernel needs gap > 0 (got {params.gap}); no kernel "
            "in ROADMAP.md queue B takes a non-positive gap: run it on the CPU"
        )
    return mm


def _rowscan_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_rowscan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p] + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def rowscan_launch(qs, ts, params: ScoringParams, match: int, mismatch: int,
                   device: torch.device, affine: bool, ends: bool):
    """Launch one instantiation of the row-scan kernel on ``device``.

    Transposes the [B, n] / [B, m] codes to [n, B] / [m, B] uint8 so that
    a warp's loads coalesce, then runs :func:`rowscan_launch_t`. Returns
    int32 [B] score, or (score, end_i, end_j).
    """
    if device.type != "cuda":
        raise ValueError(f"the row-scan kernel runs on CUDA, not {device}")
    qs = as_codes(qs, device)
    ts = as_codes(ts, device)
    if ts.shape[0] != qs.shape[0]:
        raise ValueError(
            f"batch mismatch: {qs.shape[0]} queries vs {ts.shape[0]} targets"
        )
    return rowscan_launch_t(qs.t().contiguous(), ts.t().contiguous(), params,
                            match, mismatch, affine, ends)


def rowscan_launch_t(qT, tT, params: ScoringParams, match: int, mismatch: int,
                     affine: bool, ends: bool):
    """The launch alone, on codes already in the kernel's layout: qT
    [n, B] and tT [m, B] contiguous uint8 on one CUDA device. Allocates
    the [m, B] int32 previous-row scratch (H, and F for affine) and the
    outputs there, and launches on that device's current stream."""
    device = qT.device
    for x in (qT, tT):
        if (x.dtype != torch.uint8 or x.device != device
                or device.type != "cuda" or not x.is_contiguous()):
            raise ValueError(
                "the row-scan kernel takes contiguous uint8 codes on one "
                f"CUDA device, got {x.dtype} on {x.device}"
            )
    n, B = qT.shape
    m = tT.shape[0]
    if tT.shape[1] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {tT.shape[1]} targets")
    if max(B, n, m) >= 2**31:  # the C interface takes int sizes
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    i32 = dict(dtype=torch.int32, device=device)
    hrow = torch.empty((m, B), **i32)
    frow = torch.empty((m, B), **i32) if affine else None
    score = torch.empty((B,), **i32)
    end_i = torch.empty((B,), **i32) if ends else None
    end_j = torch.empty((B,), **i32) if ends else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib, fn = _rowscan_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            int(affine), int(ends), ptr(qT), ptr(tT), ptr(hrow), ptr(frow),
            ptr(score), ptr(end_i), ptr(end_j), B, n, m,
            params.alphabet_size, match, mismatch,
            params.gap_open, params.gap_extend, stream,
        )
    _build.check(lib, err, "sw_rowscan")
    return (score, end_i, end_j) if ends else score


def sw_batch_plain(qs, ts, params: ScoringParams, device=None):
    """Plain PyTorch version of :func:`sw_batch` (the anti-diagonal tier)."""
    return sw_batch_diag(qs, ts, params, device)


def sw_batch_ends_plain(qs, ts, params: ScoringParams, device=None):
    """Plain PyTorch version of :func:`sw_batch_ends`."""
    return sw_batch_diag_ends(qs, ts, params, device)


def sw_batch(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Batched local-alignment scores, uniform scoring, linear gap.

    qs: [B, n] codes (0-3, pads >= 4), ts: [B, m] codes; numpy or torch.
    Returns [B] int32 on ``device`` (default: the card), equal to
    ``oracle.sw_score`` per unpadded pair, for any match/mismatch and
    gap > 0. Raises NotImplementedError outside those guards.
    """
    match, mismatch = _guard_linear(params)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_batch_plain(qs, ts, params, dev)
    out = rowscan_launch(qs, ts, params, match, mismatch, dev, False, False)
    sw_batch.launches += 1
    return out


def sw_batch_ends(qs, ts, params: ScoringParams, device=None):
    """Batched local scores + argmax endpoints, uniform scoring, linear gap.

    Returns (score, end_i, end_j) int32 [B]: the 1-based first maximum in
    row-major scan order (the oracle's ``np.argmax``); score 0 maps to
    (0, 0). Same guards as :func:`sw_batch`.
    """
    match, mismatch = _guard_linear(params)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_batch_ends_plain(qs, ts, params, dev)
    out = rowscan_launch(qs, ts, params, match, mismatch, dev, False, True)
    sw_batch_ends.launches += 1
    return out


sw_batch.launches = 0
sw_batch_ends.launches = 0
