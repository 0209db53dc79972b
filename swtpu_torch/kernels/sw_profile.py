"""Batched local-alignment scores and endpoints under a general
substitution matrix (4x4 DNA, protein with BLOSUM62), linear or affine
gaps: the CUDA profile kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/sw_profile.py`` (``sw_batch_profile_pallas``
and ``sw_batch_profile_pallas_ends``). The kernel is ``csrc/sw_profile.cu``,
whose head note says what it replaces, what bounds it and how; it looks
each cell's score up in the plain tier's extended table
(``sw_scan._extended_table``), which the wrapper copies to the card once
per scoring. The plain versions are the anti-diagonal tiers
(``sw_scan.py`` linear, ``affine_scan.py`` affine).

``sw_profile`` and ``sw_profile_ends`` check the kernel's guards (at most
30 letters, entries in [-127, 127], gaps > 0; a uniform matrix passes
them too) and then run where their device says: on the CPU the plain
version, on a CUDA device the kernel, which they never replace with the
plain version; a failed build or launch raises. Each counts its launches
in ``<wrapper>.launches``, and those of the affine instantiation also in
``<wrapper>.launches_affine``.

Unlike the TPU kernel there is no ``m > 2048`` transposition and no
packed-comb overflow guard: the scratch lives in device memory and the
endpoint keeps values and rows apart.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.affine_scan import (
    sw_affine_batch_diag,
    sw_affine_batch_diag_ends,
)
from swtpu_torch.kernels.sw_batch import kernel_layout, launch_buffers, ptr
from swtpu_torch.kernels.sw_scan import (
    _extended_table,
    sw_batch_diag,
    sw_batch_diag_ends,
)
from swtpu_torch.utils.device import resolve_device

SOURCE = "sw_profile.cu"
MAX_LETTERS = 30  # the kernel's table is at most 32 x 32, two codes for pads

_tables: Dict[Tuple[bytes, Tuple[int, ...], str], torch.Tensor] = {}


def profile_refusal(params: ScoringParams):
    """Why the profile kernel does not take ``params`` (the JAX entries'
    guards, and the table's size), or None when it does."""
    mat = params.matrix
    if params.alphabet_size > MAX_LETTERS:
        return (f"the profile kernel takes at most {MAX_LETTERS} letters (got "
                f"{params.alphabet_size}); no kernel in ROADMAP.md queue B takes "
                "more: run it on the CPU")
    if mat.min() < -127 or mat.max() > 127:
        return ("the profile kernel takes matrix entries in [-127, 127] (got "
                f"[{int(mat.min())}, {int(mat.max())}]); no kernel in ROADMAP.md "
                "queue B takes wider ones: run it on the CPU")
    if params.gap_open <= 0 or params.gap_extend <= 0:
        return ("the profile kernel needs gap_open, gap_extend > 0 (got "
                f"{params.gap_open}, {params.gap_extend}); no kernel in ROADMAP.md "
                "queue B takes a non-positive gap: run it on the CPU")
    return None


def _guard_profile(params: ScoringParams) -> None:
    """Raise NotImplementedError for scoring the profile kernel does not
    take."""
    reason = profile_refusal(params)
    if reason:
        raise NotImplementedError(reason)


def profile_table(params: ScoringParams, device: torch.device) -> torch.Tensor:
    """The [stride, stride] int32 extended table on ``device``, built once
    per scoring and device (a host-to-device copy would stall the stream
    on every call)."""
    key = (params.matrix.tobytes(), params.matrix.shape, str(device))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= 64:
            _tables.clear()
        table = torch.as_tensor(_extended_table(params), device=device)
        _tables[key] = table
    return table


def _profile_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_profile
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [p] * 8 + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def profile_launch(qs, ts, params: ScoringParams, device: torch.device,
                   ends: bool):
    """Launch the profile kernel on ``device``: the codes go to the
    kernel's [L, B] layout (``sw_batch.kernel_layout``), then
    :func:`profile_launch_t`. Returns int32 [B] score, or (score, end_i,
    end_j)."""
    qT, tT = kernel_layout(qs, ts, device, "profile")
    return profile_launch_t(qT, tT, profile_table(params, device), params, ends)


def profile_launch_t(qT, tT, table, params: ScoringParams, ends: bool):
    """The launch alone, on codes already in the kernel's layout (qT
    [n, B], tT [m, B] contiguous uint8 on one CUDA device) and the table
    of :func:`profile_table` there. The instantiation is affine unless
    gap_open == gap_extend. Allocates the scratch and the outputs and
    launches on the device's current stream."""
    affine = not params.is_linear
    B, n, m, hrow, frow, score, end_i, end_j = launch_buffers(
        qT, tT, affine, ends, "profile"
    )
    stride = table.shape[0]
    if (table.dtype != torch.int32 or table.device != qT.device
            or table.shape != (stride, stride) or not table.is_contiguous()):
        raise ValueError(
            "the profile kernel takes a square contiguous int32 table on the "
            f"codes' device, got {table.dtype} {tuple(table.shape)} on "
            f"{table.device}"
        )
    lib, fn = _profile_fn()
    with torch.cuda.device(qT.device):
        stream = torch.cuda.current_stream(qT.device).cuda_stream
        err = fn(
            int(affine), int(ends), ptr(qT), ptr(tT), ptr(table), ptr(hrow),
            ptr(frow), ptr(score), ptr(end_i), ptr(end_j), B, n, m, stride,
            params.gap_open, params.gap_extend, stream,
        )
    _build.check(lib, err, "sw_profile")
    return (score, end_i, end_j) if ends else score


def sw_profile_plain(qs, ts, params: ScoringParams, device=None):
    """Plain PyTorch version of :func:`sw_profile` (the anti-diagonal
    tier, linear or affine)."""
    if params.is_linear:
        return sw_batch_diag(qs, ts, params, device)
    return sw_affine_batch_diag(qs, ts, params, device)


def sw_profile_ends_plain(qs, ts, params: ScoringParams, device=None):
    """Plain PyTorch version of :func:`sw_profile_ends`."""
    if params.is_linear:
        return sw_batch_diag_ends(qs, ts, params, device)
    return sw_affine_batch_diag_ends(qs, ts, params, device)


def _count(wrapper, params: ScoringParams) -> None:
    wrapper.launches += 1
    if not params.is_linear:
        wrapper.launches_affine += 1


def sw_profile(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Batched local-alignment scores under a general matrix, linear or
    affine (Gotoh) gaps.

    qs: [B, n] codes 0..A-1 (pad A), ts: [B, m] codes (pad A+1), where A
    is the alphabet size (4 DNA, 24 protein); numpy or torch. Returns [B]
    int32 on ``device`` (default: the card), equal to ``oracle.sw_score`` /
    ``oracle.affine.sw_affine_score`` per unpadded pair. Raises
    NotImplementedError outside the guards.
    """
    _guard_profile(params)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_profile_plain(qs, ts, params, dev)
    out = profile_launch(qs, ts, params, dev, ends=False)
    _count(sw_profile, params)
    return out


def sw_profile_ends(qs, ts, params: ScoringParams, device=None):
    """Batched general-matrix local scores + argmax endpoints: (score,
    end_i, end_j) int32 [B], the 1-based first maximum in row-major scan
    order; score 0 maps to (0, 0). Same guards as :func:`sw_profile`."""
    _guard_profile(params)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_profile_ends_plain(qs, ts, params, dev)
    out = profile_launch(qs, ts, params, dev, ends=True)
    _count(sw_profile_ends, params)
    return out


sw_profile.launches = 0
sw_profile.launches_affine = 0
sw_profile_ends.launches = 0
sw_profile_ends.launches_affine = 0
