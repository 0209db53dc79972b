"""Batched fixed-band local-alignment scores (|i - j| <= W): the CUDA
kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/sw_banded.py`` (``sw_banded_static_pallas``,
``sw_banded_profile_pallas``, ``_apply_lens``). The kernel is
``csrc/sw_banded.cu``, whose head note says what it replaces, what bounds
it and how. The JAX package has no XLA fixed-band tier (off the TPU it
runs the numpy oracle), so the plain version here is the port's own: the
anti-diagonal schedule of ``sw_scan.py`` / ``affine_scan.py`` with the
corridor as a mask, held to ``oracle.banded_static`` by the tests.

The contract is ``oracle.banded_static.sw_banded_static_score`` (local
alignment restricted to the corridor), with one addition for codes the
oracle cannot index: a pad (any code >= the alphabet size) scores
``matrix.min()`` against anything, the banded oracles' and the mapper's
rule (``swtpu/models/mapper.py:351-366``). Tail pads can then only lose
(for a matrix with a negative entry), so ``lens_q`` / ``lens_t``, which
overwrite positions past each pair's length with pads, give the score of
the unpadded pair.

``sw_banded_static`` (uniform matrix, mismatch < 0 < gap) and
``sw_banded_profile`` (any matrix of at most 30 letters, gap > 0) check
the Pallas entries' guards and raise NotImplementedError outside them;
then they run where their device says: on the CPU the plain version, on a
CUDA device the kernel, never the plain version there; a failed build or
launch raises. ``sw_banded_plain`` takes any scoring. Each wrapper counts
its launches in ``<wrapper>.launches``, those of the affine instantiation
also in ``<wrapper>.launches_affine``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.banded_scan import _banded_ext_table
from swtpu_torch.kernels.sw_batch import _uniform_match_mismatch, kernel_layout, ptr
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_banded.cu"
NEG = -(2**29)  # the oracle's dead value
MAX_LETTERS = 30  # the kernel's table is at most 32 x 32, two codes for pads

_tables: Dict[Tuple[bytes, Tuple[int, ...], str], torch.Tensor] = {}


def _apply_lens(qs, ts, lens_q, lens_t, q_pad, t_pad, device):
    """[B, n] / [B, m] uint8 codes on ``device`` with positions past each
    pair's length overwritten by the pad codes (pads only lose, so
    variable-length batches need nothing else)."""

    def cut(x, lens, pad):
        if lens is None:
            return x
        lens = torch.as_tensor(lens, device=device).to(torch.int64)
        keep = torch.arange(x.shape[1], device=device)[None, :] < lens[:, None]
        return torch.where(keep, x, torch.tensor(pad, dtype=torch.uint8, device=device))

    return (cut(as_codes(qs, device), lens_q, q_pad),
            cut(as_codes(ts, device), lens_t, t_pad))


def _check_width(bandwidth) -> int:
    W = int(bandwidth)
    if W < 0:
        raise ValueError(f"bandwidth must be >= 0, got {W}")
    return W


def sw_banded_plain(qs, ts, params: ScoringParams, bandwidth=32, lens_q=None,
                    lens_t=None, device=None) -> torch.Tensor:
    """Plain PyTorch fixed-band scores, any scoring: [B] int32 on
    ``device``, equal per pair to the oracle (pads at matrix.min()).

    Anti-diagonal schedule: slot i of diagonal d holds cell (i, d - i),
    slot 0 the boundary row. Cells inside the matrix and the corridor are
    computed; boundary cells in the corridor are 0 and every other cell is
    the oracle's dead value (-2^29, E and F too), so any scoring is exact.
    """
    dev = resolve_device(device, like=qs)
    W = _check_width(bandwidth)
    A = params.alphabet_size
    qs, ts = _apply_lens(qs, ts, lens_q, lens_t, A, A + 1, dev)
    table = torch.as_tensor(_banded_ext_table(params.matrix), device=dev)
    stride = table.shape[0]
    table = table.reshape(-1)
    B, n = qs.shape
    m = ts.shape[1]
    if ts.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {ts.shape[0]} targets")
    if n == 0 or m == 0:
        return torch.zeros((B,), dtype=torch.int32, device=dev)
    # table row offset of each query slot (slot 0: a pad, never computed)
    q_off = torch.cat([qs.new_full((B, 1), stride - 1), qs], dim=1).to(torch.int64)
    q_off = q_off.clamp(max=stride - 1) * stride
    t_cl = ts.to(torch.int64).clamp(max=stride - 1)
    affine = not params.is_linear
    go, ge = int(params.gap_open), int(params.gap_extend)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.arange(n + 1, device=dev)
    neg = torch.tensor(NEG, **i32)

    def masks(d):
        """(interior, value of every other cell) on diagonal d."""
        j = d - rows
        band = (rows - j).abs() <= W
        inside = (j >= 0) & (j <= m) & band
        interior = inside & (rows >= 1) & (j >= 1)
        base = torch.where(inside & ~interior, torch.zeros((), **i32), neg)
        return interior, j, base

    def shift(x):  # slot i takes slot i - 1 of x: the row above
        return torch.cat([torch.full_like(x[:, :1], NEG), x[:, :-1]], dim=1)

    h2 = masks(0)[2].expand(B, n + 1)
    h1 = masks(1)[2].expand(B, n + 1)
    e1 = f1 = torch.full((B, n + 1), NEG, **i32)
    best = torch.zeros((B,), **i32)
    for d in range(2, n + m + 1):
        interior, j, base = masks(d)
        s = table[q_off + t_cl[:, (j - 1).clamp(0, m - 1)]]
        diag = shift(h2) + s
        if affine:
            e = torch.maximum(e1 - ge, h1 - go)
            f = torch.maximum(shift(f1) - ge, shift(h1) - go)
            h = torch.maximum(torch.clamp(diag, min=0), torch.maximum(e, f))
            e1 = torch.where(interior, e, neg)
            f1 = torch.where(interior, f, neg)
        else:
            h = torch.maximum(torch.maximum(diag, shift(h1) - go),
                              torch.clamp(h1 - go, min=0))
        h = torch.where(interior, h, base)
        best = torch.maximum(best, h.amax(dim=1))
        h2, h1 = h1, h
    return best


def static_refusal(params: ScoringParams):
    """Why the uniform form of the fixed-band kernel does not take
    ``params`` (``sw_banded_static_pallas``'s guards), or None."""
    mm = _uniform_match_mismatch(params)
    if mm is None:
        return ("the fixed-band kernel's uniform form needs a uniform matrix: "
                "use sw_banded_profile, its general-matrix form (ROADMAP.md queue "
                "B item 8)")
    if mm[1] >= 0 or params.gap_extend <= 0:
        return (f"the fixed-band kernel's dead-is-zero layout needs mismatch < 0 < "
                f"gap (got mismatch {mm[1]}, gap {params.gap_extend}); no kernel in "
                "ROADMAP.md queue B takes these: run sw_banded_plain on the CPU")
    return None


def profile_refusal(params: ScoringParams):
    """Why the profile form of the fixed-band kernel does not take
    ``params`` (``sw_banded_profile_pallas``'s guard, and the table's
    size), or None."""
    if params.alphabet_size > MAX_LETTERS:
        return (f"the fixed-band profile kernel takes at most {MAX_LETTERS} letters "
                f"(got {params.alphabet_size}); no kernel in ROADMAP.md queue B "
                "takes more: run sw_banded_plain on the CPU")
    if params.gap_extend <= 0:
        return ("the fixed-band kernel's dead-is-zero layout needs gap > 0 (got "
                f"{params.gap_extend}); no kernel in ROADMAP.md queue B takes it: run "
                "sw_banded_plain on the CPU")
    return None


def _guard(reason) -> None:
    if reason:
        raise NotImplementedError(reason)


def banded_table(matrix, device: torch.device) -> torch.Tensor:
    """The banded extended table of ``matrix`` (pads at matrix.min()) on
    ``device``, built once per matrix and device (a host-to-device copy
    would stall the stream on every call)."""
    matrix = np.asarray(matrix, dtype=np.int32)
    key = (matrix.tobytes(), matrix.shape, str(device))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= 64:
            _tables.clear()
        table = torch.as_tensor(_banded_ext_table(matrix), device=device)
        _tables[key] = table
    return table


def _banded_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_banded
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 6 + [i] * 11 + [p]
        fn.restype = ctypes.c_int
        lib.swtpu_sw_banded_ring.argtypes = [i]
        lib.swtpu_sw_banded_ring.restype = ctypes.c_int
    return lib, fn


def banded_launch_t(qT, tT, params: ScoringParams, bandwidth: int, table=None):
    """The launch alone, on codes already in the kernel's layout (qT
    [n, B], tT [m, B] contiguous uint8 on one CUDA device). With ``table``
    (:func:`banded_table`) the profile instantiation runs, else the
    uniform one. Allocates the [2W + 9, B] ring scratch and the [B]
    int32 scores and launches on the device's current stream."""
    device = qT.device
    for x in (qT, tT):
        if (x.dtype != torch.uint8 or x.device != device or device.type != "cuda"
                or not x.is_contiguous()):
            raise ValueError(
                "the fixed-band kernel takes contiguous uint8 codes on one CUDA "
                f"device, got {x.dtype} on {x.device}")
    n, B = qT.shape
    m = tT.shape[0]
    if tT.shape[1] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {tT.shape[1]} targets")
    # a corridor wider than the matrix is the whole matrix
    W = min(_check_width(bandwidth), max(n, m))
    stride = 0
    if table is not None:
        stride = table.shape[0]
        if (table.dtype != torch.int32 or table.device != device
                or table.shape != (stride, stride) or not table.is_contiguous()):
            raise ValueError(
                "the fixed-band profile kernel takes a square contiguous int32 "
                f"table on the codes' device, got {table.dtype} "
                f"{tuple(table.shape)} on {table.device}")
        match = mismatch = 0
    else:
        match, mismatch = _uniform_match_mismatch(params)
    affine = not params.is_linear
    lib, fn = _banded_fn()
    S = lib.swtpu_sw_banded_ring(W)
    if max(B, n, m) >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    i32 = dict(dtype=torch.int32, device=device)
    hring = torch.empty((S, B), **i32)
    fring = torch.empty((S, B), **i32) if affine else None
    score = torch.empty((B,), **i32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            int(affine), ptr(qT), ptr(tT), ptr(table), ptr(hring), ptr(fring),
            ptr(score), B, n, m, W, params.alphabet_size, match, mismatch,
            int(params.matrix.min()), stride, params.gap_open, params.gap_extend,
            stream,
        )
    _build.check(lib, err, "sw_banded")
    return score


def _run(wrapper, qs, ts, params, bandwidth, lens_q, lens_t, device, profile):
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_banded_plain(qs, ts, params, bandwidth, lens_q, lens_t, dev)
    A = params.alphabet_size
    qs, ts = _apply_lens(qs, ts, lens_q, lens_t, A, A + 1, dev)
    qT, tT = kernel_layout(qs, ts, dev, "fixed-band")
    out = banded_launch_t(qT, tT, params, bandwidth,
                          banded_table(params.matrix, dev) if profile else None)
    wrapper.launches += 1
    wrapper.launches_affine += not params.is_linear
    return out


def sw_banded_static(qs, ts, params: ScoringParams, bandwidth=32, lens_q=None,
                     lens_t=None, device=None) -> torch.Tensor:
    """Batched fixed-band local-alignment scores (|i - j| <= bandwidth).

    qs: [B, n] codes (0-3, pad 4), ts: [B, m] codes (pad 5), numpy or
    torch; optional per-pair lengths apply the pad codes. Uniform
    match/mismatch scoring, linear or affine (mismatch < 0 < gap_extend).
    Returns [B] int32 on ``device`` (default: the card), equal per pair
    to ``oracle.banded_static.sw_banded_static_score``.
    """
    _guard(static_refusal(params))
    return _run(sw_banded_static, qs, ts, params, bandwidth, lens_q, lens_t,
                device, profile=False)


def sw_banded_profile(qs, ts, params: ScoringParams, bandwidth=32, lens_q=None,
                      lens_t=None, device=None) -> torch.Tensor:
    """Batched fixed-band scores for GENERAL substitution matrices
    (protein/BLOSUM62, non-uniform DNA), linear or affine gaps. Same
    corridor contract as :func:`sw_banded_static`; qs codes 0..A-1 (pad
    A), ts (pad A+1), A = params.alphabet_size."""
    _guard(profile_refusal(params))
    return _run(sw_banded_profile, qs, ts, params, bandwidth, lens_q, lens_t,
                device, profile=True)


sw_banded_static.launches = 0
sw_banded_static.launches_affine = 0
sw_banded_profile.launches = 0
sw_banded_profile.launches_affine = 0
