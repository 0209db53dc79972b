"""Batched adaptive-banded X-drop forward pass: the CUDA kernel and its
plain PyTorch version.

Port of ``swtpu/kernels/pallas/banded_batch.py``
(``banded_xdrop_batch_pallas``) and ``swtpu/kernels/pallas/banded_packed.py``
(``banded_xdrop_batch_packed``), which share one contract and one result
type. The kernel is ``csrc/sw_xdrop.cu``, whose head note says what it
replaces, what bounds it and how: one warp per pair, instantiated for 1-4
band cells per lane, so it takes every bandwidth from 1 to
:data:`MAX_WIDTH` = 128 (the TPU kernels took up to 96). The W = 32 and
W = 64 instantiations serve what JAX sent to the packed kernel. The plain
version is the XLA tier's copy, ``banded_scan.banded_xdrop_batch``.

``banded_batch`` runs where its device says: on the CPU the plain
version, for any bandwidth; on a CUDA device the kernel, never the plain
version there: a bandwidth past :data:`MAX_WIDTH` raises
NotImplementedError, a failed build or launch raises. Its result holds
tensors on the device (``BandedBatchResult.numpy()`` copies them to the
host). It counts its launches in ``banded_batch.launches``, and those at
W = 32 or 64 (the packed kernel's calls in JAX) also in
``banded_batch.launches_w32_w64``. ``early_exit`` is accepted and changes
nothing: each warp retires when its pair ends. The kernel writes a pair's
history, ``pos_y`` and ``offsets`` only below its ``n_rounds``, where every
reader stops; past it they hold whatever the allocation held (the plain
version fills them as the XLA tier's masked rounds leave them).
"""

from __future__ import annotations

import ctypes

import torch

from swtpu_torch.kernels import _build
from swtpu_torch.kernels.banded_scan import (
    BandedBatchResult,
    _prep_padded,
    banded_xdrop_batch,
)
from swtpu_torch.kernels.sw_banded import banded_table
from swtpu_torch.kernels.sw_batch import ptr
from swtpu_torch.utils.device import resolve_device

SOURCE = "sw_xdrop.cu"
MAX_WIDTH = 128  # 32 lanes x 4 cells per lane
PACKED_WIDTHS = (32, 64)


def _gaps(gap, gap_open, gap_extend):
    """gap_open == gap_extend is exactly linear (as the JAX kernels' entry
    points rule): (gap, gap_open, gap_extend)."""
    if gap_open is not None and gap_open == gap_extend:
        return int(gap_open), None, None
    if gap_open is not None:
        return int(gap), int(gap_open), int(gap_extend)
    return int(gap), None, None


def width_refusal(bandwidth: int):
    """Why the kernel does not take this bandwidth, or None."""
    if not 1 <= bandwidth <= MAX_WIDTH:
        return (f"the per-round banded kernel is built for bandwidths 1..{MAX_WIDTH} "
                f"(got {bandwidth}); no kernel in ROADMAP.md queue B takes a wider "
                "band: run it on the CPU")
    return None


def _xdrop_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_xdrop
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 12 + [i] * 11 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def xdrop_launch_t(qp, tp, lens_q, lens_t, bandwidth, x_threshold, match, mismatch,
                   gap, gap_open=None, gap_extend=None, table=None,
                   with_history=True, compress_history=False):
    """The launch alone, on rows already in the kernel's layout: qp
    [B, 1 + n + W] and tp [B, 2W + m] contiguous int16 padded rows (-1
    pads, as ``banded_scan._prep_padded`` makes them) and int32 [B]
    lengths, all on one CUDA device; ``table`` (``sw_banded.banded_table``)
    selects the general-matrix mode; affine when gap_open is given.
    Allocates the outputs and launches on the device's current stream.
    Returns (score, max_round, n_rounds, band_history, pos_y, offsets);
    the last three None as the mode leaves them."""
    device = qp.device
    W, X = int(bandwidth), int(x_threshold)
    reason = width_refusal(W)
    if reason:
        raise NotImplementedError(reason)
    B = qp.shape[0]
    n, m = qp.shape[1] - W - 1, tp.shape[1] - 2 * W
    for x, dtype, what in ((qp, torch.int16, "rows"), (tp, torch.int16, "rows"),
                           (lens_q, torch.int32, "lengths"),
                           (lens_t, torch.int32, "lengths")):
        if (x.dtype != dtype or x.device != device or device.type != "cuda"
                or not x.is_contiguous() or x.shape[0] != B):
            raise ValueError(
                f"the per-round banded kernel takes contiguous {dtype} {what} with "
                f"{B} rows on one CUDA device, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    if n < 0 or m < 0:
        raise ValueError(f"padded rows too short for bandwidth {W}")
    stride = 0
    if table is not None:
        stride = table.shape[0]
        if (table.dtype != torch.int32 or table.device != device
                or table.shape != (stride, stride) or not table.is_contiguous()):
            raise ValueError(
                "the per-round banded kernel takes a square contiguous int32 table "
                f"on the rows' device, got {table.dtype} {tuple(table.shape)} on "
                f"{table.device}")
    if with_history and compress_history and X > 254:
        raise ValueError("8-bit history needs x_threshold <= 254")
    R_cap = (max(n, m) + 1) * 2 - 1
    if max(B, qp.shape[1], tp.shape[1], R_cap) >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    i32 = dict(dtype=torch.int32, device=device)
    score = torch.empty((B,), **i32)
    max_round = torch.empty((B,), **i32)
    n_rounds = torch.empty((B,), **i32)
    hist = posy = offs = None
    if with_history:
        hist = torch.empty((R_cap, B, W), dtype=torch.uint8 if compress_history
                           else torch.int32, device=device)
        posy = torch.empty((R_cap, B), **i32)
        if compress_history:
            offs = torch.empty((R_cap, B), **i32)
    affine = gap_open is not None
    lib, fn = _xdrop_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            int(affine), ptr(qp), ptr(tp), ptr(lens_q), ptr(lens_t), ptr(table),
            ptr(score), ptr(max_round), ptr(n_rounds),
            None if compress_history else ptr(hist),
            ptr(hist) if compress_history else None, ptr(posy), ptr(offs),
            B, qp.shape[1], tp.shape[1], W, X, int(match), int(mismatch),
            int(gap), int(gap_open or 0), int(gap_extend or 0), stride, stream,
        )
    _build.check(lib, err, "sw_xdrop")
    return score, max_round, n_rounds, hist, posy, offs


def banded_batch_plain(qs, ts, lens_q=None, lens_t=None, match=1, mismatch=1,
                       gap=1, bandwidth=32, x_threshold=70, compress_history=False,
                       with_history=True, early_exit=False, gap_open=None,
                       gap_extend=None, matrix=None, device=None):
    """Plain PyTorch version of :func:`banded_batch` (the XLA tier's
    copy, with the same linear rule for gap_open == gap_extend)."""
    gap, gap_open, gap_extend = _gaps(gap, gap_open, gap_extend)
    return banded_xdrop_batch(
        qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth, x_threshold,
        compress_history=compress_history, with_history=with_history,
        gap_open=gap_open, gap_extend=gap_extend, matrix=matrix, device=device,
    )


def banded_batch(qs, ts, lens_q=None, lens_t=None, match=1, mismatch=1, gap=1,
                 bandwidth=32, x_threshold=70, compress_history=False,
                 with_history=True, early_exit=False, gap_open=None,
                 gap_extend=None, matrix=None, device=None) -> BandedBatchResult:
    """Batched adaptive-banded X-drop forward pass (the per-round kernel).

    Same contract and result type as ``banded_scan.banded_xdrop_batch``:
    per alignment bit-equal to the scalar banded oracle (linear gaps) /
    the affine banded oracle (gap_open != gap_extend; the history stays
    H-only, E/F are host-reconstructible, see
    ``batch.traceback.reconstruct_affine_bands``). qs: [B, n], ts: [B, m]
    codes (numpy or torch); optional per-pair lengths; ``mismatch`` is a
    positive penalty; ``matrix`` ([A, A] signed scores, up to 30 letters)
    selects the general-matrix mode. Returns a BandedBatchResult of
    tensors on ``device`` (default: the card).
    """
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return banded_batch_plain(
            qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth, x_threshold,
            compress_history, with_history, early_exit, gap_open, gap_extend,
            matrix, dev,
        )
    W = int(bandwidth)
    reason = width_refusal(W)
    if reason:
        raise NotImplementedError(reason)
    gap, gap_open, gap_extend = _gaps(gap, gap_open, gap_extend)
    qp, tp, lq, lt = _prep_padded(qs, ts, lens_q, lens_t, W, dev, torch.int16)
    out = xdrop_launch_t(
        qp, tp, lq.to(torch.int32), lt.to(torch.int32), W, x_threshold, match,
        mismatch, gap, gap_open, gap_extend,
        None if matrix is None else banded_table(matrix, dev),
        with_history, compress_history,
    )
    banded_batch.launches += 1
    banded_batch.launches_w32_w64 += W in PACKED_WIDTHS
    score, max_round, n_rounds, hist, posy, offs = out
    return BandedBatchResult(score, max_round, n_rounds, hist, posy, offs)


banded_batch.launches = 0
banded_batch.launches_w32_w64 = 0
