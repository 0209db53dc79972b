"""Batched semi-global and global alignment scores and endpoints under
uniform scoring, linear or affine gaps: the CUDA kernel and its plain
PyTorch version.

Port of ``swtpu/kernels/pallas/semiglobal_batch.py``
(``semiglobal_batch_pallas``). The kernel is ``csrc/sw_semiglobal.cu``,
whose head note says what it replaces, what bounds it and how; the same
source serves the general-matrix wrapper (``semiglobal_profile.py``).
The plain version is the anti-diagonal tier of ``semiglobal_scan.py``.

Unlike the TPU kernel, which takes fixed-length argmax batches with
n % 8 == 0 and m % 16 == 0, the kernel takes any n and m, per-pair
``lens_q`` / ``lens_t`` and ``pin_end`` (global alignment): what JAX ran
on its XLA scan on the device runs here in the kernel.

``semiglobal_batch`` runs where its device says: on the CPU the plain
version, for every scoring the XLA tier takes; on a CUDA device the
kernel, for gaps > 0 only (else NotImplementedError), never the plain
version; a failed build or launch raises. It counts its launches in
``semiglobal_batch.launches``, and those of the affine, the pinned and
the affine pinned instantiations also in ``.launches_affine``,
``.launches_pinned`` and ``.launches_affine_pinned``.
"""

from __future__ import annotations

import ctypes

import torch

from swtpu_torch.kernels import _build
from swtpu_torch.kernels.semiglobal_scan import gaps, semiglobal_batch_diag
from swtpu_torch.kernels.sw_batch import kernel_layout, launch_buffers, ptr
from swtpu_torch.utils.device import resolve_device

SOURCE = "sw_semiglobal.cu"


def semiglobal_refusal(go: int, ge: int):
    """Why the semi-global kernel does not take these gaps, or None."""
    if go <= 0 or ge <= 0:
        return (f"the semi-global kernels need gaps > 0 (got {go}, {ge}); no "
                "kernel in ROADMAP.md queue B takes a non-positive gap: run it "
                "on the CPU")
    return None


def _semiglobal_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_semiglobal
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i] + [p] * 10 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def lens_tensor(lens, B: int, device: torch.device):
    """Per-pair lengths as the kernel takes them: a contiguous int32 [B]
    tensor on ``device``, or None for the full widths."""
    if lens is None:
        return None
    out = torch.as_tensor(lens, dtype=torch.int32, device=device).contiguous()
    if tuple(out.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(out.shape)}")
    return out


def semiglobal_launch_t(qT, tT, match: int, mismatch: int, go: int, ge: int,
                        affine: bool, pin_end: bool, lens_q=None, lens_t=None,
                        table=None):
    """The launch alone, on codes already in the kernel's layout (qT
    [n, B], tT [m, B] contiguous uint8 on one CUDA device) and lengths
    from :func:`lens_tensor`. ``mismatch`` is the score of a mismatch
    (negative). With ``table`` (``sw_profile.profile_table``) the profile
    instantiation runs and match/mismatch are unused. Allocates the
    scratch and the outputs and launches on the device's current stream.
    Returns (score, end_i, end_j) int32 [B]."""
    B, n, m, hrow, frow, score, end_i, end_j = launch_buffers(
        qT, tT, affine, True, "semi-global"
    )
    for x in (lens_q, lens_t):
        if x is not None and (x.dtype != torch.int32 or x.device != qT.device
                              or tuple(x.shape) != (B,) or not x.is_contiguous()):
            raise ValueError(
                f"the semi-global kernel takes contiguous int32 [{B}] lengths "
                f"on the codes' device, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    stride = 0
    if table is not None:
        stride = table.shape[0]
        if (table.dtype != torch.int32 or table.device != qT.device
                or table.shape != (stride, stride) or not table.is_contiguous()):
            raise ValueError(
                "the semi-global profile kernel takes a square contiguous int32 "
                f"table on the codes' device, got {table.dtype} "
                f"{tuple(table.shape)} on {table.device}"
            )
    lib, fn = _semiglobal_fn()
    with torch.cuda.device(qT.device):
        stream = torch.cuda.current_stream(qT.device).cuda_stream
        err = fn(
            int(affine), int(table is not None), int(pin_end), ptr(qT), ptr(tT),
            ptr(table), ptr(lens_q), ptr(lens_t), ptr(hrow), ptr(frow),
            ptr(score), ptr(end_i), ptr(end_j), B, n, m, int(match),
            int(mismatch), stride, go, ge, stream,
        )
    _build.check(lib, err, "sw_semiglobal")
    return score, end_i, end_j


def count(wrapper, affine: bool, pin_end: bool) -> None:
    """Add one launch to ``wrapper``'s counts."""
    wrapper.launches += 1
    wrapper.launches_affine += affine
    wrapper.launches_pinned += pin_end
    wrapper.launches_affine_pinned += affine and pin_end


def semiglobal_batch_plain(qs, ts, match=1, mismatch=1, gap=1, gap_open=None,
                           gap_extend=None, lens_q=None, lens_t=None,
                           pin_end=False, device=None):
    """Plain PyTorch version of :func:`semiglobal_batch` (the XLA tier's
    anti-diagonal scan)."""
    return semiglobal_batch_diag(
        qs, ts, match, mismatch, gap, gap_open=gap_open, gap_extend=gap_extend,
        lens_q=lens_q, lens_t=lens_t, pin_end=pin_end, device=device,
    )


def semiglobal_batch(qs, ts, match=1, mismatch=1, gap=1, gap_open=None,
                     gap_extend=None, lens_q=None, lens_t=None, pin_end=False,
                     device=None):
    """Batched semi-global scores + endpoints, uniform scoring, linear or
    affine (gap_open != gap_extend) gaps.

    qs: [B, n], ts: [B, m] codes (numpy or torch); ``mismatch`` is a
    positive penalty (scored -mismatch); optional per-pair lengths;
    ``pin_end`` gives global alignment. Returns (score, end_i, end_j)
    int32 [B] on ``device`` (default: the card), identical to
    ``semiglobal_scan.semiglobal_batch_diag``.
    """
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return semiglobal_batch_plain(
            qs, ts, match, mismatch, gap, gap_open, gap_extend, lens_q, lens_t,
            pin_end, dev,
        )
    go, ge, affine = gaps(gap, gap_open, gap_extend)
    reason = semiglobal_refusal(go, ge)
    if reason:
        raise NotImplementedError(reason)
    qT, tT = kernel_layout(qs, ts, dev, "semi-global")
    B = qT.shape[1]
    out = semiglobal_launch_t(
        qT, tT, int(match), -int(mismatch), go, ge, affine, pin_end,
        lens_tensor(lens_q, B, dev), lens_tensor(lens_t, B, dev),
    )
    count(semiglobal_batch, affine, pin_end)
    return out


semiglobal_batch.launches = 0
semiglobal_batch.launches_affine = 0
semiglobal_batch.launches_pinned = 0
semiglobal_batch.launches_affine_pinned = 0
