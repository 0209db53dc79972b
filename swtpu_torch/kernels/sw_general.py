"""Batched local-alignment scores and endpoints under any scoring the plain
anti-diagonal tier takes: the CUDA kernels and their plain PyTorch version.

Port of the scorings JAX's TPU dispatch sends to its XLA tier
(``swtpu/ops/variants.py``: ``best_engine`` falls through to
``swtpu/kernels/xla/sw_scan.py::sw_batch_diag`` and
``swtpu/kernels/xla/affine_scan.py::sw_affine_batch_diag`` wherever its
Pallas kernels' guards refuse, and ``best_ends_engine`` wraps every
Pallas tier in the same fallback): a gap of 0 or below, Gotoh with
gap_extend <= 0 (a constant or falling gap cost), matrix entries outside
[-127, 127]. On the card the row-scan and profile kernels keep every
scoring they take; ``ops.variants.local_form`` sends the rest here.

Both kernels are in ``csrc/sw_general.cu``, whose head note says what they
compute, what bounds them and how; :func:`general_form` picks one by the
gaps' signs:

- ``"tile"`` where no gap penalty is negative (linear gap >= 0, Gotoh
  gap_open, gap_extend >= 0: gap 0, Gotoh 3/0, the matrices past +-127
  under positive gaps). There the tier's cells outside the matrix change
  neither the score nor the endpoint, so the kernel computes the n x m
  real cells alone on the skewed register tile of
  ``csrc/sw_local_tile.cuh`` that the profile thread form runs: a thread
  per pair, 16 query rows a sweep, masks only in a sweep's opening and
  closing steps, the tier's extended table as a lane table in shared
  memory, the endpoint in one packed key where ``key_bits`` holds the
  matrix's own range (else the select tracker);
- ``"sweep"`` for a negative penalty, where the tier's boundary row and
  the cells outside the target's columns grow and reach the real cells:
  strips of 16 rows in registers swept over the tier's whole diagonal
  range, the endpoint tracked on H.

The plain versions are the tier itself (``sw_scan.sw_batch_diag(_ends)``
linear, ``affine_scan.sw_affine_batch_diag(_ends)`` Gotoh, by
``ScoringParams.is_linear`` as ``best_engine`` picks on the CPU).

``sw_general`` and ``sw_general_ends`` run where their device says: on
the CPU the plain version, on a CUDA device a kernel, never the plain
version there; a failed build or launch raises. Each counts its launches
in ``<wrapper>.launches``, those of the Gotoh instantiations also in
``<wrapper>.launches_affine`` and those of the tile form in
``<wrapper>.launches_tile``.
"""

from __future__ import annotations

import ctypes

import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.affine_scan import sw_affine_batch_diag, sw_affine_batch_diag_ends
from swtpu_torch.kernels.sw_batch import launch_buffers, launch_codes, ptr
from swtpu_torch.kernels.sw_profile import profile_table
from swtpu_torch.kernels.sw_scan import sw_batch_diag, sw_batch_diag_ends
from swtpu_torch.utils.device import resolve_device

SOURCE = "sw_general.cu"
ROWS = 16  # rows a strip of the sweep form, a sweep of the tile form (csrc/sw_general.cu)
MAX_LETTERS = 30  # the extended table is at most 32 x 32, two codes for pads


def general_refusal(params: ScoringParams):
    """Why the general kernel does not take ``params`` (an alphabet the
    plain tier's extended table cannot hold either), or None."""
    if params.alphabet_size > MAX_LETTERS:
        return (f"the local engines take at most {MAX_LETTERS} letters (got "
                f"{params.alphabet_size}), on the card and on the CPU")
    return None


def general_form(params: ScoringParams) -> str:
    """The kernel that takes ``params`` on the card: ``"tile"`` where no gap
    penalty is negative (linear gap >= 0; Gotoh gap_open >= 0 and
    gap_extend >= 0), else ``"sweep"``."""
    if params.is_linear:
        return "tile" if params.gap_open >= 0 else "sweep"
    return "tile" if params.gap_open >= 0 and params.gap_extend >= 0 else "sweep"


def max_entry(params: ScoringParams) -> int:
    """The matrix's largest |entry|: the range the tile form's packed
    endpoint key has to hold."""
    return int(abs(params.matrix).max()) if params.matrix.size else 0


def _general_fn(name="swtpu_sw_general"):
    lib = _build.load(SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i, i] + [p] * 7 + [i] * 7 + [p] if name == "swtpu_sw_general"
                       else [i, i, i] + [p] * 7 + [i] * 8 + [p])
        fn.restype = ctypes.c_int
        lib.swtpu_sw_general_tile_rows.restype = ctypes.c_int
        lib.swtpu_sw_general_tile_form.restype = ctypes.c_int
    return lib, fn


def _check_table(table, device) -> int:
    """The extended table's stride; raises unless it is a square contiguous
    int32 tensor on ``device``."""
    stride = table.shape[0]
    if (table.dtype != torch.int32 or table.device != device
            or table.shape != (stride, stride) or not table.is_contiguous()):
        raise ValueError("the general local kernel takes a square contiguous int32 "
                         f"table on the codes' device, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    return stride


def general_tile_launch_t(q, t, table, params: ScoringParams, ends: bool,
                          select: bool = False):
    """The tile form's launch alone: q [B, n] and t [B, m] contiguous uint8
    codes on one CUDA device (no transposes) and the extended table
    (``sw_profile.profile_table``) there; the lane table holds the alphabet
    + 1 codes (a code past them scores as the pad). Gotoh unless gap_open ==
    gap_extend; no gap penalty may be negative (:func:`general_form`).
    ``select`` makes an endpoint launch keep (best, step) apart even where
    the packed key holds the scores. Allocates the hand-off scratch and the
    outputs (``sw_batch.launch_buffers``) and launches on the device's
    current stream. Returns int32 [B] score, or (score, end_i, end_j)."""
    if general_form(params) != "tile":
        raise ValueError("the tile form takes no negative gap penalty (got "
                         f"{params.gap_open}, {params.gap_extend})")
    affine = not params.is_linear
    lib, fn = _general_fn("swtpu_sw_general_tile")
    B, n, m, scratch, out = launch_buffers(q, t, affine, ends, "general local",
                                           lib.swtpu_sw_general_tile_rows())
    stride = _check_table(table, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            int(affine), int(ends), int(select), ptr(q), ptr(t), ptr(table), ptr(scratch),
            ptr(out[0]), ptr(out[1]) if ends else None, ptr(out[2]) if ends else None,
            B, n, m, stride, params.alphabet_size + 1, max_entry(params),
            params.gap_open, params.gap_extend, stream,
        )
    _build.check(lib, err, "sw_general_tile")
    return (out[0], out[1], out[2]) if ends else out[0]


def general_sweep_launch_t(q, t, table, params: ScoringParams, ends: bool):
    """The sweep form's launch alone: q [B, n] and t [B, m] contiguous uint8
    codes on one CUDA device (no transposes) and the extended table
    (``sw_profile.profile_table``) there; Gotoh unless gap_open ==
    gap_extend; any gap signs. Allocates the strip scratch (past one strip
    of 16 rows) and the outputs and launches on the device's current
    stream. Returns int32 [B] score, or (score, end_i, end_j)."""
    device = q.device
    for x in (q, t):
        if (x.dtype != torch.uint8 or x.device != device or device.type != "cuda"
                or x.dim() != 2 or not x.is_contiguous()):
            raise ValueError("the general local kernel takes contiguous uint8 [B, L] "
                             f"codes on one CUDA device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    if max(B, n, m) >= 2**31:  # the C interface takes int sizes
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    stride = _check_table(table, device)
    affine = not params.is_linear
    i32 = dict(dtype=torch.int32, device=device)
    scratch = torch.empty((2 * n + m + 1, B, 2), **i32) if n + 1 > ROWS and B else None
    out = torch.empty((3 if ends else 1, B), **i32)
    lib, fn = _general_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            int(affine), int(ends), ptr(q), ptr(t), ptr(table), ptr(scratch),
            ptr(out[0]), ptr(out[1]) if ends else None, ptr(out[2]) if ends else None,
            B, n, m, stride, params.gap_open if params.is_linear else 0,
            params.gap_open, params.gap_extend, stream,
        )
    _build.check(lib, err, "sw_general")
    return (out[0], out[1], out[2]) if ends else out[0]


def sw_general_plain(qs, ts, params: ScoringParams, device=None):
    """Plain PyTorch version of :func:`sw_general` (the anti-diagonal tier,
    linear or Gotoh)."""
    if params.is_linear:
        return sw_batch_diag(qs, ts, params, device)
    return sw_affine_batch_diag(qs, ts, params, device)


def sw_general_ends_plain(qs, ts, params: ScoringParams, device=None):
    """Plain PyTorch version of :func:`sw_general_ends`."""
    if params.is_linear:
        return sw_batch_diag_ends(qs, ts, params, device)
    return sw_affine_batch_diag_ends(qs, ts, params, device)


def _run(wrapper, plain, qs, ts, params: ScoringParams, device, ends: bool):
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return plain(qs, ts, params, dev)
    q, t = launch_codes(qs, ts, dev, "general local")
    tile = general_form(params) == "tile"
    launch = general_tile_launch_t if tile else general_sweep_launch_t
    out = launch(q, t, profile_table(params, dev), params, ends)
    wrapper.launches += 1
    wrapper.launches_affine += not params.is_linear
    wrapper.launches_tile += tile
    return out


def sw_general(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Batched local-alignment scores, any scoring the plain tier takes.

    qs: [B, n], ts: [B, m] codes (numpy or torch; pads past the alphabet).
    Returns [B] int32 on ``device`` (default: the card), equal to the
    plain tier's (JAX's ``sw_batch_diag`` / ``sw_affine_batch_diag``).
    """
    return _run(sw_general, sw_general_plain, qs, ts, params, device, False)


def sw_general_ends(qs, ts, params: ScoringParams, device=None):
    """Batched local scores + endpoints (the first maximum in row-major
    order; score 0 maps to (0, 0)), any scoring the plain tier takes.
    Returns (score, end_i, end_j) int32 [B] on ``device``."""
    return _run(sw_general_ends, sw_general_ends_plain, qs, ts, params, device, True)


for _w in (sw_general, sw_general_ends):
    _w.launches = 0
    _w.launches_affine = 0
    _w.launches_tile = 0

