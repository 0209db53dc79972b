"""Batched local-alignment scores and endpoints under a general
substitution matrix (4x4 DNA, protein with BLOSUM62), linear or affine
gaps: the CUDA profile kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/sw_profile.py`` (``sw_batch_profile_pallas``
and ``sw_batch_profile_pallas_ends``). The kernel is ``csrc/sw_profile.cu``,
whose head note says what it replaces, what bounds it and how, in two
hand-written forms, both on the [B, L] codes as given (no transposes) and
the plain tier's extended table (``sw_scan._extended_table``), which the
wrapper copies to the card once per scoring: a thread per pair, the
skewed register tile of ``csrc/sw_local_tile.cuh`` shared with the
row-scan kernel; and a warp per pair, lanes as row bands, for batches too
small to fill the card. :func:`profile_form` picks the form from the
shape; both give the same results. The plain versions are the
anti-diagonal tiers (``sw_scan.py`` linear, ``affine_scan.py`` affine);
:func:`profile_skew_mirror` and :func:`profile_warp_mirror` replay the two
forms' schedules on the CPU (tests only).

``sw_profile`` and ``sw_profile_ends`` check the kernel's guards (at most
30 letters, entries in [-127, 127], gaps > 0; a uniform matrix passes
them too) and then run where their device says: on the CPU the plain
version, on a CUDA device a form of the kernel, which they never replace
with the plain version; a failed build or launch raises. Each counts its
launches in ``<wrapper>.launches``, those of the affine instantiations
also in ``<wrapper>.launches_affine``, and those of the warp form in
``launches_warp`` (affine: ``launches_warp_affine``).

Unlike the TPU kernel there is no ``m > 2048`` transposition and no
packed-comb overflow guard: the scratch lives in device memory, and the
thread form packs (best, step) into one key only where
``sw_batch.key_bits`` says it holds the scores (else it keeps them apart).
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
from swtpu_torch.kernels.sw_batch import launch_buffers, local_skew_mirror, ptr
from swtpu_torch.kernels.sw_scan import (
    _extended_table,
    sw_batch_diag,
    sw_batch_diag_ends,
)
from swtpu_torch.utils.device import as_codes, resolve_device

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
                f"[{int(mat.min())}, {int(mat.max())}]); best_engine runs such "
                "scorings on the general kernel (kernels.sw_general), and ROADMAP.md "
                "queue A lists what the card still refuses")
    if params.gap_open <= 0 or params.gap_extend <= 0:
        return ("the profile kernel needs gap_open, gap_extend > 0 (got "
                f"{params.gap_open}, {params.gap_extend}); best_engine runs such "
                "scorings on the general kernel (kernels.sw_general), and ROADMAP.md "
                "queue A lists what the card still refuses")
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


def _profile_fn(name="swtpu_sw_profile"):
    lib = _build.load(SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i, i, i] + [p] * 7 + [i] * 7 + [p] if name == "swtpu_sw_profile"
                       else [i, i] + [p] * 8 + [i] * 6 + [p])
        fn.restype = ctypes.c_int
        lib.swtpu_sw_profile_rows.restype = ctypes.c_int
    return lib, fn


#: the warp form's query rows a lane and rows a stripe (csrc/sw_profile.cu)
WARP_ROWS = 4
STRIPE = 32 * WARP_ROWS
#: the thread form takes a batch only past this many pairs an SM (fewer
#: leave it too few warps to hide its chain of cells) and ...
WARP_PAIRS_PER_SM = 64
#: ... targets of at most this many codes (the widest the sweep measures:
#: the thread form won there from 32,768 pairs on); both from
#: chip_smoke.py's form sweep
THREAD_MAX_M = 800


def profile_form(B: int, n: int, m: int, n_sm: int) -> str:
    """Which hand-written form takes a batch of B pairs of n x m on a card
    of n_sm SMs: ``"thread"`` (a thread per pair) for a batch that fills
    the card with short targets, else ``"warp"`` (a warp per pair, lanes as
    row bands). Empty shapes go to the thread form (nothing to run)."""
    if B <= 0 or n <= 0 or m <= 0:
        return "thread"
    if B > WARP_PAIRS_PER_SM * n_sm and m <= THREAD_MAX_M:
        return "thread"
    return "warp"


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def profile_launch(qs, ts, params: ScoringParams, device: torch.device,
                   ends: bool):
    """Launch the profile kernel on ``device`` in the form
    :func:`profile_form` picks, on the codes as given ([B, n] / [B, m]
    contiguous uint8: :func:`profile_warp_launch_t`,
    :func:`profile_launch_t`). Returns (int32 [B] score, or (score, end_i,
    end_j); the form)."""
    if device.type != "cuda":
        raise ValueError(f"the profile kernel runs on CUDA, not {device}")
    q, t = as_codes(qs, device), as_codes(ts, device)
    if t.shape[0] != q.shape[0]:
        raise ValueError(
            f"batch mismatch: {q.shape[0]} queries vs {t.shape[0]} targets")
    table = profile_table(params, device)
    form = profile_form(q.shape[0], q.shape[1], t.shape[1], _sm_count(device))
    launch = profile_warp_launch_t if form == "warp" else profile_launch_t
    return launch(q.contiguous(), t.contiguous(), table, params, ends), form


def _check_table(table, device):
    stride = table.shape[0]
    if (table.dtype != torch.int32 or table.device != device
            or table.shape != (stride, stride) or not table.is_contiguous()):
        raise ValueError(
            "the profile kernel takes a square contiguous int32 table on the "
            f"codes' device, got {table.dtype} {tuple(table.shape)} on "
            f"{table.device}"
        )
    return stride


def profile_warp_launch_t(q, t, table, params: ScoringParams, ends: bool):
    """The warp form's launch alone: q [B, n] and t [B, m] contiguous uint8
    codes on one CUDA device (no transposes) and the table of
    :func:`profile_table` there. Allocates the [B, m] stripe scratch (only
    past one stripe of 128 rows) and the outputs and launches on the
    device's current stream."""
    device = q.device
    for x in (q, t):
        if (x.dtype != torch.uint8 or x.device != device or device.type != "cuda"
                or not x.is_contiguous()):
            raise ValueError("the profile kernel's warp form takes contiguous uint8 "
                             f"[B, L] codes on one CUDA device, got {x.dtype} on "
                             f"{x.device}")
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    if max(B, n, m) >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    stride = _check_table(table, device)
    affine = not params.is_linear
    i32 = dict(dtype=torch.int32, device=device)
    hrow = frow = None
    if n > STRIPE:
        hrow = torch.empty((B, m), **i32)
        frow = torch.empty((B, m), **i32) if affine else None
    out = torch.empty((3 if ends else 1, B), **i32)
    lib, fn = _profile_fn("swtpu_sw_profile_warp")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            int(affine), int(ends), ptr(q), ptr(t), ptr(table), ptr(hrow), ptr(frow),
            ptr(out[0]), ptr(out[1]) if ends else None, ptr(out[2]) if ends else None,
            B, n, m, stride, params.gap_open, params.gap_extend, stream,
        )
    _build.check(lib, err, "sw_profile_warp")
    return (out[0], out[1], out[2]) if ends else out[0]


def profile_launch_t(q, t, table, params: ScoringParams, ends: bool,
                     select: bool = False):
    """The thread form's launch alone: q [B, n] and t [B, m] contiguous
    uint8 codes on one CUDA device (no transposes) and the table of
    :func:`profile_table` there; the lane table holds the alphabet + 1
    codes (a code past them scores as the pad). The instantiation is
    affine unless gap_open == gap_extend; ``select`` makes an endpoint
    launch keep (best, step) apart even where the packed key holds the
    scores. Allocates the hand-off scratch and the outputs
    (``sw_batch.launch_buffers``) and launches on the device's current
    stream."""
    affine = not params.is_linear
    lib, fn = _profile_fn()
    B, n, m, scratch, out = launch_buffers(
        q, t, affine, ends, "profile", lib.swtpu_sw_profile_rows()
    )
    stride = _check_table(table, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            int(affine), int(ends), int(select), ptr(q), ptr(t), ptr(table), ptr(scratch),
            ptr(out[0]), ptr(out[1]) if ends else None, ptr(out[2]) if ends else None,
            B, n, m, stride, params.alphabet_size + 1, params.gap_open,
            params.gap_extend, stream,
        )
    _build.check(lib, err, "sw_profile")
    return (out[0], out[1], out[2]) if ends else out[0]


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


def _count(wrapper, params: ScoringParams, form: str) -> None:
    affine, warp = not params.is_linear, form == "warp"
    wrapper.launches += 1
    wrapper.launches_affine += affine
    wrapper.launches_warp += warp
    wrapper.launches_warp_affine += warp and affine


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
    out, form = profile_launch(qs, ts, params, dev, False)
    _count(sw_profile, params, form)
    return out


def sw_profile_ends(qs, ts, params: ScoringParams, device=None):
    """Batched general-matrix local scores + argmax endpoints: (score,
    end_i, end_j) int32 [B], the 1-based first maximum in row-major scan
    order; score 0 maps to (0, 0). Same guards as :func:`sw_profile`."""
    _guard_profile(params)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_profile_ends_plain(qs, ts, params, dev)
    out, form = profile_launch(qs, ts, params, dev, True)
    _count(sw_profile_ends, params, form)
    return out


sw_profile.launches = 0
sw_profile.launches_affine = 0
sw_profile.launches_warp = 0
sw_profile.launches_warp_affine = 0
sw_profile_ends.launches = 0
sw_profile_ends.launches_affine = 0
sw_profile_ends.launches_warp = 0
sw_profile_ends.launches_warp_affine = 0


# -- plain mirrors of the two forms' schedules (tests only) ------------------


def profile_skew_mirror(qs, ts, params: ScoringParams, ends: bool = False,
                        select: bool = False):
    """The thread form (csrc/sw_profile.cu ``sw_profile_kernel`` on
    csrc/sw_local_tile.cuh) replayed on the CPU
    (``sw_batch.local_skew_mirror``, the lane table's lookups): the
    contract of :func:`sw_profile` / :func:`sw_profile_ends`."""
    _guard_profile(params)
    return local_skew_mirror(qs, ts, params, ends, profile=True, select=select)

_NEG_EF = -(2**29)


def profile_warp_mirror(qs, ts, params: ScoringParams, ends: bool = False):
    """The warp form's schedule replayed in numpy over [B, 32 lanes]:
    stripes of 32 x WARP_ROWS rows, lane l's rows i0 + WARP_ROWS l + r;
    at step s lane l computes column s - l from its left state, the
    profile's scores (+ the gap) for its rows, and the bottom H (and F)
    lane l - 1 handed down a step earlier (lane 0: the stripe above's last
    row, which lane 31 leaves); columns outside [0, m) score as pads, rows
    past n are pad rows; H kept minus the gap; the endpoint per row on a
    strict '>', folded in row order within a lane, then the stripe's
    lowest lane at its maximum, strictly above the stripes before. Same
    contract as :func:`sw_profile` / :func:`sw_profile_ends`. Nothing on
    the card path calls it."""
    cpu = torch.device("cpu")
    table = _extended_table(params).astype(np.int64)
    stride = table.shape[0]
    pad = stride - 1
    q = as_codes(qs, cpu).numpy().astype(np.int64)
    t = np.minimum(as_codes(ts, cpu).numpy().astype(np.int64), pad)
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    G, ge, affine = int(params.gap_open), int(params.gap_extend), not params.is_linear
    R = WARP_ROWS
    lanes = np.arange(32)
    best = np.zeros(B, np.int64)
    bi = np.zeros(B, np.int64)
    bj = np.zeros(B, np.int64)
    lane_best = np.zeros((B, 32), np.int64)
    hrow = np.full((B, m), -G, np.int64)
    frow = np.full((B, m), _NEG_EF, np.int64)
    for i0 in range(0, n if m else 0, STRIPE):
        rows = i0 + lanes[:, None] * R + np.arange(R)  # [32, R]
        qrow = np.where(rows < n, q[:, np.minimum(rows, n - 1)], pad)
        prof = table.reshape(-1)[np.minimum(qrow, pad)[..., None] * stride
                                 + np.arange(stride)] + G
        hl = np.full((B, 32, R), -G, np.int64)
        el = np.full((B, 32, R), _NEG_EF, np.int64)
        rb = np.zeros((B, 32, R), np.int64)
        rj = np.zeros((B, 32, R), np.int64)
        hbot = np.full((B, 32), -G, np.int64)
        fbot = np.full((B, 32), _NEG_EF, np.int64)
        tc = np.full((B, 32), pad, np.int64)
        diag = np.full((B, 32), -G, np.int64)
        below_h, below_f = hrow.copy(), frow.copy()
        for s in range(m + 31):
            inside = s < m
            tc = np.concatenate([t[:, s:s + 1] if inside else np.full((B, 1), pad),
                                 tc[:, :-1]], axis=1)
            up = np.concatenate([hrow[:, s:s + 1] if inside else np.full((B, 1), -G),
                                 hbot[:, :-1]], axis=1)
            f = np.concatenate([frow[:, s:s + 1] if inside else np.full((B, 1), _NEG_EF),
                                fbot[:, :-1]], axis=1)
            sc = np.take_along_axis(prof, tc[:, :, None, None], axis=3)[..., 0]
            dg, diag = diag, up
            j1 = s - lanes + 1
            for r in range(R):
                if affine:
                    f = np.maximum(f - ge, up)
                    el[:, :, r] = np.maximum(el[:, :, r] - ge, hl[:, :, r])
                    h = np.maximum(np.maximum(dg + sc[:, :, r], el[:, :, r]),
                                   np.maximum(f, 0))
                else:
                    h = np.maximum(np.maximum(dg + sc[:, :, r], up),
                                   np.maximum(hl[:, :, r], 0))
                dg = hl[:, :, r].copy()
                hl[:, :, r] = h - G
                up = hl[:, :, r]
                if ends:
                    upd = h > rb[:, :, r]
                    rb[:, :, r] = np.where(upd, h, rb[:, :, r])
                    rj[:, :, r] = np.where(upd, j1[None], rj[:, :, r])
                else:
                    lane_best = np.maximum(lane_best, h)
            hbot, fbot = up.copy(), f
            if s >= 31:  # lane 31 leaves the stripe below its top boundary
                below_h[:, s - 31], below_f[:, s - 31] = hbot[:, 31], fbot[:, 31]
        hrow, frow = below_h, below_f
        if ends:
            lb = np.zeros((B, 32), np.int64)
            li = np.zeros((B, 32), np.int64)
            lj = np.zeros((B, 32), np.int64)
            for r in range(R):
                upd = rb[:, :, r] > lb
                lb = np.where(upd, rb[:, :, r], lb)
                li = np.where(upd, (rows[:, r] + 1)[None], li)
                lj = np.where(upd, rj[:, :, r], lj)
            smax = lb.max(axis=1)
            w = np.argmax(lb == smax[:, None], axis=1)
            upd = smax > best
            best = np.where(upd, smax, best)
            bi = np.where(upd, li[np.arange(B), w], bi)
            bj = np.where(upd, lj[np.arange(B), w], bj)
    out = [torch.from_numpy(x.astype(np.int32)) for x in (best, bi, bj)]
    if ends:
        return tuple(out)
    return torch.from_numpy(lane_best.max(axis=1).astype(np.int32))
