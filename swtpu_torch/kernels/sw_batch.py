"""Batched local-alignment scores and endpoints, linear gap: the CUDA
row-scan kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/sw_batch.py`` (``sw_batch_pallas`` and
``sw_batch_pallas_ends``). The kernel is ``csrc/sw_rowscan.cu``, whose
head note says what it replaces, what bounds it and how. The plain
versions are the anti-diagonal tier of ``sw_scan.py``.

The kernel reads the codes as the caller holds them, [B, n] / [B, m]
uint8: the wrappers transpose nothing. :func:`rowscan_skew_mirror`
replays its skewed tile step for step in plain PyTorch on the CPU (the
tests hold it against JAX's XLA tier); nothing on the card path calls it.

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
from swtpu_torch.kernels.sw_scan import _extended_table, sw_batch_diag, sw_batch_diag_ends
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


def linear_refusal(params: ScoringParams):
    """Why the linear row-scan kernel does not take ``params``, or None
    when it does."""
    if not params.is_linear:
        return "affine scoring: use sw_affine"
    if _uniform_match_mismatch(params) is None:
        return ("general matrices go to the profile kernel (kernels.sw_profile), "
                "not the row-scan kernel")
    if params.gap <= 0:
        return (f"the row-scan kernel needs gap > 0 (got {params.gap}); best_engine "
                "runs such scorings on the general kernel (kernels.sw_general), and "
                "ROADMAP.md queue A lists what the card still refuses")
    return None


def _guard_linear(params: ScoringParams):
    """(match, mismatch) for the linear kernel, or NotImplementedError."""
    reason = linear_refusal(params)
    if reason:
        raise NotImplementedError(reason)
    return _uniform_match_mismatch(params)


def _rowscan_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_rowscan
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, p, p, p, p, p, p] + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        lib.swtpu_sw_rowscan_rows.restype = ctypes.c_int
    return lib, fn


def launch_codes(qs, ts, device: torch.device, what: str):
    """[B, n] / [B, m] codes as the row-scan kernels take them: contiguous
    uint8 on ``device``, in the caller's layout (no transposes)."""
    if device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA, not {device}")
    q = as_codes(qs, device).contiguous()
    t = as_codes(ts, device).contiguous()
    if t.shape[0] != q.shape[0]:
        raise ValueError(f"batch mismatch: {q.shape[0]} queries vs {t.shape[0]} targets")
    return q, t


def launch_buffers(q, t, affine: bool, ends: bool, what: str, rows: int):
    """Check [B, n] / [B, m] codes as the row-scan kernels take them
    (contiguous uint8 on one CUDA device) and allocate there the int32
    scratch that hands a sweep's last row to the next (past one sweep of
    ``rows`` rows: [m, B], affine [m, B, 2] for H and F) and the [B] int32
    outputs, rows of one [3, B] tensor (ends) or a [1, B] one. Returns (B,
    n, m, scratch, out); an unused scratch is None."""
    device = q.device
    for x in (q, t):
        if (x.dtype != torch.uint8 or x.device != device or device.type != "cuda"
                or x.dim() != 2 or not x.is_contiguous()):
            raise ValueError(
                f"the {what} kernel takes contiguous uint8 [B, L] codes on one "
                f"CUDA device, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    if max(B, n, m) >= 2**31:  # the C interface takes int sizes
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    i32 = dict(dtype=torch.int32, device=device)
    scratch = None
    if n > rows and m > 0:
        scratch = torch.empty((m, B, 2) if affine else (m, B), **i32)
    return B, n, m, scratch, torch.empty((3 if ends else 1, B), **i32)


def ptr(x):
    """A tensor's device address for ctypes (None for an unused buffer)."""
    return None if x is None else x.data_ptr()


def rowscan_launch(qs, ts, params: ScoringParams, match: int, mismatch: int,
                   device: torch.device, affine: bool, ends: bool):
    """Launch one instantiation of the row-scan kernel on ``device``:
    :func:`launch_codes`, then :func:`rowscan_launch_t`. Returns int32
    [B] score, or (score, end_i, end_j).
    """
    q, t = launch_codes(qs, ts, device, "row-scan")
    return rowscan_launch_t(q, t, params, match, mismatch, affine, ends)


def rowscan_launch_t(q, t, params: ScoringParams, match: int, mismatch: int,
                     affine: bool, ends: bool, select: bool = False):
    """The launch alone, on the codes as the wrappers hand them: q [B, n]
    and t [B, m] contiguous uint8 on one CUDA device (no transposes).
    Allocates the scratch and the outputs there (:func:`launch_buffers`)
    and launches on that device's current stream. ``select`` makes an
    endpoint launch keep (best, step) apart even where the packed key
    holds the scores (``chip_smoke.py`` times the two side by side)."""
    lib, fn = _rowscan_fn()
    B, n, m, scratch, out = launch_buffers(
        q, t, affine, ends, "row-scan", lib.swtpu_sw_rowscan_rows()
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            int(affine), int(ends), int(select), ptr(q), ptr(t), ptr(scratch),
            ptr(out[0]), ptr(out[1]) if ends else None, ptr(out[2]) if ends else None,
            B, n, m, params.alphabet_size, match, mismatch,
            params.gap_open, params.gap_extend, stream,
        )
    _build.check(lib, err, "sw_rowscan")
    return (out[0], out[1], out[2]) if ends else out[0]


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


# -- a plain mirror of the kernels' skewed tile (tests only) -----------------

#: query rows a sweep and steps a group, as csrc/sw_local_tile.cuh's ROWS
#: and GROUP (the mirrors' schedule; the launches ask the library for its
#: ROWS)
ROWS = 16
GROUP = 4
#: the tracker a form runs, as csrc/sw_local_tile.cuh's END_*
END_SCORE, END_KEY, END_SELECT = 0, 1, 2
PAD_SCORE = -(2**20)
REAL = 2**30  # a real code's offset in the uniform form
MAX_ENTRY = 127  # |profile entry| the profile kernel takes
_NEG_EF = -(2**29)
_INT_MIN, _INT_MAX = -(2**31), 2**31 - 1


def key_bits(profile: bool, n: int, m: int, match: int, mismatch: int, go: int,
             ge: int, entry: int = MAX_ENTRY):
    """The mirrors' copy of csrc/sw_local_tile.cuh's ``key_bits``: the
    step bits k of the endpoint forms' packed tracker (key = (H - go) x
    2^k + 2^k - 1 - step), or None when the key cannot hold these sizes and
    scores (a profile entry counts as ``entry``: MAX_ENTRY for the profile
    kernel, the matrix's own largest for the general kernel's tile form,
    whose library passes it as match and mismatch)."""
    k = max(m + ROWS + GROUP - 1, 0).bit_length()
    mag = max(entry if profile else max(abs(match), abs(mismatch)), abs(go), abs(ge))
    span = (n + m + ROWS + GROUP) * mag + go + 1
    return k if k < 31 and span < 2 ** (31 - k) else None


def narrow(match: int, mismatch: int, go: int) -> bool:
    """The copy of ``narrow``: whether the uniform form's min-cap pad rule
    is exact for these scores (else the WIDE form selects the pad)."""
    return (min(match, mismatch) >= PAD_SCORE and max(match, mismatch) + go <= REAL
            and go < -PAD_SCORE)


def local_tracker(profile: bool, ends: bool, n: int, m: int, match: int, mismatch: int,
                  go: int, ge: int, select: bool = False, entry: int = MAX_ENTRY):
    """(END_*, wide, key bits or None): the form a launch of the row-scan
    (``profile`` False), the profile thread form or the general kernel's
    tile form (``profile`` with ``entry`` its matrix's largest |entry|)
    runs, as the libraries' ``swtpu_sw_rowscan_form`` /
    ``swtpu_sw_profile_form`` / ``swtpu_sw_general_tile_form`` choose it."""
    wide = not profile and not narrow(match, mismatch, go)
    if not ends:
        return END_SCORE, wide, None
    k = key_bits(profile, n, m, match, mismatch, go, ge, entry)
    if select or wide or k is None:
        return END_SELECT, wide, None
    return END_KEY, wide, k


def local_skew_mirror(qs, ts, params: ScoringParams, ends: bool, profile: bool,
                      select: bool = False, affine: bool = None, entry: int = MAX_ENTRY):
    """The local kernels' schedule (csrc/sw_local_tile.cuh) replayed in
    PyTorch on the CPU over [B, ROWS]: sweeps of ROWS rows, phantom pad
    rows past n; at step s row r computes column s - r from row r - 1's
    state of the step before. With m >= ROWS only the rows inside [0, m)
    compute (opening and closing steps) and a row that starts next step
    takes its diagonal; else every step is in a masked group of GROUP
    (a row outside [0, m) keeps H and tracker; E, F, the diagonal and the
    target value shift on). H kept minus the gap open; row 0 reads the row
    above from the scratch a group ahead (the first sweep: the boundary),
    row ROWS - 1 writes it (not in the last sweep). Scores: ``profile``
    looks up the lane table (the extended table, codes clamped to the
    alphabet + 1); uniform keeps code + REAL or INT_MIN (pad rows) and a
    row mismatch, target values code + REAL or, for a pad, -2^20 + go (the
    min cap) or -1 (WIDE: the pad select). Trackers: the best of each pair
    of rows, or per-row (best, step) on a strict '>' in one key where
    :func:`key_bits` allows (the launch's choice), folded in row order
    after each sweep. ``affine`` (default: gap_open != gap_extend) picks the
    Gotoh instantiation, as the affine wrappers do on a linear scoring;
    ``entry`` is the |profile entry| the packed key must hold (the general
    kernel's tile form: its matrix's largest). Nothing on the card path
    calls it."""
    cpu = torch.device("cpu")
    q = as_codes(qs, cpu).long()
    t = as_codes(ts, cpu).long()
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    go, ge = int(params.gap_open), int(params.gap_extend)
    affine = not params.is_linear if affine is None else affine
    padgo = PAD_SCORE + go
    if profile:
        pad = params.alphabet_size  # the lane table's last code
        nc = pad + 1
        lane = torch.from_numpy(_extended_table(params)).long()[:nc, :nc].reshape(-1) + go
        match = mismatch = 0
    else:
        match, mismatch = _uniform_match_mismatch(params)
        alpha, hit, miss = params.alphabet_size, match + go, mismatch + go
    end, wide, kbits = local_tracker(profile, ends, n, m, match, mismatch, go, ge, select,
                                     entry)
    kmul = 2 ** (kbits or 0)
    origin = -go * kmul + kmul - 1 if end == END_KEY else -go
    R, ar = ROWS, torch.arange(ROWS)
    zeros = torch.zeros(B, dtype=torch.long)
    best, bi, bj = zeros.clone(), zeros.clone(), zeros.clone()
    pair_best = torch.full((B, R // 2), -go, dtype=torch.long)  # END_SCORE
    scratch_h = torch.zeros((B, m), dtype=torch.long)  # the [m, B] scratch, per pair
    scratch_f = torch.zeros((B, m), dtype=torch.long)

    def full(v):
        return torch.full((B, R), v, dtype=torch.long)

    def shift(first_col, x):
        """Row r takes row r - 1's value, row 0 ``first_col``."""
        return torch.cat([first_col[:, None], x[:, :-1]], dim=1)

    if m >= R:  # (step, LO, HI, masked): opening, whole groups, closing
        steps = [(s, max(0, s - m + 1), min(s, R - 1), False) for s in range(m + R - 1)]
    else:
        steps = [(s, 0, R - 1, True) for s0 in range(0, m + R - 1, GROUP)
                 for s in range(s0, s0 + GROUP)]
    for i0 in range(0, n if m else 0, R):
        first, last = i0 == 0, i0 + R >= n
        real = i0 + ar + 1 <= n
        c = torch.where(real[None], q[:, (i0 + ar).clamp(max=n - 1)],
                        pad if profile else alpha)
        if profile:
            qc = c.clamp(max=pad) * nc
        else:
            qc = torch.where(c < alpha, c + REAL, _INT_MIN)
            mr = torch.where(c < alpha, miss, padgo)
        tc, d, dg = full(0), full(-go), full(-go)
        e, f = full(_NEG_EF), full(_NEG_EF)
        rb = torch.where(real, origin, _INT_MAX).expand(B, R).clone()
        rs = full(-1)
        ring_h = torch.full((B, GROUP), -go, dtype=torch.long)
        ring_f = torch.full((B, GROUP), _NEG_EF, dtype=torch.long)
        if not first:
            ring_h[:, :m], ring_f[:, :m] = scratch_h[:, :GROUP], scratch_f[:, :GROUP]
        for s, lo, hi, masked in steps:
            tv = up_in = f_in = zeros
            if lo == 0:
                tn = t[:, s] if s < m else zeros
                if profile:
                    tv = tn.clamp(max=pad)
                else:
                    tv = torch.where(tn < alpha, tn + REAL, -1 if wide else padgo)
                u = s % GROUP
                up_in, f_in = ring_h[:, u].clone(), ring_f[:, u].clone()
                if not first and s + GROUP < m:
                    ring_h[:, u], ring_f[:, u] = scratch_h[:, s + GROUP], scratch_f[:, s + GROUP]
            tr, up = shift(tv, tc), shift(up_in, d)
            if profile:
                sg = lane[qc + tr]
            else:
                sel = torch.where(qc == tr, hit, mr)
                sg = torch.where(tr < 0, padgo, sel) if wide else torch.minimum(sel, tr)
            if affine:
                fn = torch.maximum(shift(f_in, f) - ge, up)
                en = torch.maximum(e - ge, d)
                h = torch.maximum(torch.maximum(dg + sg, en), fn).clamp(min=0)
            else:
                fn, en = f, e
                h = torch.maximum(torch.maximum(dg + sg, up), d).clamp(min=0)
            dn = h - go
            comp = ((ar >= lo) & (ar <= hi))[None]  # the rows that compute
            valid = comp & (((s - ar >= 0) & (s - ar < m))[None] | (not masked))
            starts = (ar == hi + 1)[None]
            tc, dg = torch.where(comp, tr, tc), torch.where(comp | starts, up, dg)
            e, f = torch.where(comp, en, e), torch.where(comp, fn, f)
            d = torch.where(valid, dn, d)
            if end == END_KEY:
                rb = torch.where(valid, torch.maximum(rb, dn * kmul + kmul - 1 - s), rb)
            elif end == END_SELECT:
                upd = valid & (dn > rb)
                rs, rb = torch.where(upd, s, rs), torch.where(upd, dn, rb)
            else:
                for p in range(R // 2):
                    if lo <= 2 * p <= hi:  # rows 2p and 2p + 1
                        pair_best[:, p] = torch.maximum(
                            pair_best[:, p], torch.maximum(d[:, 2 * p], d[:, 2 * p + 1]))
                    elif 2 * p + 1 == lo:  # row 2p is done
                        pair_best[:, p] = torch.maximum(pair_best[:, p], d[:, 2 * p + 1])
            j = s - (R - 1)
            if hi == R - 1 and not last and 0 <= j < m:
                scratch_h[:, j], scratch_f[:, j] = d[:, R - 1], f[:, R - 1]
        if end == END_SCORE:
            continue
        for r in range(R):
            rbr, rsr = rb[:, r], rs[:, r]
            if end == END_KEY:  # the key's best and step
                hit_ = (rbr != _INT_MAX) & (rbr > origin)
                rsr = torch.where(hit_, kmul - 1 - (rbr & (kmul - 1)), rsr)
                rbr = torch.where(hit_, rbr >> kbits, rbr)
            upd = (rsr >= 0) & (rbr + go > best)
            best = torch.where(upd, rbr + go, best)
            bi = torch.where(upd, i0 + r + 1, bi)
            bj = torch.where(upd, rsr - r + 1, bj)
    if end == END_SCORE:
        return (pair_best.max(dim=1).values + go).clamp(min=0).to(torch.int32)
    return tuple(x.to(torch.int32) for x in (best, bi, bj))


def rowscan_skew_mirror(qs, ts, params: ScoringParams, ends: bool = False,
                        select: bool = False):
    """The row-scan kernel (csrc/sw_rowscan.cu) replayed on the CPU
    (:func:`local_skew_mirror`, uniform scoring): the contract of
    :func:`sw_batch` / :func:`sw_batch_ends` (affine: ``sw_affine``)."""
    if _uniform_match_mismatch(params) is None:
        raise NotImplementedError("the row-scan kernel takes uniform scoring only")
    return local_skew_mirror(qs, ts, params, ends, profile=False, select=select)
