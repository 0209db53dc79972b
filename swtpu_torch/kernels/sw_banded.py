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
launch raises. On the card the kernel takes the [B, n] / [B, m] codes as
the caller holds them (no transposes) and the lengths as [B] int32 (no
code is overwritten with pads). ``sw_banded_plain`` takes any scoring.
Each wrapper counts its launches in ``<wrapper>.launches``, those of the
affine instantiation also in ``<wrapper>.launches_affine``.
``banded_skew_mirror`` replays the kernel's schedule on the CPU (tests
only).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.banded_scan import _banded_ext_table
from swtpu_torch.kernels.semiglobal_batch import codes, lens_tensor
from swtpu_torch.kernels.sw_batch import _uniform_match_mismatch, ptr
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_banded.cu"
NEG = -(2**29)  # the oracle's dead value
MAX_LETTERS = 30  # the kernel's table is at most 32 x 32, two codes for pads
ROWS = 16  # the kernel's query rows a sweep (its skewed tile)
GROUP = 4  # steps a group: its prefetch distance
OPEN = 2 * (ROWS - 1)  # steps before a sweep's last row starts

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
        fn.argtypes = [i] + [p] * 7 + [i] * 11 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def banded_launch_t(q, t, params: ScoringParams, bandwidth: int, table=None,
                    lens_q=None, lens_t=None):
    """The launch alone, on the codes as the wrappers hand them (q [B, n],
    t [B, m] contiguous uint8 on one CUDA device: ``codes``) and lengths
    from ``lens_tensor``. With ``table`` (:func:`banded_table`) the
    profile instantiation runs, else the uniform one. Allocates the
    [2W + 1, B] int32 hand-off scratch ([2W + 1, B, 2] affine; none when
    n <= ROWS) and the [B] int32 scores, and launches on the device's
    current stream."""
    device = q.device
    for x in (q, t):
        if (x.dtype != torch.uint8 or x.device != device or device.type != "cuda"
                or not x.is_contiguous() or x.dim() != 2):
            raise ValueError(
                "the fixed-band kernel takes [B, L] contiguous uint8 codes on one "
                f"CUDA device, got {x.dtype} {tuple(x.shape)} on {x.device}")
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
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
    if max(B, n, m) >= 2**30:
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    i32 = dict(dtype=torch.int32, device=device)
    scratch = (torch.empty((2 * W + 1, B) + ((2,) if affine else ()), **i32)
               if n > ROWS and m > 0 else None)
    score = torch.empty((B,), **i32)
    lib, fn = _banded_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            int(affine), ptr(q), ptr(t), ptr(table), ptr(lens_q), ptr(lens_t),
            ptr(scratch), ptr(score), B, n, m, W, params.alphabet_size, match,
            mismatch, int(params.matrix.min()), stride, params.gap_open,
            params.gap_extend, stream,
        )
    _build.check(lib, err, "sw_banded")
    return score


def _run(wrapper, qs, ts, params, bandwidth, lens_q, lens_t, device, profile):
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_banded_plain(qs, ts, params, bandwidth, lens_q, lens_t, dev)
    q, t = codes(qs, ts, dev, "fixed-band")
    B = q.shape[0]
    out = banded_launch_t(q, t, params, bandwidth,
                          banded_table(params.matrix, dev) if profile else None,
                          lens_tensor(lens_q, B, dev), lens_tensor(lens_t, B, dev))
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


# -- a plain mirror of the kernel's skewed tile (tests only) -----------------

_OUT = 0xFF  # the uniform target code of a column outside the matrix
_NEG_OUT = -(2**20)  # the profile's score of a cell outside the matrix


def banded_skew_mirror(qs, ts, params: ScoringParams, bandwidth=32, lens_q=None,
                       lens_t=None, profile=False):
    """The kernel's schedule replayed in PyTorch on the CPU over [B, ROWS]
    rows: each pair runs its own rows and columns where a pad scores <= 0
    (else the full n x m with pads past its lengths) and a band no wider
    than its matrix; sweeps of ROWS rows in band coordinates, row r at
    offset k_lo + s - 2r, over the offsets k_lo..k_hi at which some row of
    the sweep is inside the matrix (K a row); with K >= OPEN the rows of a
    step are exactly those inside their K steps, a row about to start
    takes its diagonal, the rows that are done still hand the codes down,
    and at odd closing steps the row at its band's last offset takes a
    dead up; narrower sweeps compute every row, the rows
    outside their K steps taking the dead values. Cells outside the matrix
    score OUT (<= 0). H kept minus the gap open (G), cells as the DPX
    maxes compute them, the best over G two rows at a time; row 0
    takes the row above from the previous sweep's hand-off (per pair
    [2W + 1] slots; dead past the band, left of column 1 and in the first
    sweep), row ROWS - 1 writes it. ``profile`` runs the profile form (the
    extended table), else the uniform one (match and mismatch from a
    uniform matrix). Same contract as :func:`sw_banded_static` /
    :func:`sw_banded_profile`. Nothing on the card path calls it."""
    cpu = torch.device("cpu")
    q = as_codes(qs, cpu).long()
    t = as_codes(ts, cpu).long()
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    W = min(_check_width(bandwidth), max(n, m))
    A = params.alphabet_size
    go, ge, affine = int(params.gap_open), int(params.gap_extend), not params.is_linear
    pad_score = int(params.matrix.min())
    if profile:
        ext = torch.from_numpy(_banded_ext_table(params.matrix)).long()
        stride = ext.shape[0]
        s1 = stride + 1
        tab = torch.full((s1, s1), _NEG_OUT, dtype=torch.long)
        tab[:stride, :stride] = ext
        tab = tab.reshape(-1) + go
        q_pad, q_out, t_pad, t_out = (stride - 1) * s1, stride * s1, stride - 1, stride
    else:
        match, mismatch = _uniform_match_mismatch(params)
        hit, miss = match + go, mismatch + go
        q_pad = q_out = -1
        t_pad, t_out = A + 1, _OUT
    lq = torch.as_tensor(n if lens_q is None else lens_q).long().expand(B).clamp(0, n)
    lt = torch.as_tensor(m if lens_t is None else lens_t).long().expand(B).clamp(0, m)
    trim = pad_score <= 0
    n_b = lq if trim else torch.full((B,), n)
    m_b = lt if trim else torch.full((B,), m)
    Wb = torch.minimum(torch.full((B,), W), torch.maximum(n_b, m_b))
    n_eff = torch.where(m_b > 0, torch.minimum(n_b, m_b + Wb), 0)
    R = ROWS
    ar = torch.arange(R)
    NEG = -(2**29)
    buf_g = torch.zeros((B, 2 * W + 2), dtype=torch.long)  # the hand-off, per pair
    buf_f = torch.zeros((B, 2 * W + 2), dtype=torch.long)
    rb = torch.full((B, R // 2), -go, dtype=torch.long)
    rows_b = torch.arange(B)

    def code_t(j):
        """Row 0's target code at column j ([B])."""
        inside = (j >= 1) & (j <= m_b)
        c = t[rows_b, (j - 1).clamp(0, max(m - 1, 0))] if m else torch.zeros_like(j)
        c = torch.where(j <= lt, c.clamp(max=stride - 1) if profile else c, t_pad)
        return torch.where(inside, c, t_out)

    def shift(first, x):
        return torch.cat([first[:, None], x[:, :-1]], dim=1)

    for i0 in range(0, int(n_eff.max()) if B else 0, R):
        act = i0 < n_eff
        later = torch.tensor(i0 > 0)  # the first sweep reads no hand-off
        last = i0 + R >= n_eff
        k_lo = (Wb - i0 - (R - 1)).clamp(min=0)
        k_hi = torch.minimum(2 * Wb, m_b + Wb - i0 - 1)
        K = k_hi - k_lo + 1
        j0 = k_lo + i0 + 1 - Wb
        exact = K >= OPEN
        steps = torch.where(exact, K + OPEN, (K + OPEN + GROUP - 1) // GROUP * GROUP)
        i = i0 + ar + 1
        c = q[:, (i - 1).clamp(max=max(n - 1, 0))] if n else torch.zeros((B, R), dtype=torch.long)
        if profile:
            c = c.clamp(max=stride - 1) * s1
        else:
            c = torch.where(c < A, c, -1)
        qc = torch.where(i[None] <= lq[:, None], c,
                         torch.where(i[None] <= n_b[:, None], q_pad, q_out))
        tc = torch.full((B, R), t_out, dtype=torch.long)
        g = torch.full((B, R), -go, dtype=torch.long)
        dg = g.clone()
        e = torch.full((B, R), NEG, dtype=torch.long)
        f = e.clone()
        prev_g, prev_f = buf_g.clone(), buf_f.clone()
        take = later & (j0 > 1)
        dg[:, 0] = torch.where(take, prev_g[rows_b, k_lo.clamp(max=2 * W)], -go)
        for s in range(int(steps[act].max()) if act.any() else 0):
            run = act & (s < steps)
            if not run.any():
                continue
            # closing: at odd E the row at its band's last offset reads past
            # the band of the row above, which ended two steps ago: dead up
            E = s - K
            dead = (run & exact & (E >= 0) & (E % 2 == 1))[:, None] & (
                ar[None] == (E // 2 + 1)[:, None])
            # row 0's inputs: the ring's slot, read from the previous sweep
            kp = k_lo + s + 1
            rd = later & (j0 + s >= 1) & (kp <= 2 * Wb)
            g_in = torch.where(rd, prev_g[rows_b, kp.clamp(max=2 * W + 1)], -go)
            f_in = torch.where(rd, prev_f[rows_b, kp.clamp(max=2 * W + 1)], NEG)
            tr = shift(code_t(j0 + s), tc)
            gu = torch.where(dead, -go, shift(g_in, g))
            sg = tab[qc + tr] if profile else torch.where(qc == tr, hit, miss)
            if affine:
                fn = torch.maximum(torch.where(dead, NEG, shift(f_in, f)) - ge, gu)
                en = torch.maximum(e - ge, g)
                h = torch.maximum(torch.maximum(dg + sg, torch.maximum(en, fn)),
                                  torch.zeros(()))
            else:
                fn, en = f, e
                h = torch.maximum(torch.maximum(dg + sg, torch.maximum(gu, g)),
                                  torch.zeros(()))
            gn = (h - go).long()
            valid = run[:, None] & (s - 2 * ar >= 0)[None] & (s - 2 * ar < K[:, None])
            ex = (run & exact)[:, None]
            ms = (run & ~exact)[:, None]
            # exact: rows inside their steps compute; a row about to start
            # takes its diagonal (before the row above moves)
            hi = s // 2 + 1
            if s < OPEN and hi < R:
                opening = run & exact
                dg[opening, hi] = g[opening, hi - 1]
            g = torch.where(ex & valid, gn, torch.where(ms, torch.where(valid, gn, -go), g))
            e = torch.where(ex & valid, en, torch.where(ms, torch.where(valid, en, NEG), e))
            f = torch.where(ex & valid, fn, torch.where(ms, torch.where(valid, fn, NEG), f))
            dg = torch.where((ex & valid) | ms, gu, dg)
            # every started row hands the codes down, done or not
            tc = torch.where((ex & (s - 2 * ar >= 0)[None]) | ms, tr, tc)
            pair_on = (valid[:, 0::2] | valid[:, 1::2]) | ms
            rb = torch.where(pair_on, torch.maximum(rb, torch.maximum(g[:, 0::2], g[:, 1::2])),
                             rb)
            # row ROWS - 1's hand-off
            x = s - OPEN
            wr = run & ~last & (x >= 0) & (x < K)
            kw = (k_lo + x).clamp(0, 2 * W)
            buf_g[rows_b[wr], kw[wr]] = g[wr, R - 1]
            buf_f[rows_b[wr], kw[wr]] = f[wr, R - 1]
    return (rb.amax(dim=1) + go).to(torch.int32)
