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
on its XLA scan on the device runs here in the kernel. It reads the
codes as the caller holds them, [B, n] / [B, m] uint8: the wrappers
transpose nothing.

``semiglobal_batch`` runs where its device says: on the CPU the plain
version, on a CUDA device the kernel, for every scoring the XLA tier
takes (gaps of either sign), never the plain version; a failed build or
launch raises. Under a gap <= 0 the kernel follows the XLA tier and the
oracle, not JAX's Pallas kernel, whose endpoint tracker assumes gaps > 0.
It counts its launches in ``semiglobal_batch.launches``, and those of
the affine, the pinned and the affine pinned instantiations also in
``.launches_affine``, ``.launches_pinned`` and
``.launches_affine_pinned``.

``semiglobal_skew_mirror`` replays the kernel's skewed tile step for
step in plain PyTorch on the CPU (the tests hold it against JAX's XLA
tier); nothing on the card path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from swtpu_torch.kernels import _build
from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.semiglobal_scan import MINUS_INF, gaps, semiglobal_batch_diag
from swtpu_torch.kernels.sw_batch import ptr
from swtpu_torch.kernels.sw_scan import _extended_table
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_semiglobal.cu"
#: query rows a sweep and steps a group, as csrc/sw_semiglobal.cu's ROWS
#: and GROUP (the mirror's schedule; ``semiglobal_launch_t`` asks the
#: library for its ROWS)
ROWS = 16
GROUP = 4


def _semiglobal_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_semiglobal
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i] + [p] * 9 + [i] * 9 + [p]
        fn.restype = ctypes.c_int
        lib.swtpu_sw_semiglobal_rows.restype = ctypes.c_int
    return lib, fn


def codes(qs, ts, device: torch.device, what: str):
    """[B, n] / [B, m] codes as the kernel takes them: contiguous uint8
    on ``device``, in the caller's layout (no transposes)."""
    if device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA, not {device}")
    q = as_codes(qs, device).contiguous()
    t = as_codes(ts, device).contiguous()
    if t.shape[0] != q.shape[0]:
        raise ValueError(f"batch mismatch: {q.shape[0]} queries vs {t.shape[0]} targets")
    return q, t


def lens_tensor(lens, B: int, device: torch.device):
    """Per-pair lengths as the kernel takes them: a contiguous int32 [B]
    tensor on ``device``, or None for the full widths."""
    if lens is None:
        return None
    out = torch.as_tensor(lens, dtype=torch.int32, device=device).contiguous()
    if tuple(out.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(out.shape)}")
    return out


def semiglobal_launch_t(q, t, match: int, mismatch: int, go: int, ge: int,
                        affine: bool, pin_end: bool, lens_q=None, lens_t=None,
                        table=None, n_codes=None, select: bool = False):
    """The launch alone, on the codes as the wrappers hand them (q [B, n],
    t [B, m] contiguous uint8 on one CUDA device: :func:`codes`) and
    lengths from :func:`lens_tensor`. ``mismatch`` is the score of a
    mismatch (negative). With ``table`` (``sw_profile.profile_table``) the
    profile instantiation runs, ``match`` is the matrix's largest |entry|
    (the packed key's bound, :func:`key_bits`) and ``mismatch`` 0; ``n_codes``
    (default: the table's stride) is the alphabet + 1, the codes whose
    scores the kernel copies to shared memory (a code past them scores as
    the pad it is). ``select`` makes an argmax launch keep (best, step)
    apart even where the packed key holds the scores (the tracker the
    launch takes for wider ones; ``chip_smoke.py`` times the two side by
    side). Allocates the int32 scratch that hands a sweep's last
    row to the next (past one sweep of rows: [m, B], affine [m, B, 2] for
    H and F) and the outputs and launches on the device's current stream.
    Returns (score, end_i, end_j) int32 [B]."""
    device = q.device
    for x in (q, t):
        if (x.dtype != torch.uint8 or x.device != device or device.type != "cuda"
                or x.dim() != 2 or not x.is_contiguous()):
            raise ValueError(
                "the semi-global kernel takes contiguous uint8 [B, L] codes on one "
                f"CUDA device, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    if max(B, n, m) >= 2**31:  # the C interface takes int sizes
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    for x in (lens_q, lens_t):
        if x is not None and (x.dtype != torch.int32 or x.device != device
                              or tuple(x.shape) != (B,) or not x.is_contiguous()):
            raise ValueError(
                f"the semi-global kernel takes contiguous int32 [{B}] lengths "
                f"on the codes' device, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    stride = 0
    if table is not None:
        stride = table.shape[0]
        if (table.dtype != torch.int32 or table.device != device
                or table.shape != (stride, stride) or not table.is_contiguous()):
            raise ValueError(
                "the semi-global profile kernel takes a square contiguous int32 "
                f"table on the codes' device, got {table.dtype} "
                f"{tuple(table.shape)} on {table.device}"
            )
        n_codes = stride if n_codes is None else int(n_codes)
    lib, fn = _semiglobal_fn()
    i32 = dict(dtype=torch.int32, device=device)
    scratch = None
    if n > lib.swtpu_sw_semiglobal_rows():  # rows handed from sweep to sweep
        scratch = torch.empty((m, B, 2) if affine else (m, B), **i32)
    out = torch.empty((3, B), **i32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            int(affine), int(table is not None), 2 if pin_end else int(select),
            ptr(q), ptr(t),
            ptr(table), ptr(lens_q), ptr(lens_t), ptr(scratch), ptr(out[0]),
            ptr(out[1]), ptr(out[2]), B, n, m, int(match), int(mismatch), stride,
            n_codes or 0, go, ge, stream,
        )
    _build.check(lib, err, "sw_semiglobal")
    return out[0], out[1], out[2]


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
    q, t = codes(qs, ts, dev, "semi-global")
    B = q.shape[0]
    out = semiglobal_launch_t(
        q, t, int(match), -int(mismatch), go, ge, affine, pin_end,
        lens_tensor(lens_q, B, dev), lens_tensor(lens_t, B, dev),
    )
    count(semiglobal_batch, affine, pin_end)
    return out


semiglobal_batch.launches = 0
semiglobal_batch.launches_affine = 0
semiglobal_batch.launches_pinned = 0
semiglobal_batch.launches_affine_pinned = 0


def key_bits(n: int, m: int, match: int, mismatch: int, go: int, ge: int):
    """The mirror's copy of csrc/sw_semiglobal.cu's
    ``swtpu_sw_semiglobal_key_bits`` (the launch asks the library): the
    step bits k of the argmax forms' packed tracker (key = (H - go) x 2^k
    + 2^k - 1 - step), or None when the key cannot hold these sizes and
    scores and the kernel keeps (best, step) apart. Each step of a path
    moves H by at most the largest |score|, |go| or |ge|: a profile launch
    passes its matrix's largest |entry| as ``match``."""
    k = max(m + ROWS + GROUP - 1, 0).bit_length()
    mag = max(abs(match), abs(mismatch), abs(go), abs(ge))
    span = (n + m + ROWS + GROUP) * mag + abs(go) + 1
    return k if k < 31 and span < 2 ** (31 - k) else None


# -- a plain mirror of the kernel's skewed tile (tests only) -----------------

_NEG_EF = -(2**29)
_INT_MAX = 2**31 - 1


def _col_rows(q, idx):
    """q[:, idx] for row indices ``idx`` ([R]), 0 where idx >= q's width."""
    n = q.shape[1]
    out = q[:, idx.clamp(max=max(n - 1, 0))] if n else torch.zeros(
        (q.shape[0], len(idx)), dtype=q.dtype)
    return torch.where(idx[None] < n, out, 0)


def semiglobal_skew_mirror(qs, ts, match=1, mismatch=1, gap=1, gap_open=None,
                           gap_extend=None, lens_q=None, lens_t=None,
                           pin_end=False, params: ScoringParams = None):
    """The kernel's schedule replayed in PyTorch on the CPU over [B, ROWS]:
    each pair runs its own n_b = min(lq, n) rows and m_b = min(lt, m)
    columns (global: the interior corner's, else no DP) in sweeps of ROWS
    rows; at step s row r computes column s - r from row r - 1's state of
    the step before. With m_b >= ROWS only the rows inside [0, m_b)
    compute, and a row that starts next step takes
    its diagonal; else steps run in groups of GROUP, masked when a step
    has a row outside [0, m_b) (there a row keeps H and tracker, and E,
    F, the diagonal and the code shift on regardless, E restarting at
    -inf at the row's first column), unmasked groups commit every row. H kept minus the gap open; row 0 reads the row above
    from the scratch a group ahead (the first sweep: the boundary chain),
    row ROWS - 1 writes it (not in the last sweep); per-row (best, step)
    on a strict '>', held in one key where :func:`key_bits` allows (the
    launch's choice), folded in row order after each sweep from the
    origin; after the DP row 0's and column 0's first maxima (closed form:
    their chains are monotone) merge in row-major order.
    ``params`` runs the profile form (the extended table), else uniform
    scoring as :func:`semiglobal_batch`. Same contract. Nothing on the
    card path calls it."""
    cpu = torch.device("cpu")
    q = as_codes(qs, cpu).long()
    t = as_codes(ts, cpu).long()
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    if params is not None:
        tab = torch.from_numpy(_extended_table(params)).long()
        stride, pad = tab.shape[0], tab.shape[0] - 1
        go, ge, affine = int(params.gap_open), int(params.gap_extend), not params.is_linear
        tab = tab.reshape(-1) + go
        kmatch, kmiss = int(abs(params.matrix).max()), 0
    else:
        go, ge, affine = gaps(gap, gap_open, gap_extend)
        pad, hit, miss = 4, int(match) + go, -int(mismatch) + go
        kmatch, kmiss = int(match), -int(mismatch)
    kbits = None if pin_end else key_bits(n, m, kmatch, kmiss, go, ge)
    kmul = 2 ** (kbits or 0)
    origin = -go * kmul + kmul - 1 if kbits is not None else -go

    def chain(k):
        return -go - (k - 1) * ge if affine else -k * go

    lq = torch.as_tensor(n if lens_q is None else lens_q).long().expand(B)
    lt = torch.as_tensor(m if lens_t is None else lens_t).long().expand(B)
    n_b, m_b = lq.clamp(0, n), lt.clamp(0, m)
    best, bi, bj = (torch.zeros(B, dtype=torch.long) for _ in range(3))
    if pin_end:
        inside = (lq >= 0) & (lq <= n) & (lt >= 0) & (lt <= m)
        best = torch.where(inside & (lq == 0), torch.where(lt == 0, 0, chain(lt)),
                           torch.where(inside & (lt == 0), chain(lq), MINUS_INF))
        bi, bj = torch.where(inside, lq, 0), torch.where(inside, lt, 0)
        n_b = torch.where(inside & (lq > 0) & (lt > 0), lq, 0)
    n_col = n_b  # column 0's cells (argmax)
    n_b = torch.where(m_b == 0, 0, n_b)
    R = ROWS
    # the pairs whose rows start and end a step apart (no masked groups)
    exact = m_b >= R
    ar = torch.arange(R)
    hrow = torch.zeros((B, m), dtype=torch.long)  # the [m, B] scratch, per pair
    frow = torch.zeros((B, m), dtype=torch.long)

    def col(x, j):
        """x[:, j] per pair (j a [B] tensor), 0 where j is outside [0, m)."""
        ok = (j >= 0) & (j < x.shape[1])
        return torch.where(ok, x.gather(1, j.clamp(0, max(x.shape[1] - 1, 0))[:, None]
                                        )[:, 0] if x.shape[1] else 0, 0)

    def shift(first_col, x):
        """Row r takes row r - 1's value, row 0 ``first_col``."""
        return torch.cat([first_col[:, None], x[:, :-1]], dim=1)

    for i0 in range(0, int(n_b.max()) if B else 0, R):
        act = i0 < n_b  # the pairs whose loop runs this sweep
        first, last = i0 == 0, i0 + R >= n_b
        i = i0 + ar + 1
        c = torch.where(i[None] <= n_b[:, None], _col_rows(q, i - 1), pad)
        qc = c.clamp(max=pad) * stride if params is not None else torch.where(c < 4, c, -1)
        tc = torch.zeros((B, R), dtype=torch.long)
        d = (chain(i) - go).expand(B, R).clone()
        dg = d.clone()
        dg[:, 0] = (0 if first else chain(i0)) - go
        e = torch.full((B, R), _NEG_EF, dtype=torch.long)
        f = e.clone()
        rb = torch.where(i[None] <= n_b[:, None], origin, _INT_MAX)
        rs = torch.full((B, R), -1, dtype=torch.long)
        ring_h = torch.stack([
            (chain(u + 1) - go) * torch.ones(B, dtype=torch.long) if first
            else torch.where(u < m_b, col(hrow, torch.full((B,), u)), 0) for u in range(GROUP)], 1)
        ring_f = torch.stack([
            torch.full((B,), _NEG_EF) if first
            else torch.where(u < m_b, col(frow, torch.full((B,), u)), 0) for u in range(GROUP)], 1)
        for s0 in range(0, int((m_b[act] + R - 1).max()) if act.any() else 0, GROUP):
            run = act & (s0 < m_b + R - 1)  # the pairs whose group loop runs
            masked = (s0 < R - 1) | (s0 + GROUP > m_b)
            for u in range(GROUP):
                s = s0 + u
                sv = torch.full((B,), s)
                tn = torch.where(s < m_b, col(t, sv), 0)
                if params is not None:
                    tn = tn.clamp(max=pad)
                up_in, f_in = ring_h[:, u].clone(), ring_f[:, u].clone()
                ahead = torch.full((B,), s + GROUP)
                if first:
                    ring_h[:, u] = torch.where(run, chain(s + GROUP + 1) - go, ring_h[:, u])
                else:
                    ld = run & (ahead < m_b)
                    ring_h[:, u] = torch.where(ld, col(hrow, ahead), ring_h[:, u])
                    if affine:
                        ring_f[:, u] = torch.where(ld, col(frow, ahead), ring_f[:, u])
                tr = shift(tn, tc)
                up = shift(up_in, d)
                sg = (tab[qc + tr] if params is not None
                      else torch.where(qc == tr, hit, miss))
                if affine:
                    fn = torch.maximum(shift(f_in, f) - ge, up)
                    # a masked row restarts E at its first column
                    e_in = torch.where((~exact)[:, None] & (ar == s)[None], _NEG_EF, e)
                    en = torch.maximum(e_in - ge, d)
                    h = torch.maximum(torch.maximum(dg + sg, en), fn)
                else:
                    fn, en = f, e
                    h = torch.maximum(torch.maximum(dg + sg, up), d)
                dn = h - go
                runc = run[:, None]
                inside = (s - ar >= 0)[None] & (s - ar < m_b[:, None])
                valid = runc & (inside | ~(masked | exact)[:, None])
                moves = runc & (inside | ~exact[:, None])  # code, diagonal, E, F
                starts = runc & exact[:, None] & (ar == s + 1)[None]
                tc, dg = torch.where(moves, tr, tc), torch.where(moves | starts, up, dg)
                e, f = torch.where(moves, en, e), torch.where(moves, fn, f)
                d = torch.where(valid, dn, d)
                if kbits is not None:
                    rb = torch.where(valid, torch.maximum(rb, dn * kmul + kmul - 1 - s), rb)
                else:
                    upd = valid & (dn > rb)
                    rs = torch.where(upd, s, rs)
                    rb = torch.where(upd, dn, rb)
                j = s - (R - 1)
                if 0 <= j < m:
                    wr = run & ~last & (~masked | (j < m_b))
                    hrow[:, j] = torch.where(wr, d[:, R - 1], hrow[:, j])
                    frow[:, j] = torch.where(wr, f[:, R - 1], frow[:, j])
        for r in range(R):
            if pin_end:
                best = torch.where(act & (i0 + r + 1 == n_b), d[:, r] + go, best)
                continue
            rbr, rsr = rb[:, r], rs[:, r]
            if kbits is not None:  # the key's best and step
                hit_ = (rbr != _INT_MAX) & (rbr > origin)
                rsr = torch.where(hit_, kmul - 1 - (rbr & (kmul - 1)), -1)
                rbr = rbr >> kbits
            upd = act & (rsr >= 0) & (rbr + go > best)
            best = torch.where(upd, rbr + go, best)
            bi = torch.where(upd, i0 + r + 1, bi)
            bj = torch.where(upd, rsr - r + 1, bj)
    if not pin_end:
        for length, tracked, row in ((m_b, lq >= 0, True), (n_col, lt >= 0, False)):
            # a boundary chain's first maximum (its last cell when it rises,
            # else its first), merged in row-major order
            k = length if ge < 0 else torch.ones_like(length)
            v, i, j = chain(k), (0 if row else k), (k if row else 0)
            upd = tracked & (length >= 1) & (
                (v > best) | ((v == best) & ((i < bi) | ((i == bi) & (j < bj)))))
            best, bi, bj = (torch.where(upd, v, best), torch.where(upd, i, bi),
                            torch.where(upd, j, bj))
    return tuple(x.to(torch.int32) for x in (best, bi, bj))

