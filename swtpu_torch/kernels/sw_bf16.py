"""Batched local-alignment scores in the bf16 reduced-precision tier: the
packed-bf16 CUDA kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/sw_bf16.py`` (``MAX_EXACT``,
``bf16_tier_supported``, ``sw_batch_bf16_pallas``). The kernel is
``csrc/sw_bf16.cu``, whose head note says what it replaces, what bounds
it and how. The scoring is divided by g = gcd(match, mismatch, gap), and
every DP value is a bf16 rounded after every operation in the TPU
kernel's order:

    pre  = max(diag + s, 0)
    h    = max(pre, max(up, left) - gap)
    best = max(best, pre)

bf16 represents every integer of magnitude <= 256, so the scores are
exact while n_pad * match / g <= 256 (``bf16_tier_supported``, evaluated
on n padded to a multiple of 8). With ``allow_overflow=True`` any uniform
linear scoring with mismatch < 0 < gap is taken, and a result below
255 * g is still exact (``batch/promote.py``).

Three properties of the TPU tier that the port keeps, because they decide
its results:

- equal codes match, pads included: ``s = match - (match - mismatch) *
  min(d * d, 1)`` with d = q - t, so a query pad (4) matches a target N
  (4), where the int32 tiers score every pad at -2^20;
- queries are padded with code 4 to a multiple of 8 rows and targets with
  code 5 to a multiple of 16 columns, as the JAX wrapper pads them, so pad
  rows can match a target N;
- above the exact range the rounded values drift, up or down; the kernel and
  ``sw_bf16_plain`` round alike and agree bit for bit there too.

``sw_bf16`` runs the guard first, then where its device says: on the CPU
the plain version, on a CUDA device the kernel, which it never replaces
with the plain version; a failed build or launch raises. On the card the
kernel reads the [B, n] / [B, m] codes as the caller holds them and makes
the TPU wrapper's pad rows and columns itself: no transposes, and no copy
of an odd batch (the last thread's high half runs a pad pair of its own).
It counts its launches in ``sw_bf16.launches``. ``bf16_skew_mirror``
replays the kernel's schedule on the CPU (tests only).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.semiglobal_batch import codes
from swtpu_torch.kernels.sw_batch import _uniform_match_mismatch, ptr
from swtpu_torch.kernels.sw_scan import _shift1
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_bf16.cu"
MAX_EXACT = 256  # bf16 represents |int| <= 256 exactly
ROWS = 8  # the TPU kernel's row group: n pads to a multiple of this
CHUNK = 16  # its column chunk: m pads to a multiple of this
SWEEP = 16  # the kernel's query rows a sweep (its skewed tile)
Q_PAD = 4
T_PAD = 5


def _gcd(match: int, mismatch: int, gap: int) -> int:
    return math.gcd(math.gcd(abs(match), abs(mismatch)), abs(gap))


def bf16_tier_supported(params: ScoringParams, n: int) -> bool:
    """True iff this scoring/length fits the exact-bf16 range."""
    if not params.is_linear or params.gap <= 0:
        return False
    mm = _uniform_match_mismatch(params)
    if mm is None or mm[1] >= 0:
        return False
    match, mismatch = mm
    g = _gcd(match, mismatch, int(params.gap))
    return n * (match // g) <= MAX_EXACT


def padded_rows(n: int) -> int:
    """n rounded up to the row group, as the TPU wrapper pads queries."""
    return n + (-n) % ROWS


def _guard_bf16(params: ScoringParams, n: int, allow_overflow: bool):
    """(match, mismatch, gap, g): the scoring divided by g, or
    NotImplementedError outside JAX's guards."""
    if not bf16_tier_supported(params, padded_rows(n)):
        mm = _uniform_match_mismatch(params)
        ok_shape = (
            params.is_linear and params.gap > 0 and mm is not None and mm[1] < 0
        )
        if not (allow_overflow and ok_shape):
            raise NotImplementedError(
                "bf16 tier needs uniform scoring with n*match/gcd <= 256; "
                "route to sw_batch"
            )
    match, mismatch = _uniform_match_mismatch(params)
    gap = int(params.gap)
    g = _gcd(match, mismatch, gap)
    return match // g, mismatch // g, gap // g, g


def bf16_constants(match: int, mismatch: int, gap: int, device=None):
    """(s_eq, s_ne, gap) as 0-d bf16 tensors: the TPU kernel's
    ``match - (match - mismatch) * min(d * d, 1)`` at d = 0 and at any
    d != 0, rounded as bf16 arithmetic rounds it."""
    bf = dict(dtype=torch.bfloat16, device=device)
    matchb = torch.tensor(match, **bf)
    diffb = torch.tensor(match - mismatch, **bf)
    oneb = torch.tensor(1, **bf)
    d = torch.tensor([0, 1], **bf)
    s = matchb - diffb * torch.minimum(d * d, oneb)
    return s[0], s[1], torch.tensor(gap, **bf)


@functools.lru_cache(maxsize=64)
def _constant_bits(match: int, mismatch: int, gap: int):
    """(s_eq, s_ne, gap) of :func:`bf16_constants` as the 16-bit patterns
    the kernel takes."""
    return tuple(
        int(x.reshape(1).view(torch.int16)[0]) & 0xFFFF
        for x in bf16_constants(match, mismatch, gap)
    )


def _pad_tier(qs, ts, device):
    """Codes on ``device``, padded as the TPU wrapper pads them: queries
    with 4 to a multiple of 8 rows, targets with 5 to a multiple of 16."""
    qs = as_codes(qs, device)
    ts = as_codes(ts, device)
    if ts.shape[0] != qs.shape[0]:
        raise ValueError(
            f"batch mismatch: {qs.shape[0]} queries vs {ts.shape[0]} targets"
        )
    n, m = qs.shape[1], ts.shape[1]
    qs = torch.nn.functional.pad(qs, (0, (-n) % ROWS), value=Q_PAD)
    ts = torch.nn.functional.pad(ts, (0, (-m) % CHUNK), value=T_PAD)
    return qs, ts


def sw_bf16_plain(qs, ts, params: ScoringParams, allow_overflow=False,
                  device=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`sw_bf16`: the anti-diagonal tier in
    ``torch.bfloat16``, with the same padding, per-cell formula and order
    of operations, each rounded to bf16. Returns [B] int32 on ``device``.

    Slot i of a diagonal vector holds DP row i (slot 0 is the boundary
    row); cells left of column 1 or right of the padded width are held
    at 0 and never reach the best.
    """
    n0 = qs.shape[-1]
    match, mismatch, gap, g = _guard_bf16(params, n0, allow_overflow)
    dev = resolve_device(device, like=qs)
    qs, ts = _pad_tier(qs, ts, dev)
    B, n = qs.shape
    m = ts.shape[1]
    s_eq, s_ne, gapb = bf16_constants(match, mismatch, gap, dev)
    zero = torch.zeros((), dtype=torch.bfloat16, device=dev)
    q_slot = torch.cat([torch.full_like(qs[:, :1], Q_PAD), qs], dim=1)
    frame = torch.full((B, n + 1), T_PAD, dtype=torch.uint8, device=dev)
    ts_rev_pad = torch.cat([frame, ts.flip(1), frame], dim=1)
    rows = torch.arange(n + 1, device=dev)
    prev1 = torch.zeros((B, n + 1), dtype=torch.bfloat16, device=dev)
    prev2 = prev1
    best = torch.zeros((B,), dtype=torch.bfloat16, device=dev)
    for d in range(2, n + m + 1):
        off = m - d + n + 1
        t_slot = ts_rev_pad[:, off : off + n + 1]  # t[d - i - 1] at slot i
        j = d - rows
        valid = (rows >= 1) & (j >= 1) & (j <= m)
        s = torch.where(q_slot == t_slot, s_eq, s_ne)
        pre = torch.maximum(_shift1(prev2, 0) + s, zero)
        h = torch.maximum(pre, torch.maximum(_shift1(prev1, 0), prev1) - gapb)
        best = torch.maximum(best, torch.where(valid, pre, zero).amax(dim=1))
        prev2, prev1 = prev1, torch.where(valid, h, zero)
    return best.to(torch.int32) * g


def _bf16_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def bf16_launch_t(q, t, params: ScoringParams, allow_overflow=False):
    """The launch alone, on the codes as the wrapper hands them: q [B, n]
    and t [B, m] contiguous uint8 on one CUDA device (``codes``), any B.
    Runs the guard, allocates the [mp, ceil(B / 2)] row buffer (when the
    padded query spans more than one sweep of ROWS rows) and the [B]
    int32 scores there, and launches on that device's current stream."""
    for x in (q, t):
        if (x.dtype != torch.uint8 or x.device != q.device
                or x.device.type != "cuda" or not x.is_contiguous() or x.dim() != 2):
            raise ValueError(
                "the bf16 kernel takes [B, L] contiguous uint8 codes on one "
                f"CUDA device, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    if max(B, n, m) >= 2**31 - CHUNK:  # the C interface takes int sizes
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    match, mismatch, gap, g = _guard_bf16(params, n, allow_overflow)
    s_eq, s_ne, gapb = _constant_bits(match, mismatch, gap)
    dev = q.device
    mp = m + (-m) % CHUNK
    hrow = (torch.empty((mp, (B + 1) // 2), dtype=torch.int32, device=dev)
            if padded_rows(n) > SWEEP else None)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    lib, fn = _bf16_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            ptr(q), ptr(t), ptr(hrow), ptr(score), B, n, m,
            s_eq, s_ne, gapb, g, stream,
        )
    _build.check(lib, err, "sw_bf16")
    return score


def sw_bf16(qs, ts, params: ScoringParams, allow_overflow=False,
            device=None) -> torch.Tensor:
    """Batched local-alignment scores via the bf16 reduced-precision tier.

    qs: [B, n] codes, ts: [B, m] codes; numpy or torch. Same contract as
    ``sw_batch`` (uniform match/mismatch, mismatch < 0 < gap) plus the
    range bound n_pad * match / g <= 256, n_pad being n rounded up to 8.
    Returns [B] int32 on ``device`` (default: the card), equal to
    ``oracle.sw_score`` per pair of codes 0..3 inside the bound.
    ``allow_overflow=True`` lifts the bound: a result below 255 * g is
    still exact, and a larger one marks a pair to re-run at int32.
    Raises NotImplementedError outside these guards.
    """
    n = qs.shape[-1]
    _guard_bf16(params, n, allow_overflow)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_bf16_plain(qs, ts, params, allow_overflow, dev)
    q, t = codes(qs, ts, dev, "bf16")
    out = bf16_launch_t(q, t, params, allow_overflow)
    sw_bf16.launches += 1
    return out


sw_bf16.launches = 0


# -- a plain mirror of the kernel's skewed tile (tests only) -----------------

_NEVER = 0x100  # the code of the rows past n_pad: no target byte equals it


def _s16(x: torch.Tensor) -> torch.Tensor:
    """16-bit patterns (any int tensor) as signed 16-bit values in int64."""
    return ((x.long() + 2**15) & 0xFFFF) - 2**15


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int16).view(torch.bfloat16)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16).long()


def bf16_skew_mirror(qs, ts, params: ScoringParams, allow_overflow=False):
    """The kernel's schedule replayed in PyTorch on the CPU, on bf16 bit
    patterns: an odd batch gets the last thread's pad pair (query 4,
    target 5), rows past n are pad rows of code 4 up to n_pad and rows
    past n_pad hold a code no target byte equals; sweeps of SWEEP rows as
    a skewed tile (row r at column s - r, from row r - 1's state of the
    step before), each row keeping H and G = round(H - gap), the cell
    H = max(pre, G_left, G_up) as a signed 16-bit max, the score as the
    indicator times the step plus the base; the last row's H handed to
    the next sweep through a per-pair [mp] buffer; the best the largest H.
    Same contract as :func:`sw_bf16`. Nothing on the card path calls it."""
    n0 = qs.shape[-1]
    match, mismatch, gap, g = _guard_bf16(params, n0, allow_overflow)
    cpu = torch.device("cpu")
    q = as_codes(qs, cpu).long()
    t = as_codes(ts, cpu).long()
    B, n = q.shape
    m = t.shape[1]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    if B % 2:
        q = torch.cat([q, torch.full((1, n), Q_PAD, dtype=torch.long)])
        t = torch.cat([t, torch.full((1, m), T_PAD, dtype=torch.long)])
    Be = q.shape[0]
    np_, mp = padded_rows(n), m + (-m) % CHUNK
    s_eq, s_ne, gap_bits = _constant_bits(match, mismatch, gap)
    eq_ind = s_ne < s_eq
    base, step = (s_ne, s_eq - s_ne) if eq_ind else (s_eq, s_ne - s_eq)
    gapb = _bf(_s16(torch.tensor(gap_bits)))
    t = torch.cat([t, torch.full((Be, mp - m), T_PAD, dtype=torch.long)], dim=1)
    R = SWEEP
    ar = torch.arange(R)
    neg_gap = _bits(_bf(torch.zeros((), dtype=torch.long)) - gapb)
    hbuf = torch.zeros((Be, mp), dtype=torch.long)  # the [mp, Bh] buffer, per pair
    best = torch.zeros((Be,), dtype=torch.long)

    def shift(first, x):
        """Row r takes row r - 1's value, row 0 ``first``."""
        return torch.cat([first[:, None], x[:, :-1]], dim=1)

    for i0 in range(0, np_ if mp else 0, R):
        first, last = i0 == 0, i0 + R >= np_
        i = i0 + ar
        qr = torch.where(i < n, q[:, i.clamp(max=max(n - 1, 0))] if n else 0,
                         torch.where(i < np_, Q_PAD, _NEVER).expand(Be, R))
        tc = torch.zeros((Be, R), dtype=torch.long)
        h = torch.zeros((Be, R), dtype=torch.long)
        gg = torch.full((Be, R), int(neg_gap))
        dg = torch.zeros((Be, R), dtype=torch.long)
        for s in range(mp + R - 1):
            tn = t[:, min(s, mp - 1)]
            up_h = hbuf[:, s] if (not first and s < mp) else torch.zeros(Be, dtype=torch.long)
            up_g = _bits(_bf(_s16(up_h)) - gapb)
            tr, uh, ug = shift(tn, tc), shift(up_h, h), shift(up_g, gg)
            x = qr ^ tr
            ind = (1 - x).clamp(min=0) if eq_ind else x.clamp(max=1)
            sc = _bf(_s16(ind * step + base))
            pre = _bits(torch.clamp(_bf(_s16(dg)) + sc, min=0))
            hn = torch.maximum(torch.maximum(pre, _s16(gg)), _s16(ug))
            act = ((s - ar >= 0) & (s - ar < mp))[None]
            gg = torch.where(act, _bits(_bf(hn) - gapb), gg)
            h = torch.where(act, hn, h)
            dg = torch.where(act, uh, dg)
            tc = torch.where(act, tr, tc)
            best = torch.maximum(best, h.amax(dim=1))
            if not last and 0 <= s - (R - 1) < mp:
                hbuf[:, s - (R - 1)] = h[:, R - 1]
    scores = _bf(best).float().to(torch.int32) * g
    return scores[:B]
