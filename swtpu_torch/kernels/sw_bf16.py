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
with the plain version; a failed build or launch raises. It counts its
launches in ``sw_bf16.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.sw_batch import (
    _uniform_match_mismatch,
    kernel_layout,
    ptr,
)
from swtpu_torch.kernels.sw_scan import _shift1
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_bf16.cu"
MAX_EXACT = 256  # bf16 represents |int| <= 256 exactly
ROWS = 8  # the TPU kernel's row group: n pads to a multiple of this
CHUNK = 16  # its column chunk: m pads to a multiple of this
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


def bf16_layout(qs, ts, device: torch.device):
    """[B, n] / [B, m] codes as the kernel takes them: [n, Be] / [m, Be]
    contiguous uint8 on ``device``, Be = B rounded up to even; an odd
    batch gets one pad pair (query 4, target 5), dropped afterwards."""
    qs = as_codes(qs, device)
    ts = as_codes(ts, device)
    if qs.shape[0] % 2:
        qs = torch.cat([qs, torch.full_like(qs[:1], Q_PAD)])
        ts = torch.cat([ts, torch.full_like(ts[:1], T_PAD)])
    return kernel_layout(qs, ts, device, "bf16")


def bf16_launch_t(qT, tT, params: ScoringParams, allow_overflow=False):
    """The launch alone, on codes already in the kernel's layout: qT
    [n, Be] and tT [m, Be] contiguous uint8 on one CUDA device, Be even.
    Runs the guard, allocates the [mp, Be / 2] previous-row scratch and
    the [Be] int32 scores there, and launches on that device's current
    stream."""
    for x in (qT, tT):
        if (x.dtype != torch.uint8 or x.device != qT.device
                or x.device.type != "cuda" or not x.is_contiguous()):
            raise ValueError(
                "the bf16 kernel takes contiguous uint8 codes on one CUDA "
                f"device, got {x.dtype} on {x.device}"
            )
    n, Be = qT.shape
    m = tT.shape[0]
    if tT.shape[1] != Be or Be % 2 or (qT.data_ptr() | tT.data_ptr()) % 2:
        raise ValueError(
            "the bf16 kernel takes an even batch on both sides, 2-byte "
            f"aligned, got {Be} and {tT.shape[1]}"
        )
    if max(Be, n, m) >= 2**31 - CHUNK:  # the C interface takes int sizes
        raise ValueError(f"shape too large for one launch: {Be}, {n}, {m}")
    match, mismatch, gap, g = _guard_bf16(params, n, allow_overflow)
    s_eq, s_ne, gapb = _constant_bits(match, mismatch, gap)
    dev = qT.device
    mp = m + (-m) % CHUNK
    hrow = torch.empty((mp, Be // 2), dtype=torch.int32, device=dev)
    score = torch.empty((Be,), dtype=torch.int32, device=dev)
    lib, fn = _bf16_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            ptr(qT), ptr(tT), ptr(hrow), ptr(score), Be // 2, n, m,
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
    B, n = qs.shape[0], qs.shape[-1]
    _guard_bf16(params, n, allow_overflow)
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_bf16_plain(qs, ts, params, allow_overflow, dev)
    qT, tT = bf16_layout(qs, ts, dev)
    out = bf16_launch_t(qT, tT, params, allow_overflow)
    sw_bf16.launches += 1
    return out[:B]


sw_bf16.launches = 0
