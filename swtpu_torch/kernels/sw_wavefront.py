"""Batched local-alignment scores on the anti-diagonal (wavefront)
schedule: the CUDA wavefront kernel, its plain PyTorch version and a CPU
mirror of the kernel's schedule.

Port of ``swtpu/kernels/pallas/sw_wavefront.py`` (``sw_wavefront_pallas``,
``_profile_table``). One alignment's DP matrix is swept along
anti-diagonals with one lane per query position (n <= 128) and pairs on
the other axis; any substitution matrix, linear gap only (affine raises,
as in JAX). The kernel is ``csrc/sw_wavefront.cu``: pairs stream back to
back through a warp's anti-diagonal, 8 rows a lane (:func:`wavefront_stream`
picks the pairs a stream, :func:`wavefront_form` the lane table's form);
its head note says what it replaces, what bounds it and how. Under a
negative gap the score is the TPU schedule's, which counts its phantom
rows and padded columns and so sits above the oracle's: the kernel runs
that schedule then, one pair a stream over exactly
:func:`wavefront_steps` steps, and gives what JAX's Pallas kernel gives.

``sw_wavefront_plain`` repeats the TPU kernel step by step on [B, 128]
tensors: the same 128 lanes (phantom ones past n score -2^20), the same
``ceil((n + m - 1) / 32) * 32`` steps, and -2^20 for codes off the
target and codes >= the alphabet. It builds each diagonal's scores as it
goes; the TPU's precomputed score stream (``_prepare``) is a workaround
for gathers on its vector unit and is not carried over.
``wavefront_stream_mirror`` replays the CUDA kernel's streams on any
device, step for step (the tests hold it against the oracle and JAX;
on the card it is held against the kernel).

``sw_wavefront`` runs where its device says: on the CPU the plain
version, on a CUDA device the kernel (counted in
``sw_wavefront.launches``, those under a negative gap also in
``.launches_negative``), never the plain version there; a failed build
or launch, or a scoring the kernel refuses (Gotoh, as JAX's), raises. Queries longer than 128 go pair by pair to the
strip tile with zero boundaries (``longpair_strip.strip_tile``: the CUDA
strip kernel on the card, the plain tile on the CPU), as JAX routes them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.sw_batch import ptr
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_wavefront.cu"
Q_PAD = 4
T_PAD = 5
NEG = -(2**20)
#: the separator columns' score in the kernel's table under a gap >= 0:
#: below any D a pair can reach, so a separator cell's diagonal never wins
NEG_SEP = -(2**30)
LANE = 128  # query positions per pair
STEPS_PB = 32  # the TPU's diagonals per grid step: the step count's multiple
MAX_LETTERS = 31  # the kernel's table is at most 32 x 33 with the pad row
ROWS = 8  # query positions a lane of the kernel (16 lanes a stream)
MAX_PAIRS = 16  # pairs a stream (a stream's lanes write them, one a lane)
STREAM_WARPS = 4  # warps a block (csrc/sw_wavefront.cu WARPS), two streams a warp
#: blocks an SM the launch aims for (8 warps: enough to hide a step's
#: chain); a stream's head and tail (15 iterations) favour fewer, longer
#: streams
STREAM_BLOCKS_PER_SM = 2
PAIR_MAX_LETTERS = 4  # alphabets the kernel's table by pairs of columns takes
SMEM_PER_SM = 233472  # shared memory an H100 SM holds, 1 KB of it reserved a block
RING_WORDS = 256  # target values a stream keeps in flight (csrc RING)

_tables: Dict[Tuple[bytes, Tuple[int, ...], int, str], torch.Tensor] = {}


def _profile_table(params: ScoringParams) -> np.ndarray:
    """[A + 1, A + 1] int32: the matrix, with the pad row and column
    (code A) at -2^20 (the plain version's table)."""
    A = params.alphabet_size
    tab = np.full((A + 1, A + 1), NEG, dtype=np.int32)
    tab[:A, :A] = params.matrix.astype(np.int32)
    return tab


def _stream_table(params: ScoringParams) -> np.ndarray:
    """[A + 1, A + 2] int32: the kernel's (and the mirror's) table, the
    gap folded in (H is kept minus it). Rows: the A letters, then the pad
    (codes >= A). Columns: 0 the separator (-2^30; under a negative gap,
    where every column outside the target scores as the TPU's padded
    columns, the pad), 1..A the letters, A + 1 the pad; entries S + gap,
    pads -2^20 + gap."""
    A = params.alphabet_size
    g = int(params.gap)
    tab = np.full((A + 1, A + 2), NEG + g, dtype=np.int64)
    tab[:A, 1:A + 1] = params.matrix.astype(np.int64) + g
    if g >= 0:
        tab[:, 0] = NEG_SEP
    return tab.astype(np.int32)


def wavefront_steps(n: int, m: int) -> int:
    """The TPU's step count: n + m - 1 diagonals padded to 32."""
    return -(-(n + m - 1) // STEPS_PB) * STEPS_PB


def wavefront_period(m: int) -> int:
    """A pair's columns in the kernel's stream: its m target columns and
    a separator block of ROWS .. 2 ROWS - 1 columns, a multiple of ROWS."""
    return m + ROWS + (-m) % ROWS


def wavefront_form(letters: int) -> bool:
    """Whether the kernel holds its lane table by pairs of columns (one
    8-byte lookup for a position's two steps; alphabets of up to
    PAIR_MAX_LETTERS letters) rather than by columns."""
    return letters <= PAIR_MAX_LETTERS


def wavefront_refusal(params: ScoringParams) -> Optional[str]:
    """Why the kernel does not take ``params``, or None when it does: a
    linear gap of any sign (JAX's Pallas kernel refuses Gotoh too)."""
    if not params.is_linear:
        return ("the wavefront kernel takes a linear gap only, as JAX's Pallas kernel "
                "does: run Gotoh on best_engine")
    return None


def stream_smem(letters: int, pairs: int, paired: Optional[bool] = None) -> int:
    """Bytes of shared memory a block of the kernel takes (the launch
    passes them, and the kernel's entry checks them against its layout):
    its lane table (by pairs of columns when ``paired``, default
    :func:`wavefront_form`'s) and, per stream, its query rows, ring of
    target values and result slots."""
    if paired is None:
        paired = wavefront_form(letters)
    cols = letters + 2
    table = (letters + 1) * (cols * cols * 64 if paired else cols * 32)
    lanes = LANE // ROWS
    return 4 * (table + STREAM_WARPS * 32 // lanes * (pairs * LANE + RING_WORDS + pairs + lanes))


@functools.lru_cache(maxsize=256)
def wavefront_stream(B: int, n: int, m: int, n_sm: int, letters: int = 4,
                     paired: Optional[bool] = None, gap: int = 0) -> int:
    """P, the pairs a stream, for a launch of B pairs of n x m (an
    alphabet of ``letters``, the table in the form ``paired``, default
    :func:`wavefront_form`'s) on a card of n_sm SMs: the P of least
    estimated time, the block waves (STREAM_BLOCKS_PER_SM blocks an SM, or
    what shared memory holds) times a stream's iterations (P pairs of T /
    8 and its head and tail), the smaller P on a tie; P = 1 while the
    batch gives each SM at most a block, and under a negative ``gap``
    (a separator cell would outscore its pair)."""
    del n  # the kernel runs 128 positions whatever n
    if gap < 0:
        return 1
    tg = wavefront_period(m) // ROWS
    lanes = LANE // ROWS
    streams_a_block = STREAM_WARPS * 32 // lanes
    best = None
    for pairs in range(1, MAX_PAIRS + 1):
        fit = SMEM_PER_SM // (stream_smem(letters, pairs, paired) + 1024)
        if fit < 1:
            break
        blocks = -(-(-(-B // pairs)) // streams_a_block)
        waves = -(-blocks // (n_sm * min(fit, STREAM_BLOCKS_PER_SM)))
        cost = waves * (pairs * tg + lanes - 1)
        if best is None or cost < best[0]:
            best = (cost, pairs)
    return best[1]


def wavefront_table(params: ScoringParams, device: torch.device) -> torch.Tensor:
    """``_stream_table`` on ``device``, built once per scoring and device."""
    key = (params.matrix.tobytes(), params.matrix.shape, int(params.gap), str(device))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= 64:
            _tables.clear()
        table = torch.as_tensor(_stream_table(params), device=device)
        _tables[key] = table
    return table


def _guard(params: ScoringParams) -> None:
    if not params.is_linear:
        raise NotImplementedError(
            "affine wavefront would need two more serial-loop shifts "
            "(E/F lane shifts); use xla_diag / rowscan tiers for Gotoh"
        )


def sw_wavefront_plain(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Plain PyTorch version of the wavefront kernel (n <= 128): [B]
    int32 scores, step for step the TPU kernel's sweep."""
    _guard(params)
    dev = resolve_device(device, like=qs)
    qs, ts = as_codes(qs, dev), as_codes(ts, dev)
    B, n = qs.shape
    m = ts.shape[1]
    if n > LANE:
        raise ValueError(f"the wavefront sweep takes n <= {LANE} (got {n})")
    A = params.alphabet_size
    gap = int(params.gap)
    n_steps = wavefront_steps(n, m)
    table = torch.as_tensor(_profile_table(params), device=dev)
    # prof[b, j, c] = S[q_b[j], c] over the A + 1 codes; phantom lanes NEG
    prof = table[qs.long().clamp(max=A)]
    if n < LANE:
        prof = torch.cat([prof, prof.new_full((B, LANE - n, A + 1), NEG)], dim=1)
    tin = torch.full((B, n_steps + 1), A + 1, dtype=torch.uint8, device=dev)
    tin[:, :m] = ts
    j_idx = torch.arange(LANE, device=dev)
    zero = torch.zeros((B, LANE), dtype=torch.int32, device=dev)
    h1, h1r, h2r, best = zero, zero, zero, zero
    for d in range(n_steps):
        # lane j at step d scores cell (j + 1, d - j + 1): target char t[d - j]
        raw = d - j_idx
        t_at = torch.where((raw < 0) | (raw > n_steps),
                           torch.full_like(raw, n_steps), raw)
        tchar = tin[:, t_at].long().clamp(max=A)
        s = prof.gather(2, tchar[:, :, None])[:, :, 0]  # column A is NEG
        h = torch.maximum(torch.maximum(h2r + s, h1 - gap),
                          torch.clamp(h1r - gap, min=0))
        best = torch.maximum(best, h)
        hr = torch.cat([zero[:, :1], h[:, :-1]], dim=1)  # lane 0 takes 0
        h1, h1r, h2r = h, hr, h1r
    return best.amax(dim=1)


def wavefront_stream_mirror(qs, ts, params: ScoringParams, pairs: int,
                            device=None) -> torch.Tensor:
    """The CUDA kernel's schedule replayed in PyTorch (n <= 128): [B]
    int32 scores. Streams of ``pairs`` pairs (the last one ragged; P as
    :func:`wavefront_stream` gives it) run through 128 positions, lane l
    holding ROWS of them; at step d position p computes
    stream column d - p, a pair's m columns followed by its separator
    block; cells are D = H - gap on the gap-folded table; at the last
    step of an iteration a lane whose first position stands on a
    separator block's last column sets its positions' D to -gap, takes
    the next pair's query rows and folds its best into the maximum
    carried down the lanes, which the last lane writes. (The kernel
    shuffles a forcing lane's last D to the next lane before it resets it,
    the mirror after: the value reaches only separator cells.) Under a
    negative gap a stream holds one pair (``pairs`` must be 1), every
    column outside the target scores as the pad, no lane forces, the loop
    runs :func:`wavefront_steps` steps and the stream's lanes reduce their
    maxima."""
    _guard(params)
    if params.gap < 0 and pairs != 1:
        raise ValueError(f"a negative gap runs one pair a stream (got {pairs})")
    dev = resolve_device(device, like=qs)
    qs, ts = as_codes(qs, dev), as_codes(ts, dev)
    B, n = qs.shape
    m = ts.shape[1]
    if n > LANE:
        raise ValueError(f"the wavefront kernel takes n <= {LANE} (got {n})")
    if not 1 <= pairs <= MAX_PAIRS:
        raise ValueError(f"the kernel takes 1 to {MAX_PAIRS} pairs a stream (got {pairs})")
    rows = ROWS
    A = params.alphabet_size
    g = int(params.gap)
    nl = LANE // rows
    T = wavefront_period(m)
    tg = T // rows
    S = -(-B // pairs)
    out = torch.zeros((B,), dtype=torch.int32, device=dev)
    if S == 0:
        return out
    table = torch.as_tensor(_stream_table(params), device=dev)
    pair = torch.arange(S * pairs, device=dev).view(S, pairs)
    valid = (pair < B)[..., None]
    src = pair.clamp(max=B - 1)
    # the streams' target columns (0 the separator) and query rows (A the pad)
    tcol = torch.zeros((S, pairs, T), dtype=torch.long, device=dev)
    tcol[:, :, :m] = torch.where(valid, (ts.long()[src] + 1).clamp(max=A + 1), 0)
    tcol = tcol.view(S, pairs * T)
    qrow = torch.full((S, pairs, LANE), A, dtype=torch.long, device=dev)
    qrow[:, :, :n] = torch.where(valid, qs.long()[src].clamp(max=A), A)
    pos = torch.arange(LANE, device=dev)
    edge = torch.full((S, 1), -g, dtype=torch.int32, device=dev)  # row 0's D
    d1 = torch.full((S, LANE), -g, dtype=torch.int32, device=dev)  # D at step d - 1
    d2 = d1.clone()                                                 # D at step d - 2
    zero = torch.zeros((S, nl), dtype=torch.int32, device=dev)
    best, acc = zero, zero
    negative = g < 0
    cnt = (torch.arange(nl, device=dev) + tg).expand(S, nl)
    kf = torch.zeros((S, nl), dtype=torch.long, device=dev)
    qcur = qrow[:, 0]
    iters = wavefront_steps(n, m) // rows if negative else pairs * tg + nl - 1
    for it in range(iters):
        for u in range(rows):
            col = it * rows + u - pos
            inside = (col >= 0) & (col < pairs * T)
            tc = torch.where(inside, tcol[:, col.clamp(0, pairs * T - 1)], 0)
            s = table[qcur, tc]
            h = torch.maximum(torch.maximum(torch.cat([edge, d2[:, :-1]], 1) + s, d1),
                              torch.cat([edge, d1[:, :-1]], 1)).clamp(min=0)
            best = torch.maximum(best, h.view(S, nl, rows).amax(2))
            d1, d2 = h - g, d1
        if negative:
            continue
        acc_in = torch.cat([zero[:, :1], acc[:, :-1]], 1)
        cnt = cnt - 1
        force = cnt == 0
        cnt = torch.where(force, tg, cnt)
        acc = torch.where(force, torch.maximum(acc_in, best), acc)
        best = torch.where(force, 0, best)
        d1 = torch.where(force.repeat_interleave(rows, 1), -g, d1)
        done = force[:, -1] & (pair[:, 0] + kf[:, -1] < B)
        out[(pair[:, 0] + kf[:, -1])[done]] = acc[done, -1]
        kf = kf + force
        take = (force & (kf < pairs)).repeat_interleave(rows, 1)
        nxt = qrow.gather(1, kf.clamp(max=pairs - 1).repeat_interleave(rows, 1)[:, None])[:, 0]
        qcur = torch.where(take, nxt, qcur)
    if negative:  # one pair a stream: its lanes' maxima
        out = best.amax(1)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _wavefront_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_wavefront
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, i, i, i, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return lib, fn


def wavefront_launch_t(qs, ts, table, params: ScoringParams,
                       pairs: Optional[int] = None,
                       paired: Optional[bool] = None) -> torch.Tensor:
    """The launch alone: qs [B, n <= 128] and ts [B, m] contiguous uint8
    codes and the table of :func:`wavefront_table` on one CUDA device;
    ``pairs`` a stream, default :func:`wavefront_stream`'s (1 under a
    negative gap, the only count it takes); the lane
    table by pairs of columns when ``paired``, default
    :func:`wavefront_form`'s."""
    B, n = qs.shape
    m = ts.shape[1]
    A = params.alphabet_size
    if n > LANE or A > MAX_LETTERS:
        raise NotImplementedError(
            f"the wavefront kernel takes n <= {LANE} and <= {MAX_LETTERS} letters "
            f"(got n = {n}, {A} letters); longer queries go to the strip tile")
    reason = wavefront_refusal(params)
    if reason:
        raise NotImplementedError(reason)
    if paired is None:
        paired = wavefront_form(A)
    if params.gap < 0 and pairs not in (None, 1):
        raise ValueError(f"a negative gap runs one pair a stream (got {pairs})")
    elif paired and A > PAIR_MAX_LETTERS:
        raise ValueError(f"the table by pairs of columns takes <= {PAIR_MAX_LETTERS} "
                         f"letters (got {A})")
    dev = qs.device
    if (qs.dtype != torch.uint8 or ts.dtype != torch.uint8 or not qs.is_contiguous()
            or not ts.is_contiguous() or ts.device != dev):
        raise ValueError("the wavefront kernel takes contiguous uint8 codes on one device")
    if ts.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {ts.shape[0]} targets")
    if pairs is None:
        pairs = wavefront_stream(B, n, m, _sm_count(dev.index), A, paired, int(params.gap))
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    lib, fn = _wavefront_fn()
    args = (ptr(qs), ptr(ts), ptr(table), A, ptr(out), B, n, m, pairs, int(paired),
            int(params.gap), stream_smem(A, pairs, paired),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the launch goes to the runtime's current device
        with torch.cuda.device(dev):
            err = fn(*args)
    _build.check(lib, err, "sw_wavefront")
    return out


def sw_wavefront(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Anti-diagonal schedule scores; qs: [B, n], ts: [B, m] codes (pads
    A / A + 1). Any substitution matrix, linear gap. Returns [B] int32 on
    ``device`` (default: the card), equal to the batch kernels / oracle
    under a gap >= 0 and to the TPU schedule's score (JAX's Pallas
    kernel's) under a negative gap. n > 128 runs each pair through the
    strip tile. A scoring :func:`wavefront_refusal` names raises before
    anything runs."""
    _guard(params)
    dev = resolve_device(device, like=qs)
    qs, ts = as_codes(qs, dev), as_codes(ts, dev)
    B, n = qs.shape
    if n > LANE:
        from swtpu_torch.kernels.longpair_strip import strip_tile

        m = ts.shape[1]
        zc = torch.zeros((m,), dtype=torch.int32, device=dev)
        zr = torch.zeros((n,), dtype=torch.int32, device=dev)
        outs = [strip_tile(qs[b], ts[b], zc, zr, 0, params, device=dev)[2]
                for b in range(B)]
        return (torch.stack(outs) if outs else
                torch.zeros((0,), device=dev)).to(torch.int32)
    if dev.type == "cpu":
        return sw_wavefront_plain(qs, ts, params, dev)
    if B == 0:  # nothing to launch
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    out = wavefront_launch_t(qs.contiguous(), ts.contiguous(),
                             wavefront_table(params, dev), params)
    sw_wavefront.launches += 1
    sw_wavefront.launches_negative += params.gap < 0
    return out


sw_wavefront.launches = 0
sw_wavefront.launches_negative = 0
