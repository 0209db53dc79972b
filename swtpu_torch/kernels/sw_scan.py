"""Batched Smith-Waterman over anti-diagonals — the plain PyTorch tier.

Port of ``swtpu/kernels/xla/sw_scan.py``. It is the plain version of the
linear row-scan kernels (``sw_batch.sw_batch`` and ``sw_batch_ends``) and
of the linear profile kernels (``sw_profile``, whose CUDA kernel reads
this module's extended table): on the CPU it is the engine for every
scoring system, and on the card it is what ``chip_smoke.py`` holds the
kernels against.

The schedule is the XLA tier's: the batch is the leading axis and a loop
walks the n + m - 1 anti-diagonals, each a handful of elementwise ops on
[B, n + 1] int32 tensors (no dependency inside a diagonal). Slot i of a
diagonal vector holds DP row i; slot 0 is the boundary row.

Out-of-matrix ("phantom") cells are never masked. Queries are padded
with code 4 and targets with code 5, and the extended substitution table
scores any code >= the alphabet size at -2^20, so phantom and padded
cells can only lose. Variable-length batches come free: pad each
sequence to the block length and the result is the per-pair score of the
unpadded problem.
"""

from __future__ import annotations

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.utils.device import as_codes, resolve_device

#: Pad codes: queries pad with alphabet_size, targets with alphabet_size+1
#: (DNA: 4/5) — never equal, and both outside the real alphabet, so
#: padded positions can only lose.
Q_PAD = 4
T_PAD = 5
_NEG = -(2**20)


def pad_codes(params: ScoringParams):
    """(query_pad, target_pad) for this alphabet."""
    A = params.alphabet_size
    return A, A + 1


def _extended_table(params: ScoringParams) -> np.ndarray:
    """[stride, stride] int32 substitution table; stride is 8 for DNA-sized
    alphabets, 32 for protein; any index >= alphabet scores _NEG."""
    A = params.alphabet_size
    stride = 8 if A <= 6 else 32
    if A + 2 > stride:
        raise NotImplementedError(f"alphabet of {A} letters unsupported")
    ext = np.full((stride, stride), _NEG, dtype=np.int32)
    ext[:A, :A] = params.matrix
    return ext


def select_scores(prof, codes, n_codes):
    """s[...] = prof[..., codes[...]] via an n_codes-way select tree.

    ``codes`` must broadcast against prof[..., c]; codes >= n_codes fall
    through to -2^20, exact whenever every extended-table column past the
    alphabet is all -2^20."""
    shape = torch.broadcast_shapes(codes.shape, prof.shape[:-1])
    s = torch.full(shape, _NEG, dtype=torch.int32, device=prof.device)
    for c in range(n_codes):
        s = torch.where(codes == c, prof[..., c], s)
    return s


def _shift1(x: torch.Tensor, fill: int) -> torch.Tensor:
    """[fill, x[:, 0], ..., x[:, -2]] along axis 1."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def diag_setup(qs, ts, params: ScoringParams, device=None):
    """Shared set-up of the anti-diagonal engines.

    Returns (prof, ts_rev_pad, n, m, n_codes): prof[b, i] is the extended
    table row of query slot i (slot 0 = boundary, a pad), and for
    diagonal d the target chars aligned with slots 0..n are the window
    ``ts_rev_pad[:, m - d + n + 1 :][:, : n + 1]`` of the reversed,
    pad-framed target.
    """
    dev = resolve_device(device, like=qs)
    qs = as_codes(qs, dev)
    ts = as_codes(ts, dev)
    table = torch.as_tensor(_extended_table(params), device=dev)
    stride = table.shape[0]
    q_pad, t_pad = stride - 2, stride - 1  # safe out-of-alphabet codes
    qs = qs.to(torch.int64).clamp(max=q_pad)
    ts = ts.to(torch.int64).clamp(max=t_pad)
    B, n = qs.shape
    m = ts.shape[1]
    if ts.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {ts.shape[0]} targets")
    q_slot = torch.cat([qs.new_full((B, 1), q_pad), qs], dim=1)
    frame = torch.full((B, n + 1), t_pad, dtype=torch.int64, device=dev)
    ts_rev_pad = torch.cat([frame, ts.flip(1), frame], dim=1)  # [B, m+2n+2]
    prof = table[q_slot]  # [B, n+1, stride]
    return prof, ts_rev_pad, n, m, params.alphabet_size + 2


def sw_batch_diag(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Batched local-alignment scores, linear gap.

    qs: [B, n] uint8 (pad with 4), ts: [B, m] uint8 (pad with 5), numpy
    or torch. Returns [B] int32 scores on ``device``, bit-equal to
    ``swtpu_torch.oracle.sw_score`` on each (unpadded) pair.
    """
    prof, ts_rev_pad, n, m, n_codes = diag_setup(qs, ts, params, device)
    gap = int(params.gap)
    B = prof.shape[0]
    prev1 = torch.zeros((B, n + 1), dtype=torch.int32, device=prof.device)
    prev2 = prev1
    best = torch.zeros((B,), dtype=torch.int32, device=prof.device)
    for d in range(2, n + m + 1):
        off = m - d + n + 1
        s = select_scores(prof, ts_rev_pad[:, off : off + n + 1], n_codes)
        cur = torch.maximum(
            torch.maximum(_shift1(prev2, 0) + s, _shift1(prev1, 0) - gap),
            torch.clamp(prev1 - gap, min=0),
        )
        best = torch.maximum(best, cur.amax(dim=1))
        prev2, prev1 = prev1, cur
    return best


def track_endpoint(cur, d, rows, best, bi, bj):
    """Fold diagonal d into the running (best, bi, bj).

    The oracle's tie-break (first max in row-major scan order,
    oracle/sw.py's argmax): within a diagonal ties pick the smallest row;
    across diagonals replace only on a strictly greater value OR an equal
    value at a strictly smaller row (an equal value at an equal row on a
    later diagonal is a larger column — keep the earlier one).
    """
    vmax = cur.amax(dim=1)
    big = torch.full_like(cur, 1 << 30)
    i_at = torch.where(cur == vmax[:, None], rows, big).amin(dim=1)
    upd = (vmax > best) | ((vmax == best) & (i_at < bi))
    return (
        torch.where(upd, vmax, best),
        torch.where(upd, i_at, bi),
        torch.where(upd, d - i_at, bj),
    )


def sw_batch_diag_ends(qs, ts, params: ScoringParams, device=None):
    """Batched local scores + argmax endpoints, linear gap.

    Returns (score, end_i, end_j) int32 [B] tensors: the score and the
    1-based DP coordinates of the first maximum in row-major scan order —
    exactly ``oracle.sw.sw_traceback``'s argmax cell. Score 0 maps to
    (0, 0).
    """
    prof, ts_rev_pad, n, m, n_codes = diag_setup(qs, ts, params, device)
    gap = int(params.gap)
    B, dev = prof.shape[0], prof.device
    rows = torch.arange(n + 1, dtype=torch.int32, device=dev)[None, :]
    prev1 = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    prev2 = prev1
    best = torch.zeros((B,), dtype=torch.int32, device=dev)
    bi, bj = best, best
    for d in range(2, n + m + 1):
        off = m - d + n + 1
        s = select_scores(prof, ts_rev_pad[:, off : off + n + 1], n_codes)
        cur = torch.maximum(
            torch.maximum(_shift1(prev2, 0) + s, _shift1(prev1, 0) - gap),
            torch.clamp(prev1 - gap, min=0),
        )
        best, bi, bj = track_endpoint(cur, d, rows, best, bi, bj)
        prev2, prev1 = prev1, cur
    # score 0 => the oracle argmax is the (0, 0) boundary cell
    pos = best > 0
    zero = torch.zeros_like(best)
    return best, torch.where(pos, bi, zero), torch.where(pos, bj, zero)
