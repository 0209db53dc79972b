"""Precision-tiered scoring with overflow promotion.

Port of ``swtpu/batch/promote.py``: run the batch through the bf16 tier
(``kernels/sw_bf16.py``), detect the pairs whose scores reached the
exact-representation bound, and re-run exactly those at int32 (the
row-scan kernel ``kernels/sw_batch.py`` on the card, its plain tier on
the CPU).

Soundness of the split (no saturation sentinel needed): in zero-floored
Smith-Waterman every DP cell is bounded by the final score, and bf16
represents integers below MAX_EXACT = 256 (rescaled units) exactly, so a
pair whose bf16 score lands below (MAX_EXACT - 1) * g never left the
exact range, while a pair whose true maximum crossed the bound reads at
least that threshold (rounding drift only accrues above the bound, and
the running maximum passes through 255 exactly on the way up). The
promoted re-run restores exact scores.
"""

from __future__ import annotations

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.sw_batch import _uniform_match_mismatch, sw_batch
from swtpu_torch.kernels.sw_bf16 import MAX_EXACT, _gcd, sw_bf16
from swtpu_torch.utils.device import as_codes, resolve_device

#: the TPU bf16 tier's batch tile; JAX's cap rule counts in its multiples
TILE_PAIRS_16 = 2048


def _check_promotion_scoring(params: ScoringParams):
    mm = _uniform_match_mismatch(params)
    if mm is None or mm[1] >= 0 or not params.is_linear or params.gap <= 0:
        raise NotImplementedError(
            "promotion tier needs uniform match/mismatch linear scoring"
        )
    match, mismatch = mm
    return match, mismatch, _gcd(match, mismatch, int(params.gap))


def sw_scores_promoted(qs, ts, params: ScoringParams, engine_int32=None,
                       device=None):
    """Batched SW scores: bf16 tier + int32 re-run of overflow pairs.

    Returns (scores [B] int64, promoted_mask [B] bool), numpy. Scores are
    exact against the oracle whatever the lengths and scoring magnitude;
    promoted_mask marks the pairs that needed the re-run.
    ``engine_int32(q, t)`` re-runs them; by default the row-scan kernel
    on the card, its plain tier on the CPU.
    """
    _, _, g = _check_promotion_scoring(params)
    dev = resolve_device(device, like=qs)
    qs = as_codes(qs, dev)
    ts = as_codes(ts, dev)
    low = sw_bf16(qs, ts, params, allow_overflow=True, device=dev)
    low = low.cpu().numpy().astype(np.int64)
    promoted = low >= (MAX_EXACT - 1) * g
    scores = low.copy()
    if promoted.any():
        if engine_int32 is None:
            engine_int32 = lambda q, t: sw_batch(q, t, params, dev)  # noqa: E731
        idx = np.nonzero(promoted)[0]
        sel = torch.from_numpy(idx).to(dev)
        hi = engine_int32(qs[sel], ts[sel])
        scores[idx] = np.asarray(torch.as_tensor(hi).cpu()).astype(np.int64)
    return scores, promoted


def promoted_split(qs, ts, params: ScoringParams, cap: int):
    """The device half of :func:`sw_scores_promoted_device`, with no host
    synchronisation: the bf16 pass, the overflow mask, the first ``cap``
    promoted pairs compacted into a fixed buffer (a cumulative sum over
    the mask, not ``nonzero``), their int32 re-run and the scatter back.

    qs, ts: codes on one device. Returns (scores int32 [B],
    promoted bool [B], n_promoted int64 0-d), all on that device. Pairs
    promoted past ``cap`` keep their bf16 score: the caller checks
    n_promoted <= cap before trusting the split.
    """
    _, _, g = _check_promotion_scoring(params)
    B = qs.shape[0]
    dev = qs.device
    low = sw_bf16(qs, ts, params, allow_overflow=True, device=dev)
    promoted = low >= (MAX_EXACT - 1) * g
    nprom = promoted.sum()
    rank = torch.cumsum(promoted, 0) - 1
    take = promoted & (rank < cap)
    # slot `cap` is the dump for every pair not taken; fill index B
    # marks an empty slot, whose re-run uses pair B - 1 and is dropped
    idx = torch.full((cap + 1,), B, dtype=torch.int64, device=dev)
    idx.scatter_(0, torch.where(take, rank, cap), torch.arange(B, device=dev))
    idx = idx[:cap]
    safe = idx.clamp(max=B - 1)
    hi = sw_batch(qs[safe], ts[safe], params, dev)
    scores = torch.cat([low, low.new_zeros(1)])
    scores[idx] = hi
    return scores[:B], promoted, nprom


def sw_scores_promoted_device(qs, ts, params: ScoringParams,
                              cap_frac: float = 0.25, device=None):
    """Device-fused promotion: like :func:`sw_scores_promoted`, but the
    bf16 pass, the overflow mask, the promoted-pair gather, the int32
    re-run and the score scatter all stay on the device
    (:func:`promoted_split`); the host fetches one scalar, then the
    results.

    The re-run capacity is ``cap_frac`` of the batch rounded up to the
    TPU tier's 2048-pair tile, as in JAX. If more pairs promote than that
    (the one scalar fetch says so), the remainder is re-run from the host
    with ``sw_batch``: correctness never depends on the cap.

    Returns (scores [B] int64, promoted_mask [B] bool), numpy, exact
    against the oracle. qs/ts: numpy or torch codes 0-3 with pads 4 (q)
    / 5 (t).
    """
    _check_promotion_scoring(params)
    dev = resolve_device(device, like=qs)
    qs = as_codes(qs, dev)
    ts = as_codes(ts, dev)
    B = qs.shape[0]
    Bp = -(-B // TILE_PAIRS_16) * TILE_PAIRS_16
    cap = min(max(1, int(Bp * cap_frac)), Bp, B)
    scores_d, promoted_d, nprom_d = promoted_split(qs, ts, params, cap)
    if int(nprom_d) > cap:  # rare: more overflow pairs than capacity
        scores = scores_d.cpu().numpy().astype(np.int64)
        promoted = promoted_d.cpu().numpy()
        idx = np.nonzero(promoted)[0][cap:]
        sel = torch.from_numpy(idx).to(dev)
        hi = sw_batch(qs[sel], ts[sel], params, dev)
        scores[idx] = hi.cpu().numpy().astype(np.int64)
        return scores, promoted
    return scores_d.cpu().numpy().astype(np.int64), promoted_d.cpu().numpy()
