"""Local-alignment (Smith-Waterman) scalar oracles, linear gap.

Copy of ``swtpu/oracle/sw.py`` (numpy only). ``sw_traceback`` is the
port's host walker: ``batch.traceback.sw_align_batch`` runs it on the
prefix bounded by the device endpoint.

Semantics mirror the reference oracles:
- :func:`sw_score`       ≙ ``SmithWaterman``       (source.cpp:35-60)
- :func:`sw_score_batch` — batched/vectorized same recurrence
- :func:`sw_traceback`   ≙ ``SmithWaterman_111_long`` generalized
                           (source.cpp:1526-1576), incl. its tie-break
                           order diag → up → left and argmax-first-in-
                           row-major-scan rule.

Recurrence (source.cpp:46-55): H[i,j] = max(0, H[i-1,j-1] + S[q[i-1],t[j-1]],
H[i-1,j] - gap, H[i,j-1] - gap); score = max over all cells (floor 0).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from swtpu_torch.core.scoring import ScoringParams


def _check_linear(params: ScoringParams):
    if not params.is_linear:
        raise NotImplementedError("oracle currently implements linear gap only")


def sw_score(q: np.ndarray, t: np.ndarray, params: ScoringParams) -> int:
    """Exact scalar local-alignment score. Arbitrary lengths.

    Double-loop mirror of the reference recurrence; gold standard.
    """
    _check_linear(params)
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    S = params.matrix.astype(np.int64)
    g = int(params.gap)
    n, m = len(q), len(t)
    dp = np.zeros((n + 1, m + 1), dtype=np.int64)
    best = 0
    for i in range(1, n + 1):
        row_s = S[q[i - 1], t]  # substitution scores vs every t char
        prev = dp[i - 1]
        cur = dp[i]
        h_left = 0
        for j in range(1, m + 1):
            v = max(0, prev[j - 1] + row_s[j - 1], prev[j] - g, h_left - g)
            cur[j] = v
            h_left = v
            if v > best:
                best = v
    return int(best)


def sw_score_batch(
    qs: np.ndarray, ts: np.ndarray, params: ScoringParams
) -> np.ndarray:
    """Vectorized batch of local-alignment scores.

    qs: [B, n] uint8, ts: [B, m] uint8 → [B] int64 scores.
    Anti-diagonal vectorization (no intra-diagonal dependency), batched.
    """
    _check_linear(params)
    qs = np.asarray(qs, dtype=np.int64)
    ts = np.asarray(ts, dtype=np.int64)
    if qs.ndim == 1:
        qs = qs[None]
    if ts.ndim == 1:
        ts = ts[None]
    B, n = qs.shape
    _, m = ts.shape
    S = params.matrix.astype(np.int64)
    g = int(params.gap)
    # subst[b, i, j] = S[qs[b,i], ts[b,j]]
    subst = S[qs[:, :, None], ts[:, None, :]]
    # H over diagonals: diag d holds cells (i, j) with i + j == d, i in [1,n], j in [1,m]
    # We store full rows of length n+1 indexed by i; cell (i, d - i).
    prev2 = np.zeros((B, n + 1), dtype=np.int64)  # diag d-2
    prev1 = np.zeros((B, n + 1), dtype=np.int64)  # diag d-1
    best = np.zeros(B, dtype=np.int64)
    for d in range(2, n + m + 1):
        lo = max(1, d - m)
        hi = min(n, d - 1)
        if lo > hi:
            # only boundary cells on this diagonal (all zero) — nothing to do
            cur = np.zeros((B, n + 1), dtype=np.int64)
            prev2, prev1 = prev1, cur
            continue
        i_idx = np.arange(lo, hi + 1)
        j_idx = d - i_idx
        sc = subst[:, i_idx - 1, j_idx - 1]  # [B, k]
        diag = prev2[:, i_idx - 1] + sc
        up = prev1[:, i_idx - 1] - g
        left = prev1[:, i_idx] - g
        v = np.maximum(np.maximum(diag, up), np.maximum(left, 0))
        cur = np.zeros((B, n + 1), dtype=np.int64)
        cur[:, i_idx] = v
        best = np.maximum(best, v.max(axis=1))
        prev2, prev1 = prev1, cur
    return best


def sw_traceback(
    q: np.ndarray, t: np.ndarray, params: ScoringParams
) -> Tuple[int, List[Tuple[int, int]]]:
    """Score + traceback path, generalizing ``SmithWaterman_111_long``
    (source.cpp:1526-1576) to arbitrary scoring/lengths.

    Contract details preserved:
    - argmax = first maximum in row-major scan order (strict '<' update,
      source.cpp:1545-1549);
    - traceback tie-break diag → up → left (source.cpp:1558-1567);
    - path starts at the first cell with H == 0 on the walk (pushed before
      the zero test breaks the loop) and ends at the argmax cell; coordinates
      are 1-based DP indices, matching the reference's (i, j) pairs.
    """
    _check_linear(params)
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    S = params.matrix.astype(np.int64)
    g = int(params.gap)
    n, m = len(q), len(t)
    dp = np.zeros((n + 1, m + 1), dtype=np.int64)
    for i in range(1, n + 1):
        row_s = S[q[i - 1], t]
        prev = dp[i - 1]
        cur = dp[i]
        h_left = 0
        for j in range(1, m + 1):
            v = max(0, prev[j - 1] + row_s[j - 1], prev[j] - g, h_left - g)
            cur[j] = v
            h_left = v
    flat = int(np.argmax(dp))  # first occurrence in row-major order
    max_i, max_j = divmod(flat, m + 1)
    max_score = int(dp[max_i, max_j])

    path = [(max_i, max_j)]
    i, j = max_i, max_j
    while i or j:
        if dp[i, j] == 0:
            break
        if i and j and dp[i, j] == dp[i - 1, j - 1] + S[q[i - 1], t[j - 1]]:
            i, j = i - 1, j - 1
        elif i and dp[i, j] == dp[i - 1, j] - g:
            i = i - 1
        elif j and dp[i, j] == dp[i, j - 1] - g:
            j = j - 1
        else:  # pragma: no cover
            raise AssertionError("inconsistent traceback")
        path.append((i, j))
    path.reverse()
    return max_score, path
