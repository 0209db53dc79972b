"""Semi-global and global (Needleman-Wunsch) full-matrix oracles.

Copy of ``swtpu/oracle/semiglobal.py``'s full-matrix half (numpy only):
``semiglobal_full``, ``semiglobal_affine_full``, ``nw_full`` and
``nw_affine_full`` are the port's host walkers for
``batch.traceback.semiglobal_align_batch`` / ``nw_align_batch``.

"Semi-global" per the reference (source.cpp:1782-1786): no zero floor
(global), the alignment starts at the top-left corner (global), but ends at
the matrix-wide maximum (local) — traceback from the argmax.

- :func:`semiglobal_full`  ≙ ``SemiGlobal_111``  (source.cpp:1776-1834),
  generalized to arbitrary lengths / match-mismatch-gap scoring.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

MINUS_INF = -(2**30)  # ≙ std::numeric_limits<int>::min() / 2 in spirit


def semiglobal_full(
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    matrix: Optional[np.ndarray] = None,
    endpoint: Optional[Tuple[int, int]] = None,
) -> Tuple[int, List[Tuple[int, int]]]:
    """Full-matrix semi-global alignment with traceback.

    mismatch/gap are penalties (positive). Returns (score, path) where path is
    the list of 1-based (i, j) DP coordinates from the alignment origin (0, 0)
    to the argmax cell — matching ``SemiGlobal_111``'s output shape
    (source.cpp:1812-1833), including tie-breaks:
    argmax = first max in row-major scan with strict '<' against initial 0;
    traceback order diag → up → left.

    If ``matrix`` is given it holds signed substitution *scores* indexed
    [q_char, t_char] and match/mismatch are ignored (the general-matrix /
    protein mode; the reference's semi-global family is (1,1,1)-only,
    source.cpp:1776-1834 — this is the engine-matrix generalization).

    ``endpoint`` pins the alignment end instead of the argmax: (n, m)
    gives GLOBAL (Needleman-Wunsch) alignment — the reference's
    semi-global is already origin-anchored (source.cpp:1789-1792), so
    global differs only in where the score is read and the walk starts.
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    n, m = len(q), len(t)
    dp = np.full((n + 1, m + 1), MINUS_INF, dtype=np.int64)
    dp[0, 0] = 0
    # boundary gap chains (reference computes these through the same maxes)
    dp[0, 1:] = -gap * np.arange(1, m + 1)
    dp[1:, 0] = -gap * np.arange(1, n + 1)
    if matrix is not None:
        sub = np.asarray(matrix, dtype=np.int64)[q[:, None], t[None, :]]
    else:
        sub = np.where(q[:, None] == t[None, :], match, -mismatch)
    # anti-diagonal fill: no intra-diagonal dependency
    for d in range(2, n + m + 1):
        lo = max(1, d - m)
        hi = min(n, d - 1)
        if lo > hi:
            continue
        i_idx = np.arange(lo, hi + 1)
        j_idx = d - i_idx
        diag = dp[i_idx - 1, j_idx - 1] + sub[i_idx - 1, j_idx - 1]
        up = dp[i_idx - 1, j_idx] - gap
        left = dp[i_idx, j_idx - 1] - gap
        dp[i_idx, j_idx] = np.maximum(diag, np.maximum(up, left))
    if endpoint is not None:
        max_i, max_j = endpoint
    else:
        # argmax with the reference's "strict < vs initial 0" rule:
        # dp[0,0] == 0 is scanned first, so plain row-major argmax
        # reproduces it.
        flat = int(np.argmax(dp))
        max_i, max_j = divmod(flat, m + 1)
    max_score = int(dp[max_i, max_j])

    path = [(max_i, max_j)]
    i, j = max_i, max_j
    while i or j:
        v = dp[i, j]
        if i and j and v == dp[i - 1, j - 1] + sub[i - 1, j - 1]:
            i, j = i - 1, j - 1
        elif i and v == dp[i - 1, j] - gap:
            i = i - 1
        elif j and v == dp[i, j - 1] - gap:
            j = j - 1
        else:  # pragma: no cover
            raise AssertionError("inconsistent traceback")
        path.append((i, j))
    path.reverse()
    return max_score, path


def semiglobal_affine_full(
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap_open: int = 3,
    gap_extend: int = 1,
    matrix: Optional[np.ndarray] = None,
    endpoint: Optional[Tuple[int, int]] = None,
) -> Tuple[int, List[Tuple[int, int]]]:
    """Full-matrix semi-global alignment with AFFINE (Gotoh) gaps.

    Same start/end contract as semiglobal_full (origin-anchored, ends at
    the matrix-wide argmax, first-in-row-major-scan tie-break); gap of
    length L costs gap_open + (L-1)*gap_extend. H-state traceback
    preference diag -> F (up) -> E (left), the family's order. With
    gap_open == gap_extend this is bit-equal to semiglobal_full (tested).
    ``matrix`` (signed scores [q_char, t_char]) overrides match/mismatch.
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    go, ge = int(gap_open), int(gap_extend)
    n, m = len(q), len(t)
    H = np.full((n + 1, m + 1), MINUS_INF, dtype=np.int64)
    E = np.full((n + 1, m + 1), MINUS_INF, dtype=np.int64)
    F = np.full((n + 1, m + 1), MINUS_INF, dtype=np.int64)
    H[0, 0] = 0
    # boundary gap chains are single open-extend runs
    H[0, 1:] = E[0, 1:] = -go - ge * np.arange(m)
    H[1:, 0] = F[1:, 0] = -go - ge * np.arange(n)
    if matrix is not None:
        sub = np.asarray(matrix, dtype=np.int64)[q[:, None], t[None, :]]
    else:
        sub = np.where(q[:, None] == t[None, :], match, -mismatch)
    for i in range(1, n + 1):
        srow = sub[i - 1]
        for j in range(1, m + 1):
            E[i, j] = max(E[i, j - 1] - ge, H[i, j - 1] - go)
            F[i, j] = max(F[i - 1, j] - ge, H[i - 1, j] - go)
            H[i, j] = max(H[i - 1, j - 1] + srow[j - 1], E[i, j], F[i, j])
    if endpoint is not None:
        max_i, max_j = endpoint
    else:
        flat = int(np.argmax(H))
        max_i, max_j = divmod(flat, m + 1)
    max_score = int(H[max_i, max_j])

    path = [(max_i, max_j)]
    i, j, st = max_i, max_j, 0
    while i or j:
        if st == 0:
            v = H[i, j]
            if i and j and v == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                i, j = i - 1, j - 1
                path.append((i, j))
            elif v == F[i, j]:
                st = 2
            elif v == E[i, j]:
                st = 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent semiglobal affine H")
        elif st == 1:
            v = E[i, j]
            if j and v == H[i, j - 1] - go:
                j -= 1
                st = 0
            elif j and v == E[i, j - 1] - ge:
                j -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent semiglobal affine E")
            path.append((i, j))
        else:
            v = F[i, j]
            if i and v == H[i - 1, j] - go:
                i -= 1
                st = 0
            elif i and v == F[i - 1, j] - ge:
                i -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent semiglobal affine F")
            path.append((i, j))
    path.reverse()
    return max_score, path


def nw_full(
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    matrix: Optional[np.ndarray] = None,
) -> Tuple[int, List[Tuple[int, int]]]:
    """GLOBAL (Needleman-Wunsch) alignment with traceback, linear gaps.

    Extension beyond the reference (which stops at semi-global): the
    reference's semi-global DP is already origin-anchored with penalized
    boundary gap chains (source.cpp:1789-1792), so global alignment is
    the identical forward pass with the score read at the (n, m) corner
    and the walk started there. Same tie-breaks (diag -> up -> left)."""
    return semiglobal_full(
        q, t, match, mismatch, gap, matrix=matrix,
        endpoint=(len(q), len(t)),
    )


def nw_affine_full(
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap_open: int = 3,
    gap_extend: int = 1,
    matrix: Optional[np.ndarray] = None,
) -> Tuple[int, List[Tuple[int, int]]]:
    """GLOBAL (Needleman-Wunsch/Gotoh) alignment, affine gaps — the
    (n, m)-pinned read-out of semiglobal_affine_full (see nw_full)."""
    return semiglobal_affine_full(
        q, t, match, mismatch, gap_open, gap_extend, matrix=matrix,
        endpoint=(len(q), len(t)),
    )
