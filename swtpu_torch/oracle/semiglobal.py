"""Semi-global alignment oracles: full matrix and adaptive-banded X-drop.

Copy of ``swtpu/oracle/semiglobal.py`` (numpy only): ``semiglobal_full``,
``semiglobal_affine_full``, ``nw_full`` and ``nw_affine_full`` are the
port's host walkers for ``batch.traceback.semiglobal_align_batch`` /
``nw_align_batch``; ``banded_xdrop`` is the contract of the per-round
adaptive-band forward (``kernels/banded_scan.py``, ``kernels/banded_batch.py``).

"Semi-global" per the reference (source.cpp:1782-1786): no zero floor
(global), the alignment starts at the top-left corner (global), but ends at
the matrix-wide maximum (local) — traceback from the argmax.

- :func:`semiglobal_full`  ≙ ``SemiGlobal_111``  (source.cpp:1776-1834),
  generalized to arbitrary lengths / match-mismatch-gap scoring.
- :func:`banded_xdrop`     ≙ ``SemiGlobal_AdaptiveBanded_XDrop_111_32_70``
  (source.cpp:1836-1976), generalized to arbitrary lengths, bandwidth and
  X-threshold. This scalar banded oracle *is* the contract for the banded
  device kernels (the reference compares its SIMD marks against this, not
  the full matrix — source.cpp:2773-2784).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class BandedResult:
    """Full forward-pass state of the banded DP, for kernel parity tests.

    band_history[r] is the 32-wide (bandwidth-wide) band after round r;
    pos_y/pos_x[r] give the *top-right* band cell's DP coordinates (y, and
    x including the left pad of `bandwidth` columns), exactly the reference's
    ``dp`` / ``dp_pos_y`` / ``dp_pos_x`` arrays (source.cpp:1873-1875).
    """

    score: int
    path: List[Tuple[int, int]]
    band_history: np.ndarray  # [rounds, bandwidth] int64
    pos_y: np.ndarray  # [rounds] int64
    pos_x: np.ndarray  # [rounds] int64 (padded x)
    n_rounds: int
    max_round: int


def banded_xdrop(
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    bandwidth: int = 32,
    x_threshold: int = 70,
    return_state: bool = False,
    matrix: Optional[np.ndarray] = None,
):
    """Adaptive-banded X-drop semi-global alignment, scalar oracle.

    Behavioral mirror of source.cpp:1836-1976 with (bandwidth, x_threshold)
    generalized from (32, 70):

    - the band is `bandwidth` consecutive cells of one anti-diagonal; each
      round advances exactly one anti-diagonal (y + x == round);
    - direction: move right iff band[0] (bottom-left) < band[-1] (top-right),
      ties move down (source.cpp:1891);
    - cell value 0 means dead/X-dropped; predecessors equal to 0 do not
      propagate (source.cpp:1922-1924);
    - scores are offset by +x_threshold (dp origin = x_threshold,
      source.cpp:1877); cells below max_score - x_threshold are zeroed; the
      run ends when a whole round is dead (source.cpp:1938-1941);
    - out-of-sequence chars (padding) always score -mismatch
      (source.cpp:1919-1920);
    - returned score is max_score - x_threshold; traceback starts from the
      top-right-most cell of the best round holding max_score
      (source.cpp:1953-1954), tie-break diag → up → left, coordinates 1-based
      unpadded (y, x).

    ``matrix`` (signed scores [q_char, t_char]) selects the general-matrix
    / protein mode: match/mismatch are ignored and pad involvement scores
    ``matrix.min()`` — the generalization of the uniform rule (pads score
    -mismatch = the uniform matrix's minimum), so a uniform matrix is
    bit-identical to the uniform mode.

    Returns (score, path), or a :class:`BandedResult` if return_state.
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    n, m = len(q), len(t)
    W = int(bandwidth)
    X = int(x_threshold)
    mat = None if matrix is None else np.asarray(matrix)
    pad_sc = None if mat is None else int(mat.min())

    # padded sequences: q gets 1 front + (W-1) back pad; t gets W front +
    # (W-1) back pad. Pad char = -1 (≙ 0xF0: "not a base"). One extra pad
    # byte each so the final boundary round stays in range.
    qp = np.full(1 + n + W, -1, dtype=np.int64)
    qp[1 : 1 + n] = q
    tp = np.full(W + m + W, -1, dtype=np.int64)
    tp[W : W + m] = t

    max_round_cap = (max(n, m) + 1) * 2 - 1
    band_hist = np.zeros((max_round_cap, W), dtype=np.int64)
    pos_y = np.zeros(max_round_cap, dtype=np.int64)
    pos_x = np.zeros(max_round_cap, dtype=np.int64)

    band_hist[0, W - 1] = X
    pos_y[0] = 0
    pos_x[0] = W - 1

    horizontal = np.zeros(W, dtype=np.int64)
    vertical = np.zeros(W, dtype=np.int64)
    result = np.zeros(W, dtype=np.int64)
    result[W - 1] = X

    now_y, now_x = 0, W - 1
    max_round, max_score = 0, X
    n_rounds = 1
    # offsets within the band: cell k (k=0 bottom-left .. W-1 top-right) sits
    # at y = now_y + (W-1-k), x_padded = now_x - (W-1-k)
    off = (W - 1) - np.arange(W)

    round_no = 1
    while round_no < max_round_cap:
        if result[0] < result[W - 1]:
            # move right
            diagonal = vertical.copy()
            horizontal = result.copy()
            vertical = np.concatenate([result[1:], [0]])
            now_x += 1
            if now_x > W + m + (W - 1):
                break
        else:
            # move down
            diagonal = horizontal.copy()
            vertical = result.copy()
            horizontal = np.concatenate([[0], result[:-1]])
            now_y += 1
            if now_y > n + 1:
                break
        pos_y[round_no] = now_y
        pos_x[round_no] = now_x

        yc = qp[now_y + off]
        xc = tp[now_x - off]
        valid = (yc >= 0) & (xc >= 0)
        if mat is not None:
            score = np.where(
                valid, mat[np.maximum(yc, 0), np.maximum(xc, 0)], pad_sc
            )
        else:
            score = np.where(valid & (yc == xc), match, -mismatch)

        result = np.zeros(W, dtype=np.int64)
        result = np.where(diagonal != 0, np.maximum(result, diagonal + score), result)
        result = np.where(horizontal != 0, np.maximum(result, horizontal - gap), result)
        result = np.where(vertical != 0, np.maximum(result, vertical - gap), result)
        round_max = int(result.max(initial=0))

        if max_score < round_max:
            max_round = round_no
            max_score = round_max

        result = np.where(result < max_score - X, 0, result)
        band_hist[round_no] = result
        n_rounds = round_no + 1

        if round_max == 0:
            break
        round_no += 1
    else:
        pass

    # --- traceback (source.cpp:1944-1973) ---
    def get(y: int, x: int) -> int:
        if y < 0 or y > n or x < 0 or x > m:
            return MINUS_INF
        r = y + x
        if r >= n_rounds:
            return MINUS_INF
        k = (W - 1) - (y - pos_y[r])
        if k < 0 or k >= W:
            return MINUS_INF
        v = band_hist[r, k]
        return MINUS_INF if v == 0 else int(v)

    my, mx = int(pos_y[max_round]), int(pos_x[max_round] - (W - 1))
    while get(my, mx) != max_score:
        my += 1
        mx -= 1

    def sub(i: int, j: int) -> int:
        if mat is not None:
            return int(mat[q[i - 1], t[j - 1]])
        return match if q[i - 1] == t[j - 1] else -mismatch

    path = [(my, mx)]
    i, j = my, mx
    while i or j:
        v = get(i, j)
        if i and j and v == get(i - 1, j - 1) + sub(i, j):
            i, j = i - 1, j - 1
        elif i and v == get(i - 1, j) - gap:
            i = i - 1
        elif j and v == get(i, j - 1) - gap:
            j = j - 1
        else:  # pragma: no cover
            raise AssertionError("inconsistent banded traceback")
        path.append((i, j))
    path.reverse()

    if return_state:
        return BandedResult(
            score=max_score - X,
            path=path,
            band_history=band_hist[:n_rounds],
            pos_y=pos_y[:n_rounds],
            pos_x=pos_x[:n_rounds],
            n_rounds=n_rounds,
            max_round=max_round,
        )
    return max_score - X, path
