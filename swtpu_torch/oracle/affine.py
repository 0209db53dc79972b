"""Affine-gap (Gotoh) local alignment oracle.

Copy of ``swtpu/oracle/affine.py`` (numpy only); ``sw_affine_traceback``
is the port's three-state host walker.

The reference is linear-gap only (source.cpp:69: a single gap_penalty);
affine gaps are the mandated extension (BASELINE.json: "banded affine-gap
Smith-Waterman"), with the reference defining the linear-gap parity core.
Convention: opening a gap of length L costs gap_open + (L-1)*gap_extend
(the first gapped char pays gap_open). With gap_open == gap_extend this
reduces exactly to the reference's linear model — asserted in tests.

Recurrences (Gotoh 1982):
  E[i,j] = max(E[i,j-1] - ext, H[i,j-1] - open)   # gap in query (left)
  F[i,j] = max(F[i-1,j] - ext, H[i-1,j] - open)   # gap in target (up)
  H[i,j] = max(0, H[i-1,j-1] + S[q,t], E[i,j], F[i,j])
"""

from __future__ import annotations

import numpy as np

from swtpu_torch.core.scoring import ScoringParams

NEG = -(2**29)


def sw_affine_score(q: np.ndarray, t: np.ndarray, params: ScoringParams) -> int:
    """Exact scalar affine-gap local-alignment score."""
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    S = params.matrix.astype(np.int64)
    go, ge = int(params.gap_open), int(params.gap_extend)
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    best = 0
    for i in range(1, n + 1):
        row_s = S[q[i - 1], t]
        for j in range(1, m + 1):
            E[i, j] = max(E[i, j - 1] - ge, H[i, j - 1] - go)
            F[i, j] = max(F[i - 1, j] - ge, H[i - 1, j] - go)
            H[i, j] = max(
                0, H[i - 1, j - 1] + row_s[j - 1], E[i, j], F[i, j]
            )
            if H[i, j] > best:
                best = H[i, j]
    return int(best)


def sw_affine_traceback(q: np.ndarray, t: np.ndarray, params: ScoringParams):
    """Affine-gap local alignment with traceback: (score, [(i, j), ...]).

    Start cell = first maximum in row-major scan order (the linear
    family's rule, source.cpp:1545); Gotoh three-state walk with H-state
    preference diag -> F (up) -> E (left), matching the family's
    diag -> up -> left order; the path ends where H reaches 0.
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    S = params.matrix.astype(np.int64)
    go, ge = int(params.gap_open), int(params.gap_extend)
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        row_s = S[q[i - 1], t]
        for j in range(1, m + 1):
            E[i, j] = max(E[i, j - 1] - ge, H[i, j - 1] - go)
            F[i, j] = max(F[i - 1, j] - ge, H[i - 1, j] - go)
            H[i, j] = max(
                0, H[i - 1, j - 1] + row_s[j - 1], E[i, j], F[i, j]
            )
            if H[i, j] > best:
                best, bi, bj = int(H[i, j]), i, j
    path = [(bi, bj)]
    i, j, st = bi, bj, 0
    while i or j:
        if st == 0:
            v = H[i, j]
            if v == 0:
                break
            if i and j and v == H[i - 1, j - 1] + S[q[i - 1], t[j - 1]]:
                i, j = i - 1, j - 1
                path.append((i, j))
            elif v == F[i, j]:
                st = 2
            elif v == E[i, j]:
                st = 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine traceback H")
        elif st == 1:  # E: gap moves left
            v = E[i, j]
            if j and v == H[i, j - 1] - go:
                j -= 1
                st = 0
            elif j and v == E[i, j - 1] - ge:
                j -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine traceback E")
            path.append((i, j))
        else:  # F: gap moves up
            v = F[i, j]
            if i and v == H[i - 1, j] - go:
                i -= 1
                st = 0
            elif i and v == F[i - 1, j] - ge:
                i -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine traceback F")
            path.append((i, j))
    path.reverse()
    return best, path


def sw_affine_score_batch(
    qs: np.ndarray, ts: np.ndarray, params: ScoringParams
) -> np.ndarray:
    """Vectorized (anti-diagonal) batch of affine-gap scores."""
    qs = np.asarray(qs, dtype=np.int64)
    ts = np.asarray(ts, dtype=np.int64)
    if qs.ndim == 1:
        qs = qs[None]
    if ts.ndim == 1:
        ts = ts[None]
    B, n = qs.shape
    _, m = ts.shape
    S = params.matrix.astype(np.int64)
    go, ge = int(params.gap_open), int(params.gap_extend)
    subst = S[qs[:, :, None], ts[:, None, :]]
    h2 = np.zeros((B, n + 1), dtype=np.int64)
    h1 = np.zeros((B, n + 1), dtype=np.int64)
    e1 = np.full((B, n + 1), NEG, dtype=np.int64)
    f1 = np.full((B, n + 1), NEG, dtype=np.int64)
    best = np.zeros(B, dtype=np.int64)
    for d in range(2, n + m + 1):
        lo, hi = max(1, d - m), min(n, d - 1)
        cur_h = np.zeros((B, n + 1), dtype=np.int64)
        cur_e = np.full((B, n + 1), NEG, dtype=np.int64)
        cur_f = np.full((B, n + 1), NEG, dtype=np.int64)
        if lo <= hi:
            idx = np.arange(lo, hi + 1)
            sc = subst[:, idx - 1, d - idx - 1]
            e = np.maximum(e1[:, idx] - ge, h1[:, idx] - go)
            f = np.maximum(f1[:, idx - 1] - ge, h1[:, idx - 1] - go)
            h = np.maximum(
                np.maximum(h2[:, idx - 1] + sc, 0), np.maximum(e, f)
            )
            cur_h[:, idx] = h
            cur_e[:, idx] = e
            cur_f[:, idx] = f
            best = np.maximum(best, h.max(axis=1))
        h2, h1, e1, f1 = h1, cur_h, cur_e, cur_f
    return best
