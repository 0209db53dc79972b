"""Adaptive-banded X-drop semi-global alignment with AFFINE (Gotoh) gaps.

Copy of ``swtpu/oracle/banded_affine.py`` (numpy only).

The reference's banded family is linear-gap (1,1,1) only
(source.cpp:1836-1976); affine banded is the BASELINE-mandated extension
("banded affine-gap Smith-Waterman"). The band mechanics are inherited
unchanged from the linear contract (one anti-diagonal per round, direction
by comparing band ends, H==0 means dead, +x_threshold offset, X-drop
zeroing, same traceback start rule); the Gotoh E/F states obey:

- E (gap in query / horizontal move) and F (gap in target / vertical move)
  follow E = max(E_left - ext, H_left - open), F = max(F_up - ext,
  H_up - open), with terms dropped when the predecessor cell is dead;
- when a cell dies (X-drop or all-dead predecessors), its E and F die too
  (-inf) — dead cells block ALL propagation, exactly like the linear
  contract's guards. With gap_open == gap_extend this makes the affine
  recurrence *bit-identical* to the linear banded oracle (tested).

Traceback is the standard Gotoh three-state walk over the recorded band
histories (H, E, F), with the H-state move preference diag → up → left
matching the linear family's order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

MINUS_INF = -(2**30)
EF_DEAD = -(2**28)  # dead E/F sentinel (room for subtraction)


@dataclasses.dataclass
class BandedAffineResult:
    score: int
    path: List[Tuple[int, int]]
    h_hist: np.ndarray  # [rounds, W]
    e_hist: np.ndarray
    f_hist: np.ndarray
    pos_y: np.ndarray
    n_rounds: int
    max_round: int


def banded_affine_xdrop(
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap_open: int = 1,
    gap_extend: int = 1,
    bandwidth: int = 32,
    x_threshold: int = 70,
    return_state: bool = False,
    matrix=None,
):
    """Scalar oracle. Returns (score, path) or BandedAffineResult.

    ``matrix`` (signed scores [q_char, t_char]) selects the general-matrix
    / protein mode; pad involvement scores ``matrix.min()`` (see the linear
    banded oracle's contract note).
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    n, m = len(q), len(t)
    W = int(bandwidth)
    X = int(x_threshold)
    go, ge = int(gap_open), int(gap_extend)
    mat = None if matrix is None else np.asarray(matrix)
    pad_sc = None if mat is None else int(mat.min())

    qp = np.full(1 + n + W, -1, dtype=np.int64)
    qp[1 : 1 + n] = q
    tp = np.full(W + m + W, -1, dtype=np.int64)
    tp[W : W + m] = t

    cap = (max(n, m) + 1) * 2 - 1
    h_hist = np.zeros((cap, W), dtype=np.int64)
    e_hist = np.full((cap, W), EF_DEAD, dtype=np.int64)
    f_hist = np.full((cap, W), EF_DEAD, dtype=np.int64)
    pos_y = np.zeros(cap, dtype=np.int64)

    h_hist[0, W - 1] = X
    result = np.zeros(W, dtype=np.int64)
    result[W - 1] = X
    e_band = np.full(W, EF_DEAD, dtype=np.int64)
    f_band = np.full(W, EF_DEAD, dtype=np.int64)
    horizontal = np.zeros(W, dtype=np.int64)
    vertical = np.zeros(W, dtype=np.int64)
    he = np.full(W, EF_DEAD, dtype=np.int64)  # E at horizontal predecessor
    vf = np.full(W, EF_DEAD, dtype=np.int64)  # F at vertical predecessor

    now_y, now_x = 0, W - 1
    max_round, max_score = 0, X
    n_rounds = 1
    off = (W - 1) - np.arange(W)

    r = 1
    while r < cap:
        if result[0] < result[W - 1]:  # move right
            diagonal = vertical.copy()
            horizontal = result.copy()
            he = e_band.copy()
            vertical = np.concatenate([result[1:], [0]])
            vf = np.concatenate([f_band[1:], [EF_DEAD]])
            now_x += 1
            if now_x > W + m + (W - 1):
                break
        else:  # move down
            diagonal = horizontal.copy()
            vertical = result.copy()
            vf = f_band.copy()
            horizontal = np.concatenate([[0], result[:-1]])
            he = np.concatenate([[EF_DEAD], e_band[:-1]])
            now_y += 1
            if now_y > n + 1:
                break
        pos_y[r] = now_y

        yc = qp[now_y + off]
        xc = tp[now_x - off]
        valid = (yc >= 0) & (xc >= 0)
        if mat is not None:
            sc = np.where(
                valid, mat[np.maximum(yc, 0), np.maximum(xc, 0)], pad_sc
            )
        else:
            sc = np.where(valid & (yc == xc), match, -mismatch)

        # E from the horizontal predecessor (same row, previous column)
        e_new = np.maximum(
            np.where(he > EF_DEAD // 2, he - ge, MINUS_INF),
            np.where(horizontal != 0, horizontal - go, MINUS_INF),
        )
        f_new = np.maximum(
            np.where(vf > EF_DEAD // 2, vf - ge, MINUS_INF),
            np.where(vertical != 0, vertical - go, MINUS_INF),
        )
        h_new = np.zeros(W, dtype=np.int64)
        h_new = np.where(
            diagonal != 0, np.maximum(h_new, diagonal + sc), h_new
        )
        h_new = np.maximum(h_new, np.where(e_new > MINUS_INF // 2, e_new, 0))
        h_new = np.maximum(h_new, np.where(f_new > MINUS_INF // 2, f_new, 0))
        # (max with 0 keeps the "0 = dead" floor semantics of the contract)
        round_max = int(h_new.max(initial=0))

        if max_score < round_max:
            max_round = r
            max_score = round_max

        dead = h_new < max_score - X
        h_new = np.where(dead, 0, h_new)
        e_band = np.where(h_new == 0, EF_DEAD, np.maximum(e_new, MINUS_INF))
        f_band = np.where(h_new == 0, EF_DEAD, np.maximum(f_new, MINUS_INF))
        result = h_new

        h_hist[r] = h_new
        e_hist[r] = e_band
        f_hist[r] = f_band
        n_rounds = r + 1
        if round_max == 0:
            break
        r += 1

    def get(arrs, y, x):
        if y < 0 or y > n or x < 0 or x > m:
            return MINUS_INF
        rr = y + x
        if rr >= n_rounds:
            return MINUS_INF
        k = (W - 1) - (y - pos_y[rr])
        if k < 0 or k >= W:
            return MINUS_INF
        v = arrs[rr, k]
        return int(v)

    def get_h(y, x):
        v = get(h_hist, y, x)
        return MINUS_INF if v == 0 else v

    my, mx = int(pos_y[max_round]), int(max_round - pos_y[max_round])
    while get_h(my, mx) != max_score:
        my += 1
        mx -= 1

    # Gotoh three-state traceback: state 0 = H, 1 = E (left), 2 = F (up)
    path = [(my, mx)]
    i, j, st = my, mx, 0
    while i or j:
        if st == 0:
            v = get_h(i, j)
            if not (i and j):
                s = MINUS_INF
            elif mat is not None:
                s = int(mat[q[i - 1], t[j - 1]])
            else:
                s = match if q[i - 1] == t[j - 1] else -mismatch
            if i and j and v == get_h(i - 1, j - 1) + s:
                i, j = i - 1, j - 1
                path.append((i, j))
            elif v == get(f_hist, i, j):
                st = 2
            elif v == get(e_hist, i, j):
                st = 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine banded traceback H")
        elif st == 1:  # E: gap moves left
            v = get(e_hist, i, j)
            if j and v == get_h(i, j - 1) - gap_open:
                j -= 1
                st = 0
            elif j and v == get(e_hist, i, j - 1) - gap_extend:
                j -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine banded traceback E")
            path.append((i, j))
        else:  # F: gap moves up
            v = get(f_hist, i, j)
            if i and v == get_h(i - 1, j) - gap_open:
                i -= 1
                st = 0
            elif i and v == get(f_hist, i - 1, j) - gap_extend:
                i -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine banded traceback F")
            path.append((i, j))

    path.reverse()
    if return_state:
        return BandedAffineResult(
            score=max_score - X,
            path=path,
            h_hist=h_hist[:n_rounds],
            e_hist=e_hist[:n_rounds],
            f_hist=f_hist[:n_rounds],
            pos_y=pos_y[:n_rounds],
            n_rounds=n_rounds,
            max_round=max_round,
        )
    return max_score - X, path
