"""Block-adaptive banded X-drop semi-global oracle — the round-4 tier.

Copy of ``swtpu/oracle/banded_block.py`` (numpy only).

The per-round adaptive band (oracle/semiglobal.py::banded_xdrop ≙
source.cpp:1836-1976) decides direction / rescales / X-drops EVERY
anti-diagonal round; its TPU kernels are therefore permute-bound (~15
lane-motion ops per 32-cell round, README "Hardware notes") and run 80x
below the fixed-band rowscan ceiling. This tier amortizes ALL adaptive
work over a block of K rows so the inner loop is the fixed-corridor
rowscan schedule (zero lane motion):

- The band is a diagonal CORRIDOR of ``width`` consecutive columns that
  slides right one column per row (following the main diagonal); its
  per-block base is re-centered once per block from the carried row's
  argmax (clipped to ±dmax) — the block analog of the reference's
  per-round right/down decision (source.cpp:1891-1912).
- X-drop (zero cells below max - X) and the dead-band termination test
  run once per block on the carried boundary row, not per round
  (source.cpp:1933-1941's contract at block granularity). Interior
  cells below the cutoff survive to the block end — the block tier
  prunes strictly less than the per-round tier inside a block.
- Values carry the +X offset with 0 = dead, exactly the family
  convention: any cell value <= 0 is dead, dead diag never resurrects
  (guarded), dead up/left decay below the 0 floor by themselves.

This oracle IS the contract for the block kernels (the reference's own
oracle-tiering lesson: band-clipped tiers get band-clipped oracles,
full-matrix comparison is statistical only — source.cpp:2773-2784).
Scores cross-check statistically against the per-round oracle on
mutation-model pairs in tests/test_banded_block.py.

Coordinate/semantics spec (shared verbatim by the XLA and Pallas
engines):

- blocks b = 0, 1, ...; block b processes rows y = b*K+1 .. b*K+K;
  row y's band covers columns j in [base_b + r, base_b + r + width)
  where r = (y-1) - b*K (the corridor slides +1 per row inside the
  block; slot k holds column j = base_b + r + k).
- base_0 = 1 - width//2 (band initially centered on the origin);
  base_{b+1} = base_b + K + delta_b with
  delta_b = clip(first_argmax(carried) - width//2, -dmax, +dmax).
- recurrence for cell (y, j) at slot k (after the previous row is
  aligned so prev[k] = H(y-1, j-1)):
      diag = prev[k] > 0 ? prev[k] + s(y, j)   : dead
      up   = prev[k+1] > 0 ? prev[k+1] - gap   : dead   (k = W-1: dead)
      left = H[k-1] > 0 ? H[k-1] - gap         : dead   (k = 0: see pin)
      H[k] = max(diag, up, left, 0)
  s(y, j) = match/-mismatch (or matrix[q, t]); any pad involvement
  (j < 1, j > m, y > len, pad codes) scores -mismatch (matrix.min()).
- column-0 boundary: a slot holding j == 0 is PINNED to the gap chain
  max(X - y*gap, 0) after the recurrence; when slot 0's left neighbor
  is column 0 (base_b + r == 1), left reads the chain value directly.
  Row 0 (the initial carried row) is the top chain H(0, j) = X - j*gap.
- endpoint = first (row-major: max H, then min y, then min j) cell over
  all in-band cells of all rows; score = H(endpoint) - X. Traceback
  from the endpoint over the stored band history, tie-break
  diag -> up -> left (the family order, source.cpp:1558-1567).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

MINUS_INF = -(2**30)


@dataclasses.dataclass
class BandedBlockResult:
    """Forward state for kernel parity tests and the traceback walker.

    band_history[y-1] holds row y's band values at slots 0..width-1
    (slot k <-> column base_of_row(y) + k); row_base[y-1] = that base
    = base_b + r. n_rows = rows actually computed (done may cut early,
    always a multiple of K except at y = n).
    """

    score: int
    path: List[Tuple[int, int]]
    end: Tuple[int, int]
    band_history: np.ndarray  # [n_rows, width] int64
    row_base: np.ndarray  # [n_rows] int64
    n_rows: int
    bases: np.ndarray  # [n_blocks] int64 base_b
    deltas: np.ndarray  # [n_blocks] int64 delta_b


def walk_block_history(
    hist: np.ndarray,
    row_base: np.ndarray,
    end: Tuple[int, int],
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    x_threshold: int = 70,
    matrix: Optional[np.ndarray] = None,
) -> List[Tuple[int, int]]:
    """Traceback over a stored block-tier band history.

    Shared by the scalar oracle and the batch engines (the engines' host
    walk fetches ``hist[:n_rows]`` / ``row_base[:n_rows]`` and calls
    this). ``end`` is the 1-based (y, j) endpoint; values in ``hist``
    carry the +x_threshold offset with 0 = dead. Walk order is the family
    tie-break diag -> up -> left (source.cpp:1558-1567). Returns the
    1-based (y, j) path origin -> endpoint; an all-dead endpoint (0, 0)
    returns [(0, 0)].
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    n_rows = len(hist)
    W = hist.shape[1] if n_rows else 0
    m = len(t)
    X = int(x_threshold)
    g = int(gap)
    mat = None if matrix is None else np.asarray(matrix, dtype=np.int64)
    pad_sc = -int(mismatch) if mat is None else int(mat.min())
    max_y, max_j = end

    def get(y: int, j: int) -> int:
        if y == 0:
            v = X - j * g if j >= 0 else MINUS_INF
            return int(v) if v > 0 or (j == 0) else MINUS_INF
        if y < 1 or y > n_rows:
            return MINUS_INF
        if j == 0:
            v = X - y * g
            # the pinned column-0 chain is only reachable while stored
            k = j - row_base[y - 1]
            if 0 <= k < W:
                vv = hist[y - 1, k]
                return MINUS_INF if vv == 0 else int(vv)
            return int(v) if v > 0 else MINUS_INF
        k = j - row_base[y - 1]
        if k < 0 or k >= W:
            return MINUS_INF
        v = hist[y - 1, k]
        return MINUS_INF if v == 0 else int(v)

    def sub(y: int, j: int) -> int:
        if j < 1 or j > m:
            return pad_sc
        if mat is not None:
            return int(mat[q[y - 1], t[j - 1]])
        return match if q[y - 1] == t[j - 1] else pad_sc

    if max_y == 0 and max_j == 0:
        return [(0, 0)]
    path = [(max_y, max_j)]
    i, j = max_y, max_j
    while i or j:
        v = get(i, j)
        if i and j and get(i - 1, j - 1) > MINUS_INF and v == get(
            i - 1, j - 1
        ) + sub(i, j):
            i, j = i - 1, j - 1
        elif i and get(i - 1, j) > MINUS_INF and v == get(i - 1, j) - g:
            i = i - 1
        elif j and get(i, j - 1) > MINUS_INF and v == get(i, j - 1) - g:
            j = j - 1
        else:  # pragma: no cover
            raise AssertionError("inconsistent block-banded traceback")
        path.append((i, j))
    path.reverse()
    return path


EF_DEAD = -(2**28)  # dead E/F sentinel (the affine family's convention)
EF_CUT = EF_DEAD // 2


def _affine_chain(y_or_j, X, go, ge):
    """The affine leading-gap boundary chain value at index i >= 0:
    X at the origin, X - go - (i-1)*ge past it."""
    i = np.asarray(y_or_j, dtype=np.int64)
    return np.where(i == 0, X, X - go - (i - 1) * ge)


def reconstruct_block_ef(h_hist, row_base, go, ge, X):
    """Derive the affine E/F band rows from an H-only block history.

    E and F never read substitution scores, so they are a pure function
    of the H history + corridor geometry — the same trick as the
    per-round tier's reconstruct_affine_bands (banded_batch emits H-only
    history too). Slot mapping runs in COLUMN space (prev slot =
    j - row_base[y-2]), which handles the within-block +1 slide and the
    block-boundary delta jump uniformly. Death rule: E/F are EF_DEAD
    wherever H is dead (dead cells block all propagation), matching the
    per-round affine oracle (oracle/banded_affine.py).
    """
    h_hist = np.asarray(h_hist, dtype=np.int64)
    n_rows, W = h_hist.shape
    e_hist = np.full_like(h_hist, EF_DEAD)
    f_hist = np.full_like(h_hist, EF_DEAD)
    ks = np.arange(W)
    for y in range(1, n_rows + 1):
        rb = int(row_base[y - 1])
        js = rb + ks
        if y == 1:
            # row 0 boundary: H(0, c) = X at the origin, the leading-gap
            # chain (dead when <= 0) for c >= 1, dead for c < 0
            c = js
            ph = np.where(
                c >= 0, np.maximum(_affine_chain(c, X, go, ge), 0), 0
            )
            ph = np.where(c == 0, X, ph)
            pf = np.full(W, EF_DEAD, dtype=np.int64)
        else:
            kp = js - int(row_base[y - 2])
            inb = (kp >= 0) & (kp < W)
            kpc = np.clip(kp, 0, W - 1)
            ph = np.where(inb, h_hist[y - 2, kpc], 0)
            pf = np.where(inb, f_hist[y - 2, kpc], EF_DEAD)
            # out-of-band column 0 reads the pin chains
            col0 = (js == 0) & ~inb
            ph = np.where(
                col0, np.maximum(_affine_chain(y - 1, X, go, ge), 0), ph
            )
            pf = np.where(col0, _affine_chain(y - 1, X, go, ge), pf)
        f = np.maximum(
            np.where(pf > EF_CUT, pf - ge, MINUS_INF),
            np.where(ph > 0, ph - go, MINUS_INF),
        )
        # E left-to-right off the FINAL h row (h_hist already carries the
        # column-0 pins)
        h_row = h_hist[y - 1]
        e = np.full(W, MINUS_INF, dtype=np.int64)
        if js[0] - 1 == 0:
            h_l = max(int(_affine_chain(y, X, go, ge)), 0)
            e_l = MINUS_INF
        else:
            h_l, e_l = 0, MINUS_INF
        for k in range(W):
            ek = max(
                e_l - ge if e_l > EF_CUT else MINUS_INF,
                h_l - go if h_l > 0 else MINUS_INF,
            )
            # pin + death INSIDE the chain, like the forward: the next
            # slot's e_l must see the post-pin/post-death value
            if js[k] == 0 or h_row[k] == 0:
                ek = EF_DEAD
            e[k] = ek
            h_l, e_l = int(h_row[k]), max(ek, EF_DEAD)
        f = np.where(js == 0, _affine_chain(y, X, go, ge), f)
        dead = h_row == 0
        e_hist[y - 1] = np.maximum(e, EF_DEAD)
        f_hist[y - 1] = np.where(dead, EF_DEAD, np.maximum(f, EF_DEAD))
    return e_hist, f_hist


def walk_block_history_affine(
    hist: np.ndarray,
    row_base: np.ndarray,
    end: Tuple[int, int],
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap_open: int = 1,
    gap_extend: int = 1,
    x_threshold: int = 70,
    matrix: Optional[np.ndarray] = None,
) -> List[Tuple[int, int]]:
    """Gotoh three-state traceback over an H-only block-tier history
    (E/F reconstructed via :func:`reconstruct_block_ef`). Move
    preference H: diag -> F -> E (the affine family's order,
    oracle/banded_affine.py)."""
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    n_rows = len(hist)
    W = hist.shape[1] if n_rows else 0
    m = len(t)
    X = int(x_threshold)
    go, ge = int(gap_open), int(gap_extend)
    mat = None if matrix is None else np.asarray(matrix, dtype=np.int64)
    pad_sc = -int(mismatch) if mat is None else int(mat.min())
    e_hist, f_hist = reconstruct_block_ef(hist, row_base, go, ge, X)

    def slot(y, j):
        k = j - row_base[y - 1]
        return int(k) if 0 <= k < W else None

    def get_h(y, j):
        if y == 0:
            v = int(_affine_chain(j, X, go, ge)) if j >= 0 else MINUS_INF
            return v if (j == 0 or v > 0) else MINUS_INF
        if y < 1 or y > n_rows:
            return MINUS_INF
        k = slot(y, j)
        if k is not None:
            v = int(hist[y - 1, k])
            return MINUS_INF if v == 0 else v
        if j == 0:
            v = int(_affine_chain(y, X, go, ge))
            return v if v > 0 else MINUS_INF
        return MINUS_INF

    def get_e(y, j):
        if y == 0:
            return (
                int(_affine_chain(j, X, go, ge)) if j >= 1 else MINUS_INF
            )
        if y < 1 or y > n_rows or j < 1:
            return MINUS_INF
        k = slot(y, j)
        if k is None:
            return MINUS_INF
        v = int(e_hist[y - 1, k])
        return MINUS_INF if v <= EF_CUT else v

    def get_f(y, j):
        if y < 1 or y > n_rows:
            return MINUS_INF
        k = slot(y, j)
        if k is not None:
            v = int(f_hist[y - 1, k])
            return MINUS_INF if v <= EF_CUT else v
        if j == 0:
            return int(_affine_chain(y, X, go, ge))
        return MINUS_INF

    def sub(y, j):
        if j < 1 or j > m:
            return pad_sc
        if mat is not None:
            return int(mat[q[y - 1], t[j - 1]])
        return match if q[y - 1] == t[j - 1] else pad_sc

    my, mj = end
    if my == 0 and mj == 0:
        return [(0, 0)]
    path = [(my, mj)]
    i, j, st = my, mj, 0
    while i or j:
        if st == 0:
            v = get_h(i, j)
            if i and j and get_h(i - 1, j - 1) > MINUS_INF and v == get_h(
                i - 1, j - 1
            ) + sub(i, j):
                i, j = i - 1, j - 1
                path.append((i, j))
            elif v == get_f(i, j):
                st = 2
            elif v == get_e(i, j):
                st = 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent block affine walk (H)")
        elif st == 1:  # E: gap moves left
            v = get_e(i, j)
            if j and v == get_h(i, j - 1) - go:
                j -= 1
                st = 0
            elif j and v == get_e(i, j - 1) - ge:
                j -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent block affine walk (E)")
            path.append((i, j))
        else:  # F: gap moves up
            v = get_f(i, j)
            if i and v == get_h(i - 1, j) - go:
                i -= 1
                st = 0
            elif i and v == get_f(i - 1, j) - ge:
                i -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent block affine walk (F)")
            path.append((i, j))
    path.reverse()
    return path


def banded_xdrop_block_affine(
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap_open: int = 1,
    gap_extend: int = 1,
    width: int = 64,
    block: int = 32,
    x_threshold: int = 70,
    dmax: Optional[int] = None,
    matrix: Optional[np.ndarray] = None,
    return_state: bool = False,
):
    """Scalar block-adaptive banded X-drop with AFFINE (Gotoh) gaps.

    The linear tier's corridor/block contract with the affine family's
    E/F semantics (oracle/banded_affine.py): E/F carry EF_DEAD when
    dead, dead H blocks all propagation, boundary chains are the affine
    leading-gap chains (X - go - (i-1)*ge past the origin), and the
    column-0 pin stores the chain in H (relu) and F (raw). With
    gap_open == gap_extend this is bit-identical to the linear
    :func:`banded_xdrop_block` (tested). History is H-only — E/F are
    reconstructable (:func:`reconstruct_block_ef`), which is also the
    engine's storage contract.
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    n, m = len(q), len(t)
    W = int(width)
    K = int(block)
    X = int(x_threshold)
    go, ge = int(gap_open), int(gap_extend)
    D = min(K, W // 2) if dmax is None else int(dmax)
    mat = None if matrix is None else np.asarray(matrix, dtype=np.int64)
    pad_sc = -int(mismatch) if mat is None else int(mat.min())

    n_blocks = -(-n // K) if n else 0
    hist = np.zeros((n_blocks * K, W), dtype=np.int64)
    row_base = np.zeros(n_blocks * K, dtype=np.int64)
    bases = np.zeros(max(n_blocks, 1), dtype=np.int64)
    deltas = np.zeros(max(n_blocks, 1), dtype=np.int64)

    base = 1 - W // 2
    j0 = base - 1 + np.arange(W)
    carried_h = np.where(
        j0 >= 0, np.maximum(_affine_chain(np.maximum(j0, 0), X, go, ge), 0),
        0,
    )
    carried_h = np.where(j0 == 0, X, carried_h)
    carried_f = np.full(W, EF_DEAD, dtype=np.int64)

    max_score, max_y, max_j = X, 0, 0
    n_rows = 0
    ks = np.arange(W)

    def s_row(y, js):
        qc = q[y - 1]
        in_t = (js >= 1) & (js <= m)
        tc = np.where(in_t, t[np.clip(js - 1, 0, max(m - 1, 0))], -1)
        if mat is not None:
            ok = (qc >= 0) & (tc >= 0)
            return np.where(
                ok, mat[min(max(qc, 0), mat.shape[0] - 1),
                        np.clip(tc, 0, mat.shape[1] - 1)], pad_sc
            )
        return np.where((qc == tc) & (tc >= 0), match, pad_sc)

    done = False
    b = 0
    for b in range(n_blocks):
        if done:
            break
        bases[b] = base
        prev_h, prev_f = carried_h, carried_f
        for r in range(K):
            y = b * K + r + 1
            if y > n:
                break
            js = base + r + ks
            s = s_row(y, js)
            H = np.zeros(W, dtype=np.int64)
            F = np.full(W, MINUS_INF, dtype=np.int64)
            if base + r == 1:  # left of slot 0 is the pinned column 0
                h_l = max(int(_affine_chain(y, X, go, ge)), 0)
            else:
                h_l = 0
            e_l = MINUS_INF
            for k in range(W):
                diag = (
                    prev_h[k] + s[k] if prev_h[k] > 0 else MINUS_INF
                )
                pf = prev_f[k + 1] if k + 1 < W else EF_DEAD
                ph = prev_h[k + 1] if k + 1 < W else 0
                f = max(
                    pf - ge if pf > EF_CUT else MINUS_INF,
                    ph - go if ph > 0 else MINUS_INF,
                )
                e = max(
                    e_l - ge if e_l > EF_CUT else MINUS_INF,
                    h_l - go if h_l > 0 else MINUS_INF,
                )
                v = max(diag, e, f, 0)
                if js[k] == 0:  # column-0 pin (chain in H and F)
                    v = max(int(_affine_chain(y, X, go, ge)), 0)
                    f = int(_affine_chain(y, X, go, ge))
                    e = MINUS_INF
                if v == 0:  # dead blocks all propagation
                    e, f = EF_DEAD, EF_DEAD
                H[k] = v
                F[k] = max(f, EF_DEAD)
                h_l, e_l = v, max(e, EF_DEAD)
            hist[y - 1] = H
            row_base[y - 1] = base + r
            n_rows = y
            rm = int(H.max()) if W else 0
            if rm > max_score:
                max_score = rm
                max_y = y
                max_j = int(base + r + int(np.argmax(H == rm)))
            prev_h, prev_f = H, F
        carried_h = np.where(prev_h < max_score - X, 0, prev_h)
        carried_f = np.where(carried_h == 0, EF_DEAD, prev_f)
        if n_rows >= 1:
            hist[n_rows - 1] = carried_h
        if not carried_h.any() or n_rows >= n:
            done = True
            deltas[b] = 0
            continue
        km = int(np.argmax(carried_h))
        delta = int(np.clip(km - W // 2, -D, D))
        deltas[b] = delta
        src = ks + delta
        inr = (src >= 0) & (src < W)
        carried_h = np.where(
            inr, carried_h[np.clip(src, 0, W - 1)], 0
        )
        carried_f = np.where(
            inr, carried_f[np.clip(src, 0, W - 1)], EF_DEAD
        )
        base = base + K + delta

    score = max_score - X
    path = walk_block_history_affine(
        hist[:n_rows], row_base[:n_rows], (max_y, max_j), q, t,
        match=match, mismatch=mismatch, gap_open=go, gap_extend=ge,
        x_threshold=X, matrix=mat,
    )
    if return_state:
        return BandedBlockResult(
            score=score,
            path=path,
            end=(max_y, max_j),
            band_history=hist[:n_rows],
            row_base=row_base[:n_rows],
            n_rows=n_rows,
            bases=bases[: b + 1] if n_blocks else bases[:0],
            deltas=deltas[: b + 1] if n_blocks else deltas[:0],
        )
    return score, path


def banded_xdrop_block(
    q: np.ndarray,
    t: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    width: int = 64,
    block: int = 32,
    x_threshold: int = 70,
    dmax: Optional[int] = None,
    matrix: Optional[np.ndarray] = None,
    return_state: bool = False,
):
    """Scalar block-adaptive banded X-drop semi-global alignment.

    Returns (score, path) or a :class:`BandedBlockResult`. path is the
    1-based (y, j) DP coordinate list origin -> endpoint like the other
    semiglobal oracles; an all-dead start (nothing scored) returns
    score 0 with path [(0, 0)].
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    n, m = len(q), len(t)
    W = int(width)
    K = int(block)
    X = int(x_threshold)
    g = int(gap)
    D = min(K, W // 2) if dmax is None else int(dmax)
    mat = None if matrix is None else np.asarray(matrix, dtype=np.int64)
    pad_sc = -int(mismatch) if mat is None else int(mat.min())

    n_blocks = -(-n // K) if n else 0
    hist = np.zeros((n_blocks * K, W), dtype=np.int64)
    row_base = np.zeros(n_blocks * K, dtype=np.int64)
    bases = np.zeros(max(n_blocks, 1), dtype=np.int64)
    deltas = np.zeros(max(n_blocks, 1), dtype=np.int64)

    base = 1 - W // 2
    # initial carried row: prev[k] = H(0, base - 1 + k) = top gap chain
    j0 = base - 1 + np.arange(W)
    carried = np.where(j0 >= 0, X - j0 * g, 0)
    carried = np.where(carried > 0, carried, 0)

    max_score, max_y, max_j = X, 0, 0
    n_rows = 0
    ks = np.arange(W)

    def s_row(y, js):
        """Substitution scores for row y against columns js (1-based)."""
        qc = q[y - 1]
        in_t = (js >= 1) & (js <= m)
        tc = np.where(in_t, t[np.clip(js - 1, 0, max(m - 1, 0))], -1)
        if mat is not None:
            ok = (qc >= 0) & (tc >= 0) & (qc < mat.shape[0]) & (
                tc < mat.shape[1]
            )
            return np.where(ok, mat[min(max(qc, 0), mat.shape[0] - 1), np.clip(tc, 0, mat.shape[1] - 1)], pad_sc)
        return np.where((qc == tc) & (tc >= 0), match, pad_sc)

    done = False
    for b in range(n_blocks):
        if done:
            break
        bases[b] = base
        prev = carried
        for r in range(K):
            y = b * K + r + 1
            if y > n:
                # fake row (batch kernels compute it with pads; it can
                # never win the argmax — see module docstring); the
                # oracle simply stops storing
                break
            js = base + r + ks
            s = s_row(y, js)
            H = np.zeros(W, dtype=np.int64)
            chain = np.int64(X - y * g) if (base + r == 1) else np.int64(0)
            left = chain if chain > 0 else np.int64(0)
            for k in range(W):
                diag = prev[k] + s[k] if prev[k] > 0 else 0
                up = (
                    prev[k + 1] - g
                    if (k + 1 < W and prev[k + 1] > 0)
                    else 0
                )
                lf = left - g if left > 0 else 0
                v = max(diag, up, lf, 0)
                if js[k] == 0:
                    v = max(X - y * g, 0)
                H[k] = v
                left = v
            hist[y - 1] = H
            row_base[y - 1] = base + r
            n_rows = y
            # row-major first-max tracking (strict >)
            rm = int(H.max()) if W else 0
            if rm > max_score:
                max_score = rm
                max_y = y
                max_j = int(base + r + int(np.argmax(H == rm)))
            prev = H
        # block end: X-drop + re-center on the carried row
        carried_last = prev
        carried_last = np.where(carried_last < max_score - X, 0, carried_last)
        if n_rows >= 1:
            hist[n_rows - 1] = carried_last  # zeroing is part of history
        if not carried_last.any() or n_rows >= n:
            done = True
            deltas[b] = 0
            carried = carried_last
            continue
        km = int(np.argmax(carried_last))
        delta = int(np.clip(km - W // 2, -D, D))
        deltas[b] = delta
        new_base = base + K + delta
        # realign: carried[k] = carried_last[k + delta]
        src = ks + delta
        carried = np.where(
            (src >= 0) & (src < W), carried_last[np.clip(src, 0, W - 1)], 0
        )
        base = new_base

    score = max_score - X

    path = walk_block_history(
        hist[:n_rows],
        row_base[:n_rows],
        (max_y, max_j),
        q,
        t,
        match=match,
        mismatch=mismatch,
        gap=g,
        x_threshold=X,
        matrix=mat,
    )

    if return_state:
        return BandedBlockResult(
            score=score,
            path=path,
            end=(max_y, max_j),
            band_history=hist[:n_rows],
            row_base=row_base[:n_rows],
            n_rows=n_rows,
            bases=bases[: b + 1] if n_blocks else bases[:0],
            deltas=deltas[: b + 1] if n_blocks else deltas[:0],
        )
    return score, path
