"""Checkpointed low-memory host traceback for giant pairs.

Port of ``swtpu/batch/lowmem.py``: host code, no kernel. As in the JAX
package, ``use_native=True`` (the default) walks with the C++ twin
(``swtpu_torch.native.sw_traceback_lowmem``, the same checkpointing
scheme) and ``use_native=False`` with the numpy walker below. The C++
path walks Gotoh with gap_open < gap_extend exactly, as JAX's does; the
numpy walker refuses it (NotImplementedError), as JAX's does.

The naive walker materializes the full (n+1)x(m+1) DP matrix (~1 GB at
16K x 16K) — fine for 128-mers, not for the longpair engine's targets.
This module walks the same path in O(m * n/row_block + row_block * m)
memory (72 MB measured at 16K x 16K with the default block):

1. a streaming forward pass keeps one row live and stores every
   row_block-th row as a checkpoint (device endpoints, when provided,
   bound the pass to the [0..end_i, 0..end_j] prefix);
2. the backward walk re-fills one row block at a time from its
   checkpoint and walks inside it, dropping the block when the path
   crosses its top.

Measured peak (tracemalloc, 16384 x 16384, row_block 512): 72 MB with
device endpoints, 108 MB without (the argmax scan holds one full block).

The within-row serial chain H[j] = max(cand[j], H[j-1] - g) is computed
in closed form per row (max-plus prefix scan as a running max of
cand[k] + k*g — the same associative trick as kernels/xla/colscan.py),
so the forward pass is numpy-vectorized per row.

Affine (Gotoh) uses the exact E-chain decoupling valid for
gap_open >= gap_extend (double-opening is then never optimal):
E[j] = max_{k<j}(c[k] - open - (j-1-k)*ext) with c the E-free H
candidate — the row-major mirror of colscan's F decoupling. Checkpoints
store (H, F) rows; E never crosses rows.

Tie-breaks match the oracles exactly (argmax = first max in row-major
scan order; moves diag -> up -> left; affine state preference
diag -> F -> E).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from swtpu_torch import native
from swtpu_torch.core.scoring import ScoringParams

NEG = -(2**29)


DTYPE = np.int32  # scores + the k*gap rebias stay far below 2^31


def _forward_rows_linear(q, t, S, g, i0, H0, n_rows, keep_block=True):
    """Recompute rows i0+1 .. i0+n_rows from checkpoint row H0 (= row i0).
    keep_block: return the full [n_rows + 1, m + 1] block (block[0] = H0)
    for the backward walk; else return only the last row (the streaming
    forward needs O(m) memory, not O(row_block * m))."""
    m = len(t)
    jg = np.arange(1, m + 1, dtype=DTYPE) * DTYPE(g)
    block = np.empty((n_rows + 1, m + 1), DTYPE) if keep_block else None
    if keep_block:
        block[0] = H0
    prev = H0
    for r in range(1, n_rows + 1):
        s = S[q[i0 + r - 1], t]
        cand = np.maximum(np.maximum(prev[:-1] + s, prev[1:] - g), 0)
        acc = np.maximum.accumulate(cand + jg)
        cur = np.empty(m + 1, DTYPE)
        cur[0] = 0
        cur[1:] = acc - jg
        if keep_block:
            block[r] = cur
        prev = cur
    return block if keep_block else prev


def _forward_rows_affine(q, t, S, go, ge, i0, H0, F0, n_rows,
                         keep_block=True):
    """Affine block recompute from checkpoint (H, F) rows. Returns
    (H_block, E_block, F_block) each [n_rows + 1, m + 1], or just the
    last (H, F) rows when not keep_block."""
    m = len(t)
    jg = np.arange(1, m + 1, dtype=DTYPE) * DTYPE(ge)
    kg = np.arange(m + 1, dtype=DTYPE) * DTYPE(ge)
    if keep_block:
        Hb = np.empty((n_rows + 1, m + 1), DTYPE)
        Eb = np.full((n_rows + 1, m + 1), NEG, DTYPE)
        Fb = np.empty((n_rows + 1, m + 1), DTYPE)
        Hb[0], Fb[0] = H0, F0
    h_prev, f_prev = H0, F0
    for r in range(1, n_rows + 1):
        s = S[q[i0 + r - 1], t]
        f = np.empty(m + 1, DTYPE)
        f[0] = NEG
        f[1:] = np.maximum(f_prev[1:] - ge, h_prev[1:] - go)
        c = np.maximum(np.maximum(h_prev[:-1] + s, f[1:]), 0)
        # E[j] = max_{k<=j-1}(cext[k] - go - (j-1-k)*ge), cext[0] = 0 the
        # H[i,0] boundary: prefix max of cext[k] + k*ge (exact for
        # go >= ge; E-derived H terms are dominated by go - ge >= 0)
        cext = np.empty(m + 1, DTYPE)
        cext[0] = 0
        cext[1:] = c
        acc = np.maximum.accumulate(cext + kg)
        e = np.empty(m + 1, DTYPE)
        e[0] = NEG
        e[1:] = acc[:-1] - go - (jg - ge)
        h = np.maximum(c, e[1:])
        cur = np.empty(m + 1, DTYPE)
        cur[0] = 0
        cur[1:] = h
        if keep_block:
            Hb[r], Eb[r], Fb[r] = cur, e, f
        h_prev, f_prev = cur, f
    if keep_block:
        return Hb, Eb, Fb
    return h_prev, f_prev


def sw_traceback_lowmem(
    q: np.ndarray,
    t: np.ndarray,
    params: ScoringParams,
    row_block: int = 512,
    ends: Optional[Tuple[int, int]] = None,
    use_native: bool = True,
) -> Tuple[int, List[Tuple[int, int]]]:
    """(score, path) identical to oracle.sw.sw_traceback /
    oracle.affine.sw_affine_traceback, in O(m * (n/row_block + row_block))
    memory. ``ends`` = device-computed (end_i, end_j) bounds the forward
    pass to the [0..end_i, 0..end_j] prefix (the device-forward/host-walk
    split of batch/traceback.py, at longpair scale).

    ``use_native`` (default) walks with the C++ twin, exact for any gap
    model (its serial recurrences need no E-chain decoupling), else with
    numpy, whose affine mode needs gap_open >= gap_extend and raises
    NotImplementedError otherwise.
    """
    if use_native and native.available():
        return native.sw_traceback_lowmem(
            np.asarray(q, np.uint8), np.asarray(t, np.uint8), params.matrix,
            int(params.gap_open), int(params.gap_extend), ends=ends,
            row_block=row_block,
        )
    affine = not params.is_linear
    if affine and params.gap_open < params.gap_extend:
        raise NotImplementedError(
            "lowmem affine walker needs gap_open >= gap_extend"
        )
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    S = params.matrix.astype(DTYPE)
    if ends is not None:
        bi, bj = int(ends[0]), int(ends[1])
        if bi == 0 or bj == 0:
            return 0, [(0, 0)]
        q, t = q[:bi], t[:bj]
    n, m = len(q), len(t)

    if affine:
        go, ge = int(params.gap_open), int(params.gap_extend)
    else:
        g = int(params.gap)

    # --- streaming forward: checkpoints every row_block rows + argmax.
    # With device endpoints the pass keeps only the last row per block
    # (O(m) live memory); without them it materializes one block at a
    # time to locate the row-major-first argmax.
    ck: List[np.ndarray] = [np.zeros(m + 1, DTYPE)]
    ck_f: List[np.ndarray] = [np.full(m + 1, NEG, DTYPE)]
    best, ei, ej = 0, 0, 0
    h_prev = ck[0]
    f_prev = ck_f[0]
    for blk0 in range(0, n, row_block):
        rows = min(row_block, n - blk0)
        if affine:
            if ends is None:
                Hb, _, Fb = _forward_rows_affine(
                    q, t, S, go, ge, blk0, h_prev, f_prev, rows
                )
                h_prev, f_prev = Hb[rows], Fb[rows]
            else:
                h_prev, f_prev = _forward_rows_affine(
                    q, t, S, go, ge, blk0, h_prev, f_prev, rows,
                    keep_block=False,
                )
        elif ends is None:
            Hb = _forward_rows_linear(q, t, S, g, blk0, h_prev, rows)
            h_prev = Hb[rows]
        else:
            h_prev = _forward_rows_linear(
                q, t, S, g, blk0, h_prev, rows, keep_block=False
            )
        if ends is None:
            # row-major-first argmax: strict '>' across rows; first
            # column within a row
            for r in range(1, rows + 1):
                v = int(Hb[r].max())
                if v > best:
                    best = v
                    ei = blk0 + r
                    ej = int(np.argmax(Hb[r] == v))
            del Hb
        if blk0 + rows < n:
            ck.append(h_prev.copy())
            if affine:
                ck_f.append(f_prev.copy())

    if ends is not None:
        ei, ej = n, m
        best = int(h_prev[m])
    if best == 0 and ends is None:
        return 0, [(0, 0)]

    # --- backward walk, one block at a time
    path: List[Tuple[int, int]] = [(ei, ej)]
    i, j = ei, ej
    if affine:
        st = 0  # 0 = H, 1 = E, 2 = F (oracle.affine state machine)
    while i or j:
        blk0 = (i - 1) // row_block * row_block
        rows = min(row_block, n - blk0)
        if affine:
            Hb, Eb, Fb = _forward_rows_affine(
                q, t, S, go, ge, blk0, ck[blk0 // row_block],
                ck_f[blk0 // row_block], rows,
            )
        else:
            Hb = _forward_rows_linear(
                q, t, S, g, blk0, ck[blk0 // row_block], rows
            )
        get = lambda y, x: int(Hb[y - blk0, x])
        stop = False
        while i > blk0 or (i == blk0 == 0 and (i or j)):
            if not affine:
                v = get(i, j)
                if v == 0:
                    stop = True
                    break
                if (
                    i and j
                    and v == get(i - 1, j - 1) + S[q[i - 1], t[j - 1]]
                ):
                    i, j = i - 1, j - 1
                elif i and v == get(i - 1, j) - g:
                    i -= 1
                elif j and v == get(i, j - 1) - g:
                    j -= 1
                else:  # pragma: no cover
                    raise AssertionError("inconsistent lowmem traceback")
                path.append((i, j))
            else:
                if st == 0:
                    v = get(i, j)
                    if v == 0:
                        stop = True
                        break
                    if (
                        i and j
                        and v == get(i - 1, j - 1) + S[q[i - 1], t[j - 1]]
                    ):
                        i, j = i - 1, j - 1
                        path.append((i, j))
                    elif v == Fb[i - blk0, j]:
                        st = 2
                    elif v == Eb[i - blk0, j]:
                        st = 1
                    else:  # pragma: no cover
                        raise AssertionError("inconsistent lowmem H")
                elif st == 1:  # E: gap moves left
                    v = Eb[i - blk0, j]
                    if j and v == get(i, j - 1) - go:
                        j -= 1
                        st = 0
                    elif j and v == Eb[i - blk0, j - 1] - ge:
                        j -= 1
                    else:  # pragma: no cover
                        raise AssertionError("inconsistent lowmem E")
                    path.append((i, j))
                else:  # F: gap moves up
                    v = Fb[i - blk0, j]
                    if i and v == get(i - 1, j) - go:
                        i -= 1
                        st = 0
                    elif i and v == Fb[i - blk0 - 1, j] - ge:
                        i -= 1
                    else:  # pragma: no cover
                        raise AssertionError("inconsistent lowmem F")
                    path.append((i, j))
            if i == blk0 and blk0 > 0:
                break  # crossed into the previous block
        if stop or (i == 0 and j == 0):
            break
        if i == 0:
            # walked to the top row: only left moves remain, and H[0,:]
            # is all zeros => the walk has ended (local alignment)
            break
    if ends is not None and best == 0:
        return 0, [(0, 0)]
    path.reverse()
    return best, path
