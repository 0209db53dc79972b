"""CIGAR strings from traceback paths.

Copy of ``swtpu/core/cigar.py`` (numpy only), kept in the port so that it
imports nothing of the JAX package.

The reference returns alignments as coordinate paths — vectors of 1-based
(i, j) DP cells (``SmithWaterman_111_long``, source.cpp:1526-1576;
``SemiGlobal_111``, source.cpp:1776-1834). Every traceback engine
(local, semi-global, banded, longpair; linear and affine) keeps that
contract. This module is the standard downstream encoding of such a path:
a run-length CIGAR string, so results plug into the SAM/BAM ecosystem a
reference user would feed alignments into.

Conventions (SAM spec, query = q, reference = t):
- ``=``/``X`` (or ``M`` in plain mode) — diagonal step, consumes one char
  of both sequences;
- ``I`` — step that advances only i, consumes one query char (insertion
  relative to the target);
- ``D`` — step that advances only j, consumes one target char (deletion
  relative to the target);
- ``S`` — soft clip (local alignment only: query chars outside the
  aligned window; added by :func:`path_to_cigar` with ``query_len``).

``path[0]`` is the anchor cell (the cell *before* the first aligned
column), so a path of k+1 cells encodes k alignment columns.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["path_to_cigar", "cigar_stats"]


def _ops(
    path: Sequence[Tuple[int, int]],
    q: Optional[np.ndarray],
    t: Optional[np.ndarray],
    extended: bool,
) -> List[str]:
    ops: List[str] = []
    for (i0, j0), (i1, j1) in zip(path, path[1:]):
        di, dj = i1 - i0, j1 - j0
        if di == 1 and dj == 1:
            if extended:
                ops.append("=" if q[i1 - 1] == t[j1 - 1] else "X")
            else:
                ops.append("M")
        elif di == 1 and dj == 0:
            ops.append("I")
        elif di == 0 and dj == 1:
            ops.append("D")
        else:
            raise ValueError(
                f"non-unit path step ({i0},{j0}) -> ({i1},{j1}); "
                "not a traceback path"
            )
    return ops


def _rle(ops: Sequence[str]) -> str:
    out: List[str] = []
    k = 0
    while k < len(ops):
        run = k
        while run < len(ops) and ops[run] == ops[k]:
            run += 1
        out.append(f"{run - k}{ops[k]}")
        k = run
    return "".join(out)


def path_to_cigar(
    path: Sequence[Tuple[int, int]],
    q: Optional[np.ndarray] = None,
    t: Optional[np.ndarray] = None,
    *,
    query_len: Optional[int] = None,
) -> str:
    """Run-length CIGAR for a traceback path.

    With ``q`` and ``t`` (the unpadded code arrays the path was computed
    on) diagonal steps become ``=``/``X``; without them, ``M``. With
    ``query_len``, unaligned query chars outside [path[0].i, path[-1].i]
    are emitted as leading/trailing soft clips ``S`` (the SAM encoding of
    a local alignment). An empty alignment (path with < 2 cells, e.g. a
    zero-score local pair) yields ``"{query_len}S"`` or ``""``.
    """
    path = [(int(i), int(j)) for i, j in path]
    extended = q is not None and t is not None
    if extended:
        q = np.asarray(q)
        t = np.asarray(t)
    ops = _ops(path, q, t, extended) if len(path) >= 2 else []
    body = _rle(ops)
    if query_len is None:
        return body
    if not ops:
        return f"{int(query_len)}S" if query_len else ""
    clip5 = path[0][0]
    clip3 = int(query_len) - path[-1][0]
    if clip3 < 0:
        raise ValueError(
            f"query_len {query_len} shorter than path end row {path[-1][0]}"
        )
    pre = f"{clip5}S" if clip5 else ""
    post = f"{clip3}S" if clip3 else ""
    return pre + body + post


def cigar_stats(cigar: str) -> dict:
    """Decode a CIGAR into op counts: consumed query/target lengths,
    matches/mismatches (``=``/``X``; ``M`` counts as aligned), indels,
    clips. Useful for identity/coverage reporting and as a cheap
    cross-check that a CIGAR is consistent with its pair of sequences."""
    counts = {op: 0 for op in "MIDSX="}
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
            continue
        if ch not in counts:
            raise ValueError(f"unsupported CIGAR op {ch!r}")
        if num == 0:
            raise ValueError("CIGAR op with no count")
        counts[ch] += num
        num = 0
    if num:
        raise ValueError("trailing digits in CIGAR")
    aligned = counts["M"] + counts["="] + counts["X"]
    return dict(
        query_consumed=aligned + counts["I"] + counts["S"],
        target_consumed=aligned + counts["D"],
        aligned_columns=aligned,
        matches=counts["="],
        mismatches=counts["X"],
        insertions=counts["I"],
        deletions=counts["D"],
        clipped=counts["S"],
    )
