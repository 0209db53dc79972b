"""SAM output for alignment results.

Port of ``swtpu/core/sam.py``: SAM 1.6 records (CIGAR with soft
clips, ``AS`` score and ``NM`` edit-distance tags) over the repo-wide
(score, [(i, j), ...]) path contract. The records are byte-identical to
the JAX package's, ``@PG`` line included, so either engine's output feeds
the same downstream tools.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from swtpu_torch.core.cigar import cigar_stats, path_to_cigar
from swtpu_torch.core.io import decode_dna
from swtpu_torch.core.protein import decode_protein

__all__ = ["sam_header", "sam_record"]


def _decode(codes: np.ndarray, alphabet: str) -> str:
    if alphabet == "protein":
        return decode_protein(codes)
    return decode_dna(codes)


def sam_header(
    targets: Sequence[Tuple[str, int]], sort_order: str = "unknown"
) -> str:
    """``@HD`` + one ``@SQ`` per (name, length) + ``@PG``, newline-joined
    (no trailing newline). Duplicate target names are emitted once."""
    lines = [f"@HD\tVN:1.6\tSO:{sort_order}"]
    seen = set()
    for name, length in targets:
        if name in seen:
            continue
        seen.add(name)
        lines.append(f"@SQ\tSN:{name}\tLN:{int(length)}")
    lines.append("@PG\tID:swtpu\tPN:swtpu")
    return "\n".join(lines)


def sam_record(
    qname: str,
    rname: str,
    query: np.ndarray,
    target: np.ndarray,
    score: int,
    path: Sequence[Tuple[int, int]],
    alphabet: str = "dna",
    query_len: Optional[int] = None,
    mapq: int = 255,
    flag: int = 0,
) -> str:
    """One SAM line for an alignment path of ``alphabet`` ("dna" or
    "protein") codes.

    ``query``/``target`` are the unpadded code arrays the path was walked
    on (``query_len`` defaults to ``len(query)``); ``path[0]`` is the
    anchor cell before the first aligned column. An empty alignment
    (< 2 cells) becomes an unmapped record (FLAG 4, ``*`` CIGAR). Tags:
    ``AS:i`` = engine score, ``NM:i`` = mismatches + inserted + deleted
    chars.
    """
    qlen = int(query_len) if query_len is not None else int(len(query))
    seq = _decode(np.asarray(query)[:qlen], alphabet)
    path = [(int(i), int(j)) for i, j in path]
    if len(path) < 2:
        # unmapped, but keep orientation bits so SEQ's strand stays
        # represented: 4 | flag
        return "\t".join(
            [
                qname, str(4 | int(flag)), "*", "0", "0", "*", "*", "0",
                "0", seq or "*", "*",
            ]
        )
    cigar = path_to_cigar(path, query, target, query_len=qlen)
    st = cigar_stats(cigar)
    nm = st["mismatches"] + st["insertions"] + st["deletions"]
    pos = path[0][1] + 1  # 1-based first aligned target column
    return "\t".join(
        [
            qname,
            str(int(flag)),
            rname,
            str(pos),
            str(int(mapq)),
            cigar,
            "*",
            "0",
            "0",
            seq or "*",
            "*",
            f"AS:i:{int(score)}",
            f"NM:i:{nm}",
        ]
    )
