"""Greedy overlap-layout-consensus assembly.

Port of ``swtpu/models/assembly.py``:

1. **Overlap**: all-vs-all read scoring in one batched call (on the card
   ``ops.variants.best_engine``, the row-scan or profile kernels, rows
   1-4; on the CPU its plain tier), then exact suffix-prefix
   verification of the promising pairs with the C++ traceback walker: an
   overlap is a local alignment whose path ends at the suffix end of
   read A and starts at the prefix start of read B.
2. **Layout**: greedy chaining from a read that is nobody's good
   right-extension, following the best outgoing overlap.
3. **Consensus**: each next read spliced at its overlap offset; with
   ``slack`` a per-column majority vote.

A demo at the reference's intended scale, not a production assembler.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from swtpu_torch.core.scoring import DNA_111, ScoringParams


def make_reads(
    rng: np.random.Generator,
    genome: np.ndarray,
    read_len: int,
    step: int,
    shuffle: bool = True,
) -> List[np.ndarray]:
    """Tile a genome into overlapping reads (overlap = read_len - step)."""
    starts = list(range(0, len(genome) - read_len + 1, step))
    if starts[-1] != len(genome) - read_len:
        starts.append(len(genome) - read_len)  # cover the tail
    reads = [genome[i : i + read_len] for i in starts]
    if shuffle:
        order = rng.permutation(len(reads))
        reads = [reads[i] for i in order]
    return reads


def _ambig_safe(params: ScoringParams) -> ScoringParams:
    """The matrix with one more row/column for ambiguity codes (N = 4,
    one past the 4x4 DNA matrix, which the exact walkers would index out
    of bounds), scoring the matrix's worst entry against everything,
    itself included."""
    A = params.alphabet_size
    worst = int(params.matrix.min())
    m = np.full((A + 1, A + 1), worst, dtype=np.int32)
    m[:A, :A] = params.matrix
    return ScoringParams(m, params.gap_open, params.gap_extend)


def _overlap_coords(
    a: np.ndarray,
    b: np.ndarray,
    params: ScoringParams,
    min_overlap: int,
    slack: int = 0,
) -> int:
    """Offset of B's origin in A coordinates if A's suffix aligns to B's
    prefix, else 0.

    ``slack`` tolerates sequencing errors at the read ends: paths may end
    within ``slack`` of A's end and start within ``slack`` of B's start
    (exact suffix-prefix at the default 0)."""
    from swtpu_torch import native
    from swtpu_torch.oracle.sw import sw_traceback

    if native.available():
        score, path = native.sw_traceback(a, b, params.matrix, params.gap)
    else:
        score, path = sw_traceback(a, b, params)
    if len(path) < 2:
        return 0
    (i0, j0), (i1, j1) = path[0], path[-1]
    if i1 >= len(a) - slack and j0 <= slack and (i1 - i0) >= min_overlap:
        # anchored at the alignment END: B's last aligned char B[j1-1]
        # sits at A position i1-1, so B's origin is i1 - j1 in A
        # coordinates (an indel inside the overlap would shift a
        # start-anchored splice); at slack 0 this is len(a) - j1
        offset = i1 - j1
        return offset if 0 < offset < len(a) else 0
    return 0


def _screen_batch(reads: Sequence[np.ndarray]):
    """Every ordered pair (i, j), i != j, as one batch: queries padded
    with 4, targets with 5. Returns (batch_q, batch_t, pairs)."""
    n = len(reads)
    L = max(len(r) for r in reads)
    batch_q = np.full((n * (n - 1), L), 4, np.uint8)
    batch_t = np.full((n * (n - 1), L), 5, np.uint8)
    pairs = []
    row = 0
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            batch_q[row, : len(reads[i])] = reads[i]
            batch_t[row, : len(reads[j])] = reads[j]
            pairs.append((i, j))
            row += 1
    return batch_q, batch_t, pairs


def assemble_greedy(
    reads: Sequence[np.ndarray],
    params: ScoringParams = DNA_111,
    min_overlap: int = 20,
    engine=None,
    slack: int = 0,
    device=None,
) -> np.ndarray:
    """Assemble reads into one contig (greedy OLC). Returns the contig.

    ``engine(q, t)`` scores the screening batch (default
    ``best_engine(params, device)``: the kernels on the card, the plain
    tier on the CPU). ``slack > 0`` turns on error tolerance: overlap
    endpoints may miss the read ends by up to ``slack`` and the consensus
    is a per-column majority vote over all chained reads (a base from the
    earliest covering read is replaced only when strictly outvoted). With
    slack 0 the consensus is the exact splice."""
    n = len(reads)
    if n == 0:
        return np.zeros(0, np.uint8)
    if n == 1:
        return np.asarray(reads[0])

    if engine is None:
        from swtpu_torch.ops.variants import best_engine

        engine = best_engine(params, device)

    # screening: score every ordered pair (A suffix vs B prefix is a local
    # alignment, so plain SW scores upper-bound the overlap)
    batch_q, batch_t, pairs = _screen_batch(reads)
    scores = np.asarray(torch.as_tensor(engine(batch_q, batch_t)).cpu())

    # with errors allowed inside the overlap, require most (not all) of
    # min_overlap columns to be matches before exact verification
    thresh = (min_overlap - 2 * slack) * int(np.diag(params.matrix).min())
    best_next: dict = {}
    has_pred: set = set()
    # exact verification of promising pairs, best overlap per source read;
    # ambiguity codes clip to the extended never-match row
    vparams = _ambig_safe(params)
    A = params.alphabet_size
    vreads = [np.minimum(np.asarray(r), A).astype(np.uint8) for r in reads]
    order = np.argsort(-scores)
    for idx in order:
        if scores[idx] < thresh:
            break
        i, j = pairs[idx]
        if i in best_next:
            continue
        off = _overlap_coords(vreads[i], vreads[j], vparams, min_overlap, slack)
        if off > 0:
            best_next[i] = (j, off)
            has_pred.add(j)

    # layout: start from a read with no predecessor, chain offsets
    starts = [i for i in range(n) if i not in has_pred]
    start = starts[0] if starts else 0
    chain = [(start, 0)]  # (read index, contig offset)
    used = {start}
    cur, cur_off = start, 0
    while cur in best_next:
        nxt, off = best_next[cur]
        if nxt in used:
            break
        cur_off += off
        chain.append((nxt, cur_off))
        used.add(nxt)
        cur = nxt

    # consensus: first covering read's base, replaced only when strictly
    # outvoted by the per-column majority over all chained reads;
    # ambiguity codes (> 3) never vote
    total = max(off + len(reads[r]) for r, off in chain)
    base = np.full(total, 255, np.uint8)
    counts = np.zeros((total, 4), np.int32)
    for r, off in chain:
        seg = np.asarray(reads[r], np.uint8)
        cols = np.arange(off, off + len(seg))
        real = seg <= 3
        np.add.at(counts, (cols[real], seg[real].astype(np.int64)), 1)
        unwritten = base[cols] == 255
        base[cols[unwritten]] = seg[unwritten]
    maj = counts.argmax(axis=1).astype(np.uint8)
    maj_cnt = counts.max(axis=1)
    base_real = base <= 3
    base_cnt = np.where(
        base_real, counts[np.arange(total), np.minimum(base, 3).astype(np.int64)], 0,
    )
    return np.where(maj_cnt > base_cnt, maj, base).astype(np.uint8)
