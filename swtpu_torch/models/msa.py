"""Center-star multiple sequence alignment on the batched NW kernels.

Port of ``swtpu/models/msa.py`` (Gusfield's center-star construction, a
2-approximation of the optimal sum-of-pairs MSA):

1. score all sequence pairs with the global forward pass (one batched
   call, corner scores only): on the card the semi-global kernel
   pinned at each pair's corner (``kernels/semiglobal_batch.py``, row 8,
   for a uniform DNA matrix; ``kernels/semiglobal_profile.py``, row 9,
   for any other), on the CPU its plain version;
2. pick the center = the sequence with the maximum total similarity;
3. globally align every other sequence to the center with
   :func:`swtpu_torch.batch.nw_align_batch` (the same kernels, host walk);
4. merge the pairwise paths under "once a gap, always a gap": each
   center gap-slot is widened to the maximum insertion any pair puts
   there, insertions left-justified within their slot.

Rows are int arrays over the input alphabet with ``GAP`` (-1) for gap
columns; :func:`msa_rows_to_strings` renders them with '-'.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from swtpu_torch.core.scoring import ScoringParams

__all__ = [
    "GAP",
    "MsaResult",
    "msa_center_star",
    "msa_rows_to_strings",
    "sp_score",
]

#: Gap sentinel in MSA rows (rows are int64; alphabets are uint8).
GAP = -1


@dataclasses.dataclass
class MsaResult:
    """A multiple alignment.

    Attributes:
      rows: one int array per input sequence (input order), all the same
        length; entries are alphabet codes or :data:`GAP`.
      center: index of the center sequence.
      scores: [N] pairwise NW score of each sequence vs the center
        (``scores[center]`` is the center's self-alignment score).
      sp: sum-of-pairs score of the final MSA under the linear-gap
        column scoring (None when scoring is affine).
    """

    rows: List[np.ndarray]
    center: int
    scores: np.ndarray
    sp: Optional[int]


def _pad_batch(seqs: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    out = np.zeros((len(seqs), int(lens.max())), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lens


def _is_uniform(matrix: np.ndarray) -> bool:
    diag = np.diag(matrix)
    off = matrix[~np.eye(matrix.shape[0], dtype=bool)]
    return bool(np.all(diag == diag[0]) and np.all(off == off[0]))


def _uniform_dna(params: ScoringParams) -> bool:
    return params.alphabet_size == 4 and _is_uniform(params.matrix)


def _nw_scores_vs(
    seqs: Sequence[np.ndarray],
    other: Sequence[np.ndarray],
    params: ScoringParams,
    device=None,
) -> np.ndarray:
    """NW corner scores for pairs (seqs[k], other[k]): the pinned
    semi-global kernel (row 8 uniform, row 9 any other matrix) on the
    card, its plain version on the CPU."""
    from swtpu_torch.kernels.semiglobal_batch import semiglobal_batch
    from swtpu_torch.kernels.semiglobal_profile import semiglobal_profile

    qs, lq = _pad_batch(seqs)
    ts, lt = _pad_batch(other)
    if _uniform_dna(params):
        match = int(params.matrix[0, 0])
        mismatch = -int(params.matrix[0, 1])
        gaps = (dict(gap=params.gap) if params.is_linear else
                dict(gap_open=params.gap_open, gap_extend=params.gap_extend))
        fwd = semiglobal_batch(qs, ts, match, mismatch, lens_q=lq, lens_t=lt,
                               pin_end=True, device=device, **gaps)
    else:
        fwd = semiglobal_profile(qs, ts, params, lens_q=lq, lens_t=lt, pin_end=True,
                                 device=device)
    return fwd[0].cpu().numpy()


def _choose_center(
    seqs: Sequence[np.ndarray], params: ScoringParams, device=None
) -> Tuple[int, np.ndarray]:
    """argmax_k sum_j NW(k, j); ties broken by lowest index.

    Returns (center, totals). One batched call over the N(N-1)/2
    unordered pairs."""
    n = len(seqs)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    if not pairs:
        return 0, np.zeros(1, dtype=np.int64)
    qs = [seqs[i] for i, _ in pairs]
    ts = [seqs[j] for _, j in pairs]
    s = _nw_scores_vs(qs, ts, params, device).astype(np.int64)
    totals = np.zeros(n, dtype=np.int64)
    ii = np.array([i for i, _ in pairs])
    jj = np.array([j for _, j in pairs])
    np.add.at(totals, ii, s)
    np.add.at(totals, jj, s)
    return int(np.argmax(totals)), totals


def _path_profile(
    path: Sequence[Tuple[int, int]], lc: int
) -> Tuple[List[List[int]], np.ndarray]:
    """Decompose a (query=seq, target=center) NW path into center
    coordinates: per-slot inserted query indices (slot j = between center
    chars j and j+1; slot 0 = before the first) and the query index
    aligned to each center char (-1 = deletion)."""
    slots: List[List[int]] = [[] for _ in range(lc + 1)]
    char_at = np.full(lc, GAP, dtype=np.int64)
    for (i0, j0), (i1, j1) in zip(path, path[1:]):
        di, dj = i1 - i0, j1 - j0
        if di == 1 and dj == 1:
            char_at[j1 - 1] = i1 - 1
        elif di == 1 and dj == 0:
            slots[j0].append(i1 - 1)
        # di == 0, dj == 1: center char j1-1 aligned to a gap
    return slots, char_at


def msa_center_star(
    seqs: Sequence[np.ndarray],
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    params: Optional[ScoringParams] = None,
    center: Optional[int] = None,
    device=None,
) -> MsaResult:
    """Center-star MSA of ``seqs`` (list of alphabet-code arrays).

    Scoring mirrors the pairwise API: uniform (match, mismatch-penalty,
    gap-penalty) DNA by default, ``gap_open``/``gap_extend`` for affine
    (Gotoh), or ``params`` for a general matrix (protein/BLOSUM62).
    ``center`` overrides step 2. Runs on ``device`` (default: the card).
    """
    from swtpu_torch.batch import nw_align_batch
    from swtpu_torch.core.scoring import dna_matrix
    from swtpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    seqs = [np.asarray(s, dtype=np.uint8) for s in seqs]
    if not seqs or any(len(s) == 0 for s in seqs):
        raise ValueError("msa needs >= 1 non-empty sequences")
    if params is None:
        mat = dna_matrix(match, -mismatch)
        if gap_open is not None:
            params = ScoringParams(mat, gap_open=gap_open, gap_extend=gap_extend)
        else:
            params = ScoringParams.linear(mat, gap)
    n = len(seqs)
    if n == 1:
        row = seqs[0].astype(np.int64)
        return MsaResult([row], 0, np.zeros(1, dtype=np.int64), _sp([row], params))

    if center is None:
        center, _ = _choose_center(seqs, params, dev)
    c = seqs[center]
    others = [k for k in range(n) if k != center]

    qs, lq = _pad_batch([seqs[k] for k in others])
    ts, lt = _pad_batch([c] * len(others))
    kwargs = dict(params=None, lens_q=lq, lens_t=lt, device=dev)
    if _uniform_dna(params):
        m0 = int(params.matrix[0, 0])
        x0 = -int(params.matrix[0, 1])
        if params.is_linear:
            aligned = nw_align_batch(qs, ts, m0, x0, params.gap, **kwargs)
        else:
            aligned = nw_align_batch(
                qs, ts, m0, x0, gap_open=params.gap_open,
                gap_extend=params.gap_extend, **kwargs,
            )
    else:
        kwargs["params"] = params
        aligned = nw_align_batch(qs, ts, **kwargs)

    lc = len(c)
    profiles = [_path_profile(path, lc) for _, path in aligned]
    ins = np.zeros(lc + 1, dtype=np.int64)
    for slots, _ in profiles:
        ins = np.maximum(ins, [len(s) for s in slots])

    # center row: each slot's insertions render as gaps
    def build_center() -> np.ndarray:
        out: List[int] = []
        for j in range(lc):
            out.extend([GAP] * int(ins[j]))
            out.append(int(c[j]))
        out.extend([GAP] * int(ins[lc]))
        return np.array(out, dtype=np.int64)

    def build_row(k: int, slots: List[List[int]], char_at: np.ndarray) -> np.ndarray:
        s = seqs[k]
        out: List[int] = []
        for j in range(lc + 1):
            got = [int(s[i]) for i in slots[j]]
            out.extend(got + [GAP] * (int(ins[j]) - len(got)))
            if j < lc:
                ci = char_at[j]
                out.append(int(s[ci]) if ci != GAP else GAP)
        return np.array(out, dtype=np.int64)

    rows: List[Optional[np.ndarray]] = [None] * n
    rows[center] = build_center()
    for k, (slots, char_at) in zip(others, profiles):
        rows[k] = build_row(k, slots, char_at)
    width = {len(r) for r in rows}
    assert len(width) == 1, f"ragged MSA rows: {sorted(width)}"

    scores = np.zeros(n, dtype=np.int64)
    for k, (sc, _) in zip(others, aligned):
        scores[k] = sc
    scores[center] = _nw_scores_vs([c], [c], params, dev)[0]
    return MsaResult(list(rows), center, scores, _sp(rows, params))


def _sp(rows: Sequence[np.ndarray], params: ScoringParams) -> Optional[int]:
    return sp_score(rows, params) if params.is_linear else None


def sp_score(rows: Sequence[np.ndarray], params: ScoringParams) -> int:
    """Sum-of-pairs score of an MSA under linear-gap column scoring:
    char/char pairs score matrix[a, b], char/gap pairs score -gap,
    gap/gap pairs score 0 (the standard SP convention)."""
    if not params.is_linear:
        raise ValueError("sp_score is defined for linear gap scoring")
    mat = params.matrix.astype(np.int64)
    g = int(params.gap)
    total = 0
    n = len(rows)
    for a in range(n):
        ra = rows[a]
        for b in range(a + 1, n):
            rb = rows[b]
            both = (ra != GAP) & (rb != GAP)
            one = (ra != GAP) ^ (rb != GAP)
            total += int(mat[ra[both], rb[both]].sum()) - g * int(one.sum())
    return total


def msa_rows_to_strings(
    rows: Sequence[np.ndarray], alphabet: str = "dna"
) -> List[str]:
    """Render MSA rows as strings with '-' for gaps."""
    if alphabet == "protein":
        from swtpu_torch.core.protein import PROTEIN_ALPHABET as letters
    else:
        letters = "ACGT"
    return [
        "".join("-" if int(x) == GAP else letters[int(x)] for x in r)
        for r in rows
    ]
