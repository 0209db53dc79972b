"""Alignment with traceback: device endpoints, host walk.

Port of ``swtpu/batch/traceback.py``'s ``sw_align_batch`` (local),
``semiglobal_align_batch``, ``nw_align_batch`` and
``_semiglobal_align_batch_general`` (semi-global and global). The device
computes every pair's score and endpoint in one batched call; the host
then walks each path with the numpy oracles (diag → up → left tie-break,
first maximum in row-major order). A C++ host walker is later work
(ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.semiglobal_batch import semiglobal_batch
from swtpu_torch.kernels.semiglobal_profile import semiglobal_profile
from swtpu_torch.kernels.semiglobal_scan import gaps
from swtpu_torch.oracle.affine import sw_affine_traceback
from swtpu_torch.oracle.semiglobal import semiglobal_affine_full, semiglobal_full
from swtpu_torch.oracle.sw import sw_traceback


def sw_align_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    params: ScoringParams,
    device=None,
) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Batched local alignment with traceback: [(score, path)] per pair.

    ``best_ends_engine(params, device)`` gives every pair's score and
    endpoint (on the card by default); each walk then recomputes only the
    [0..end_i, 0..end_j] prefix. The walker's score must equal the device
    score, and its path must end at the device endpoint.
    """
    from swtpu_torch.ops.variants import best_ends_engine

    qs = np.asarray(qs)
    ts = np.asarray(ts)
    engine = best_ends_engine(params, device)
    scores, end_i, end_j = (x.cpu().numpy() for x in engine(qs, ts))
    if params.is_linear:
        walker = lambda q, t: sw_traceback(q, t, params)  # noqa: E731
    else:
        walker = lambda q, t: sw_affine_traceback(q, t, params)  # noqa: E731
    out = []
    for b in range(qs.shape[0]):
        # the device argmax (ei, ej) is the row-major-first max, so the DP
        # over the [0..ei, 0..ej] prefix has its own row-major-first argmax
        # AT (ei, ej) and an identical path — the walker recomputes only
        # ei*ej cells instead of n*m.
        bi, bj = int(end_i[b]), int(end_j[b])
        sc, path = walker(qs[b][:bi], ts[b][:bj])
        assert path[-1] == (bi, bj) or sc == 0, (
            f"device/host endpoint mismatch at pair {b}: "
            f"({bi},{bj}) vs {path[-1]}"
        )
        assert sc == scores[b], (
            f"device/host score mismatch at pair {b}: {scores[b]} vs {sc}"
        )
        out.append((sc, path))
    return out


def _lengths(qs, ts, lens_q, lens_t):
    """(varlen, lq, lt): per-pair lengths as numpy arrays."""
    B, n = qs.shape
    m = ts.shape[1]
    varlen = lens_q is not None or lens_t is not None
    lq = np.full(B, n) if lens_q is None else np.asarray(lens_q)
    lt = np.full(B, m) if lens_t is None else np.asarray(lens_t)
    return varlen, lq, lt


def _walk(qs, ts, fwd, lq, lt, pin_end, go, ge, affine, **scores):
    """Walk every pair on its real lengths with the oracle copy
    (``scores``: match/mismatch or matrix); the walk's score must equal
    the device score and its path end at the device endpoint."""
    score, ei, ej = (x.cpu().numpy() for x in fwd)
    out = []
    for b in range(qs.shape[0]):
        q, t = qs[b, : lq[b]], ts[b, : lt[b]]
        end = (len(q), len(t)) if pin_end else None
        if affine:
            sc, path = semiglobal_affine_full(q, t, gap_open=go, gap_extend=ge,
                                              endpoint=end, **scores)
        else:
            sc, path = semiglobal_full(q, t, gap=go, endpoint=end, **scores)
        assert sc == score[b] and path[-1] == (ei[b], ej[b]), (
            f"device/host semiglobal mismatch at pair {b}: "
            f"{score[b]}@({ei[b]},{ej[b]}) vs {sc}@{path[-1]}"
        )
        out.append((sc, path))
    return out


def semiglobal_align_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    params: Optional[ScoringParams] = None,
    lens_q: Optional[Sequence[int]] = None,
    lens_t: Optional[Sequence[int]] = None,
    pin_end: bool = False,
    device=None,
) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Batched semi-global alignment with traceback (full matrix),
    linear or affine (gap_open != gap_extend) gaps: [(score, path)].

    ``semiglobal_batch`` computes every pair's score and endpoint (on the
    card by default, the plain tier with ``device="cpu"``); the host walks
    each path on the pair's real lengths. Passing ``params`` selects the
    general-substitution-matrix mode (DNA 4x4 or protein/BLOSUM62,
    ``semiglobal_profile``; match/mismatch/gap are then ignored).
    ``lens_q`` / ``lens_t`` give per-pair real lengths. ``pin_end`` pins
    every endpoint at each pair's (lq, lt) corner — GLOBAL
    (Needleman-Wunsch) alignment; see nw_align_batch.
    """
    qs = np.asarray(qs)
    ts = np.asarray(ts)
    if params is not None:
        return _semiglobal_align_batch_general(
            qs, ts, params, lens_q=lens_q, lens_t=lens_t, pin_end=pin_end,
            device=device,
        )
    varlen, lq, lt = _lengths(qs, ts, lens_q, lens_t)
    fwd = semiglobal_batch(
        qs, ts, match, mismatch, gap, gap_open=gap_open, gap_extend=gap_extend,
        lens_q=lq if varlen else None, lens_t=lt if varlen else None,
        pin_end=pin_end, device=device,
    )
    # gap_open == gap_extend is linear, as in the kernels
    return _walk(qs, ts, fwd, lq, lt, pin_end, *gaps(gap, gap_open, gap_extend),
                 match=match, mismatch=mismatch)


def nw_align_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    params: Optional[ScoringParams] = None,
    lens_q: Optional[Sequence[int]] = None,
    lens_t: Optional[Sequence[int]] = None,
    device=None,
) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Batched GLOBAL (Needleman-Wunsch) alignment with traceback: the
    semi-global forward pass and host walk with the endpoint pinned at
    each pair's (lq, lt) corner instead of the argmax. Same argument
    surface as semiglobal_align_batch; matches oracle nw_full /
    nw_affine_full (tie-breaks included)."""
    return semiglobal_align_batch(
        qs, ts, match, mismatch, gap, gap_open=gap_open,
        gap_extend=gap_extend, params=params, lens_q=lens_q,
        lens_t=lens_t, pin_end=True, device=device,
    )


def _semiglobal_align_batch_general(
    qs: np.ndarray,
    ts: np.ndarray,
    params: ScoringParams,
    lens_q: Optional[Sequence[int]] = None,
    lens_t: Optional[Sequence[int]] = None,
    pin_end: bool = False,
    device=None,
) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """General-matrix semi-global with traceback: device forward on the
    profile form of the semi-global kernel (the table tier on the CPU),
    matrix-scored host walk."""
    varlen, lq, lt = _lengths(qs, ts, lens_q, lens_t)
    fwd = semiglobal_profile(
        qs, ts, params, lens_q=lq if varlen else None,
        lens_t=lt if varlen else None, pin_end=pin_end, device=device,
    )
    return _walk(qs, ts, fwd, lq, lt, pin_end, params.gap_open,
                 params.gap_extend, not params.is_linear, matrix=params.matrix)
