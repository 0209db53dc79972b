"""Alignment with traceback: device endpoints, host walk.

Port of ``swtpu/batch/traceback.py``'s ``sw_align_batch`` (local),
``semiglobal_align_batch``, ``nw_align_batch`` and
``_semiglobal_align_batch_general`` (semi-global and global),
``banded_static_align_batch`` (fixed band) and the adaptive-banded
X-drop family (``banded_forward_batch``, ``banded_walk_batch``,
``banded_align_batch``, ``banded_traceback``, ``reconstruct_affine_bands``,
``banded_affine_traceback``). The device computes every pair's score and
endpoint (banded: its band history) in one batched call; the host then
walks each path (diag → up → left tie-break, first maximum in row-major
order) with the C++ walkers of ``swtpu_torch.native`` wherever the JAX
package uses its own, else with the numpy oracles (semi-global under
uniform Gotoh scoring, as in JAX); linear per-round pairs at
reference-scale geometry on the card walk on the card. With
``native.available`` replaced by a function that says False (a test's
monkeypatch) every site walks with the numpy oracles; the paths are the
same.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from swtpu_torch import native
from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.banded_batch import banded_batch
from swtpu_torch.kernels.banded_scan import (
    BandedBatchResult,
    banded_xdrop_align_device,
)
from swtpu_torch.kernels.semiglobal_batch import semiglobal_batch
from swtpu_torch.kernels.semiglobal_profile import semiglobal_profile
from swtpu_torch.kernels.semiglobal_scan import gaps
from swtpu_torch.kernels.sw_banded import (
    sw_banded_plain,
    sw_banded_profile,
    sw_banded_static,
)
from swtpu_torch.kernels.sw_batch import _uniform_match_mismatch
from swtpu_torch.oracle.affine import sw_affine_traceback
from swtpu_torch.oracle.banded_affine import EF_DEAD
from swtpu_torch.oracle.banded_static import sw_banded_static_traceback
from swtpu_torch.oracle.semiglobal import (
    MINUS_INF,
    semiglobal_affine_full,
    semiglobal_full,
)
from swtpu_torch.oracle.sw import sw_traceback
from swtpu_torch.utils.device import resolve_device


def sw_align_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    params: ScoringParams,
    device=None,
) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Batched local alignment with traceback: [(score, path)] per pair.

    ``best_ends_engine(params, device)`` gives every pair's score and
    endpoint (on the card by default); each walk (the C++ walker) then
    recomputes only the [0..end_i, 0..end_j] prefix. The walker's score
    must equal the device score, and its path must end at the device
    endpoint.
    """
    from swtpu_torch.ops.variants import best_ends_engine

    qs = np.asarray(qs)
    ts = np.asarray(ts)
    engine = best_ends_engine(params, device)
    scores, end_i, end_j = (x.cpu().numpy() for x in engine(qs, ts))
    use_native = native.available()
    if not params.is_linear:
        if use_native:
            walker = lambda q, t: native.sw_affine_traceback(  # noqa: E731
                q, t, params.matrix, params.gap_open, params.gap_extend)
        else:
            walker = lambda q, t: sw_affine_traceback(q, t, params)  # noqa: E731
    elif use_native:
        walker = lambda q, t: native.sw_traceback(  # noqa: E731
            q, t, params.matrix, params.gap)
    else:
        walker = lambda q, t: sw_traceback(q, t, params)  # noqa: E731
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


def _walker(pin_end, go, ge, affine, **scores):
    """(q, t) -> (score, path): the C++ walker where the JAX package uses
    one (linear gaps, and Gotoh under a matrix), else the oracle copy
    (``scores``: match/mismatch or matrix)."""
    matrix = scores.get("matrix")
    if native.available() and (matrix is not None or not affine):
        if affine:
            return lambda q, t: native.semiglobal_affine_traceback(
                q, t, matrix, go, ge, pin_end=pin_end)
        if matrix is not None:
            return lambda q, t: native.semiglobal_traceback_matrix(
                q, t, matrix, go, pin_end=pin_end)
        return lambda q, t: native.semiglobal_traceback(
            q, t, scores["match"], scores["mismatch"], go, pin_end=pin_end)

    def walk(q, t):
        end = (len(q), len(t)) if pin_end else None
        if affine:
            return semiglobal_affine_full(q, t, gap_open=go, gap_extend=ge,
                                          endpoint=end, **scores)
        return semiglobal_full(q, t, gap=go, endpoint=end, **scores)
    return walk


def _walk(qs, ts, fwd, lq, lt, pin_end, go, ge, affine, **scores):
    """Walk every pair on its real lengths (:func:`_walker`); the walk's
    score must equal the device score and its path end at the device
    endpoint."""
    score, ei, ej = (x.cpu().numpy() for x in fwd)
    walker = _walker(pin_end, go, ge, affine, **scores)
    out = []
    for b in range(qs.shape[0]):
        sc, path = walker(qs[b, : lq[b]], ts[b, : lt[b]])
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


def banded_traceback(
    q: np.ndarray,
    t: np.ndarray,
    band_history: np.ndarray,
    pos_y: np.ndarray,
    n_rounds: int,
    max_round: int,
    max_score_off: int,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    bandwidth: int = 32,
    matrix: Optional[np.ndarray] = None,
) -> List[Tuple[int, int]]:
    """Walk one alignment's path from its band history.

    Mirrors the reference's traceback over the stored band
    (source.cpp:1944-1973): Get(y, x) reconstructs a cell from
    (band_history, pos_y); dead/out-of-band cells read as -inf; the start
    cell is the top-right-most cell of the best round holding the max;
    moves tie-break diag → up → left. ``max_score_off`` is the
    offset-inclusive max (score + x_threshold).
    """
    n, m = len(q), len(t)
    W = bandwidth

    def get(y: int, x: int) -> int:
        if y < 0 or y > n or x < 0 or x > m:
            return MINUS_INF
        r = y + x
        if r >= n_rounds:
            return MINUS_INF
        k = (W - 1) - (y - pos_y[r])
        if k < 0 or k >= W:
            return MINUS_INF
        v = band_history[r, k]
        return MINUS_INF if v == 0 else int(v)

    my = int(pos_y[max_round])
    mx = int(max_round - my)  # unpadded x: y + x == round
    while get(my, mx) != max_score_off:
        my += 1
        mx -= 1
        # mirror the C++ twin's guard (swnative.cpp): inconsistent device
        # history must fail loudly, not hang the walker
        if my > n + W:
            raise AssertionError(
                "banded_traceback: max cell not found in band history "
                f"(round {max_round}, expected {max_score_off})")

    mat = None if matrix is None else np.asarray(matrix)

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
            i -= 1
        elif j and v == get(i, j - 1) - gap:
            j -= 1
        else:  # pragma: no cover
            raise AssertionError("inconsistent banded traceback")
        path.append((i, j))
    path.reverse()
    return path


def banded_static_scores(qs, ts, params: ScoringParams, bandwidth: int = 32,
                         device=None):
    """Fixed-band scores ([B] int32 tensor) on the engine of ``device``:
    on the card the fixed-band kernel, its uniform form for a uniform
    matrix and its profile form for any other (each raises
    NotImplementedError outside its guards); on the CPU the plain tier,
    for any scoring."""
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return sw_banded_plain(qs, ts, params, bandwidth, device=dev)
    fwd = (sw_banded_static if _uniform_match_mismatch(params) is not None
           else sw_banded_profile)
    return fwd(qs, ts, params, bandwidth, device=dev)


def banded_static_align_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    params: ScoringParams,
    bandwidth: int = 32,
    device=None,
) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Batched fixed-band alignment with traceback (|i - j| <= W).

    The device computes the scores (:func:`banded_static_scores`: the
    fixed-band kernel on the card, the plain tier with ``device="cpu"``);
    the host recomputes the corridor per pair to walk the path (the C++
    walker), whose score must equal the device's. Output bit-equal to
    ``oracle.banded_static.sw_banded_static_traceback``.
    """
    qs = np.asarray(qs)
    ts = np.asarray(ts)
    scores = banded_static_scores(qs, ts, params, bandwidth, device).cpu().numpy()
    if native.available():
        walker = lambda q, t: native.banded_static_traceback(  # noqa: E731
            q, t, params.matrix, params.gap_open, params.gap_extend, bandwidth)
    else:
        walker = lambda q, t: sw_banded_static_traceback(  # noqa: E731
            q, t, params, bandwidth)
    out = []
    for b in range(qs.shape[0]):
        sc, path = walker(qs[b], ts[b])
        assert sc == scores[b], (
            f"device/host score mismatch at pair {b}: {scores[b]} vs {sc}"
        )
        out.append((sc, path))
    return out


def reconstruct_affine_bands(
    band_history: np.ndarray,
    pos_y: np.ndarray,
    n_rounds: int,
    gap_open: int,
    gap_extend: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rebuild the Gotoh E/F band histories from the H band history.

    The E/F recurrences (oracle/banded_affine.py) depend only on the H
    band, the previous E/F bands, and the per-round direction — never on
    the substitution score — and the direction is recoverable from pos_y
    (a round moved down iff pos_y advanced). So the device kernels return
    the same H-only history as the linear family and the host replays E/F
    exactly, round by round: e[r]/f[r] here are bit-equal to the oracle's
    e_hist/f_hist (tested).
    """
    MINF = MINUS_INF
    W = band_history.shape[1]
    go, ge = int(gap_open), int(gap_extend)
    e_hist = np.full((n_rounds, W), EF_DEAD, dtype=np.int64)
    f_hist = np.full((n_rounds, W), EF_DEAD, dtype=np.int64)
    result = band_history[0].astype(np.int64)
    e_band = np.full(W, EF_DEAD, dtype=np.int64)
    f_band = np.full(W, EF_DEAD, dtype=np.int64)
    for r in range(1, n_rounds):
        if pos_y[r] == pos_y[r - 1]:  # moved right
            horizontal = result
            he = e_band
            vf = np.concatenate([f_band[1:], [EF_DEAD]])
            vertical = np.concatenate([result[1:], [0]])
        else:  # moved down
            vertical = result
            vf = f_band
            he = np.concatenate([[EF_DEAD], e_band[:-1]])
            horizontal = np.concatenate([[0], result[:-1]])
        e_new = np.maximum(
            np.where(he > EF_DEAD // 2, he - ge, MINF),
            np.where(horizontal != 0, horizontal - go, MINF),
        )
        f_new = np.maximum(
            np.where(vf > EF_DEAD // 2, vf - ge, MINF),
            np.where(vertical != 0, vertical - go, MINF),
        )
        result = band_history[r].astype(np.int64)
        e_band = np.where(result == 0, EF_DEAD, e_new)
        f_band = np.where(result == 0, EF_DEAD, f_new)
        e_hist[r] = e_band
        f_hist[r] = f_band
    return e_hist, f_hist


def banded_affine_traceback(
    q: np.ndarray,
    t: np.ndarray,
    band_history: np.ndarray,
    pos_y: np.ndarray,
    n_rounds: int,
    max_round: int,
    max_score_off: int,
    match: int,
    mismatch: int,
    gap_open: int,
    gap_extend: int,
    bandwidth: int = 32,
    matrix: Optional[np.ndarray] = None,
) -> List[Tuple[int, int]]:
    """Gotoh three-state walk over a device band history (affine gaps).

    E/F bands are reconstructed from the H history (see
    reconstruct_affine_bands); the walk itself mirrors the affine oracle:
    H-state move preference diag → F (up) → E (left), matching the linear
    family's diag → up → left order.
    """
    n, m = len(q), len(t)
    W = bandwidth
    e_hist, f_hist = reconstruct_affine_bands(
        band_history, pos_y, n_rounds, gap_open, gap_extend
    )

    def get(arr, y: int, x: int, dead_zero: bool) -> int:
        if y < 0 or y > n or x < 0 or x > m:
            return MINUS_INF
        r = y + x
        if r >= n_rounds:
            return MINUS_INF
        k = (W - 1) - (y - pos_y[r])
        if k < 0 or k >= W:
            return MINUS_INF
        v = int(arr[r, k])
        return MINUS_INF if (dead_zero and v == 0) else v

    get_h = lambda y, x: get(band_history, y, x, True)
    get_e = lambda y, x: get(e_hist, y, x, False)
    get_f = lambda y, x: get(f_hist, y, x, False)

    my = int(pos_y[max_round])
    mx = int(max_round - my)
    while get_h(my, mx) != max_score_off:
        my += 1
        mx -= 1
        if my > n + W:
            raise AssertionError(
                "banded_affine_traceback: max cell not found in band history "
                f"(round {max_round}, expected {max_score_off})")

    mat = None if matrix is None else np.asarray(matrix)
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
            elif v == get_f(i, j):
                st = 2
            elif v == get_e(i, j):
                st = 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine banded traceback H")
        elif st == 1:  # E: gap moves left
            v = get_e(i, j)
            if j and v == get_h(i, j - 1) - gap_open:
                j -= 1
                st = 0
            elif j and v == get_e(i, j - 1) - gap_extend:
                j -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine banded traceback E")
            path.append((i, j))
        else:  # F: gap moves up
            v = get_f(i, j)
            if i and v == get_h(i - 1, j) - gap_open:
                i -= 1
                st = 0
            elif i and v == get_f(i - 1, j) - gap_extend:
                i -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent affine banded traceback F")
            path.append((i, j))
    path.reverse()
    return path


def banded_forward_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    lens_q: Optional[Sequence[int]] = None,
    lens_t: Optional[Sequence[int]] = None,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    bandwidth: int = 32,
    x_threshold: int = 70,
    compress_history: Optional[bool] = None,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    matrix: Optional[np.ndarray] = None,
    device=None,
) -> BandedBatchResult:
    """Adaptive-banded X-drop forward pass, history included (the device
    half of banded_align_batch). Returns a BandedBatchResult of host
    arrays.

    On the card every bandwidth up to 128 runs the per-round warp kernel
    (``banded_batch``), W = 32 and 64 included, where JAX ran its packed
    kernel; from 129 to ``kernels.banded_batch.MAX_WIDTH`` (1024) the wide
    kernel (a CTA a pair), where JAX runs its XLA forward; a wider band
    raises NotImplementedError naming its ROADMAP.md item. The history
    streams to device memory at every geometry, so JAX's switch to its XLA
    forward past 6000 characters (a TPU VMEM limit) has no counterpart. On
    the CPU the plain tier runs.

    ``compress_history=None`` (default) auto-selects the reference's
    8-bit offset-rebias wire format (source.cpp:2105-2119) whenever the
    int32 history would exceed ~8 MB and x_threshold fits in a byte.
    """
    if compress_history is None:
        R_cap = (max(qs.shape[1], ts.shape[1]) + 1) * 2 - 1
        compress_history = (
            x_threshold <= 254
            and R_cap * qs.shape[0] * bandwidth * 4 > 8 * 2**20
        )
    return banded_batch(
        qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth, x_threshold,
        compress_history=compress_history, gap_open=gap_open,
        gap_extend=gap_extend, matrix=matrix, device=device,
    ).numpy()


def banded_walk_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    res,
    lens_q: Optional[Sequence[int]] = None,
    lens_t: Optional[Sequence[int]] = None,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    bandwidth: int = 32,
    x_threshold: int = 70,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    matrix: Optional[np.ndarray] = None,
) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Host half of banded_align_batch: walk every pair's path from a
    BandedBatchResult (the device forward's history) with the C++
    walkers (E/F rebuilt in C++ for Gotoh)."""
    if gap_open is not None and gap_open == gap_extend:
        gap, gap_open, gap_extend = gap_open, None, None
    res = res.numpy()
    B = qs.shape[0]
    lens_q = [qs.shape[1]] * B if lens_q is None else list(lens_q)
    lens_t = [ts.shape[1]] * B if lens_t is None else list(lens_t)
    use_native = native.available()
    if gap_open is not None:
        aff = native.banded_affine_traceback if use_native else banded_affine_traceback
        walker = lambda q, t, *a: aff(  # noqa: E731
            q, t, *a, match, mismatch, gap_open, gap_extend, bandwidth,
            matrix=matrix,
        )
    else:
        lin = native.banded_traceback if use_native else banded_traceback
        walker = lambda q, t, *a: lin(  # noqa: E731
            q, t, *a, match, mismatch, gap, bandwidth, matrix=matrix
        )
    out = []
    for b in range(B):
        path = walker(
            qs[b, : lens_q[b]],
            ts[b, : lens_t[b]],
            res.history_for(b),
            res.pos_y[:, b],
            int(res.n_rounds[b]),
            int(res.max_round[b]),
            int(res.score[b]) + x_threshold,
        )
        out.append((int(res.score[b]), path))
    return out


def banded_align_batch(
    qs: np.ndarray,
    ts: np.ndarray,
    lens_q: Optional[Sequence[int]] = None,
    lens_t: Optional[Sequence[int]] = None,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    bandwidth: int = 32,
    x_threshold: int = 70,
    compress_history: Optional[bool] = None,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    matrix: Optional[np.ndarray] = None,
    device=None,
) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Batched adaptive-banded X-drop alignment with traceback.

    Device forward pass (band history on the device, one anti-diagonal
    per round: :func:`banded_forward_batch`), host walk of each path from
    the history (:func:`banded_walk_batch`). Output per pair is
    bit-identical to ``oracle.banded_xdrop`` (linear gaps) /
    ``oracle.banded_affine.banded_affine_xdrop`` (gap_open !=
    gap_extend). ``matrix`` selects the general-substitution-matrix /
    protein mode (match/mismatch ignored). At reference-scale geometry on
    the card (linear gaps, n + m + 1 > 6000: JAX's rule for the TPU) the
    walk runs on the card too (``banded_scan.banded_xdrop_align_device``),
    so only scores and move strings cross to the host; the output is the
    same either way. Affine keeps the host walk (E/F reconstruction lives
    there).
    """
    qs = np.asarray(qs)
    ts = np.asarray(ts)
    if gap_open is not None and gap_open == gap_extend:
        gap, gap_open, gap_extend = gap_open, None, None
    if (gap_open is None and qs.shape[1] + ts.shape[1] + 1 > 6000
            and resolve_device(device).type == "cuda"):
        return banded_xdrop_align_device(
            qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth, x_threshold,
            matrix=matrix, device=device,
        )
    res = banded_forward_batch(
        qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth,
        x_threshold, compress_history=compress_history, gap_open=gap_open,
        gap_extend=gap_extend, matrix=matrix, device=device,
    )
    return banded_walk_batch(
        qs, ts, res, lens_q, lens_t, match, mismatch, gap, bandwidth,
        x_threshold, gap_open=gap_open, gap_extend=gap_extend,
        matrix=matrix,
    )
