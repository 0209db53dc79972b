"""Fixed-band (static diagonal band) Smith-Waterman oracle.

Copy of ``swtpu/oracle/banded_static.py`` (numpy only): the contract of
the fixed-band kernel (``kernels/sw_banded.py``) and the host walker of
``batch.traceback.banded_static_align_batch``.

BASELINE configs 1-2 prescribe a *fixed* band ("batch of 1M random pairs
at the same fixed band") alongside the adaptive X-drop family
(source.cpp:1836-2725, which moves its band per round). The fixed-band
contract: local alignment restricted to the diagonal corridor
|i - j| <= W (W = half-bandwidth; the corridor is 2W+1 cells wide) —
cells outside the corridor are dead and contribute nothing. This is the
standard production geometry for similar-length pairs (read extension),
and it maps onto the batch row-scan restricted to the corridor
(``csrc/sw_banded.cu``).
"""

from __future__ import annotations

import numpy as np

from swtpu_torch.core.scoring import ScoringParams

NEG = -(2**29)


def sw_banded_static_score(
    q: np.ndarray, t: np.ndarray, params: ScoringParams, bandwidth: int = 32
) -> int:
    """Exact scalar fixed-band local-alignment score (|i - j| <= W)."""
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    S = params.matrix.astype(np.int64)
    W = int(bandwidth)
    n, m = len(q), len(t)
    affine = not params.is_linear
    go, ge = int(params.gap_open), int(params.gap_extend)
    H = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    H[0, : W + 1] = 0
    for i in range(1, n + 1):
        H[i, max(0, i - W) : min(m, i + W) + 1] = 0
    best = 0
    for i in range(1, n + 1):
        for j in range(max(1, i - W), min(m, i + W) + 1):
            if affine:
                E[i, j] = max(E[i, j - 1] - ge, H[i, j - 1] - go)
                F[i, j] = max(F[i - 1, j] - ge, H[i - 1, j] - go)
                v = max(0, H[i - 1, j - 1] + S[q[i - 1], t[j - 1]],
                        E[i, j], F[i, j])
            else:
                g = int(params.gap)
                v = max(
                    0,
                    H[i - 1, j - 1] + S[q[i - 1], t[j - 1]],
                    H[i - 1, j] - g,
                    H[i, j - 1] - g,
                )
            H[i, j] = v
            if v > best:
                best = int(v)
    return best


def sw_banded_static_traceback(
    q: np.ndarray, t: np.ndarray, params: ScoringParams, bandwidth: int = 32
):
    """Fixed-band local alignment with traceback: (score, [(i, j), ...]).

    Same corridor contract as sw_banded_static_score; start cell = first
    maximum in row-major scan order, moves prefer diag -> up -> left
    (linear) / diag -> F -> E (affine), path ends where H reaches 0.
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    S = params.matrix.astype(np.int64)
    W = int(bandwidth)
    n, m = len(q), len(t)
    affine = not params.is_linear
    go, ge = int(params.gap_open), int(params.gap_extend)
    H = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    E = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    F = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    H[0, : W + 1] = 0
    for i in range(1, n + 1):
        H[i, max(0, i - W) : min(m, i + W) + 1] = 0
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        for j in range(max(1, i - W), min(m, i + W) + 1):
            s = int(S[q[i - 1], t[j - 1]])
            if affine:
                E[i, j] = max(E[i, j - 1] - ge, H[i, j - 1] - go)
                F[i, j] = max(F[i - 1, j] - ge, H[i - 1, j] - go)
                v = max(0, H[i - 1, j - 1] + s, E[i, j], F[i, j])
            else:
                g = int(params.gap)
                v = max(
                    0,
                    H[i - 1, j - 1] + s,
                    H[i - 1, j] - g,
                    H[i, j - 1] - g,
                )
            H[i, j] = v
            if v > best:
                best, bi, bj = int(v), i, j
    path = [(bi, bj)]
    i, j, st = bi, bj, 0
    while i or j:
        if st == 0:
            v = H[i, j]
            if v == 0:
                break
            s = int(S[q[i - 1], t[j - 1]]) if (i and j) else 0
            if i and j and H[i - 1, j - 1] > NEG // 2 and v == H[i - 1, j - 1] + s:
                i, j = i - 1, j - 1
                path.append((i, j))
            elif affine and v == F[i, j]:
                st = 2
            elif affine and v == E[i, j]:
                st = 1
            elif not affine and i and v == H[i - 1, j] - int(params.gap):
                i -= 1
                path.append((i, j))
            elif not affine and j and v == H[i, j - 1] - int(params.gap):
                j -= 1
                path.append((i, j))
            else:  # pragma: no cover
                raise AssertionError("inconsistent fixed-band traceback H")
        elif st == 1:
            v = E[i, j]
            if j and v == H[i, j - 1] - go:
                j -= 1
                st = 0
            elif j and v == E[i, j - 1] - ge:
                j -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent fixed-band traceback E")
            path.append((i, j))
        else:
            v = F[i, j]
            if i and v == H[i - 1, j] - go:
                i -= 1
                st = 0
            elif i and v == F[i - 1, j] - ge:
                i -= 1
            else:  # pragma: no cover
                raise AssertionError("inconsistent fixed-band traceback F")
            path.append((i, j))
    path.reverse()
    return best, path


def sw_banded_static_score_batch(
    qs: np.ndarray, ts: np.ndarray, params: ScoringParams, bandwidth: int = 32
) -> np.ndarray:
    """Batch of fixed-band scores (loop over the scalar oracle)."""
    qs = np.atleast_2d(np.asarray(qs))
    ts = np.atleast_2d(np.asarray(ts))
    return np.array(
        [
            sw_banded_static_score(q, t, params, bandwidth)
            for q, t in zip(qs, ts)
        ],
        dtype=np.int64,
    )
