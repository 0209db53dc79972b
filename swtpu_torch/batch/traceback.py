"""Local alignment with traceback: device endpoints, host walk.

Port of ``swtpu/batch/traceback.py::sw_align_batch``. The device computes
every pair's score and argmax endpoint in one batched call; the host then
walks each path with the numpy oracles (diag → up → left tie-break,
first maximum in row-major order), bounded by the device endpoint. A C++
host walker is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.oracle.affine import sw_affine_traceback
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
