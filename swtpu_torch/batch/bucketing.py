"""Variable-length batches: length-sorted, shape-quantised dispatch.

Port of ``swtpu/batch/bucketing.py``. Pairs arrive padded to the batch's
widest sequence, with per-pair lengths. The host ships raw bytes
(optionally in the 2-bit wire format) and the lengths; the device decodes
them, applies the pad codes past each length and runs the engine, in one
unit per (engine, shape) (``_fused_masked_engine``). When the quantised
query lengths spread wide (the longest over twice the median), pairs are
sorted by query length and split into at most ``max_buckets`` contiguous
groups, each padded to a shape quantum (``Q_QUANT`` x ``T_QUANT``), so
that the same shapes reach the engine as in the JAX package. Pad codes
only lose, so padding never changes a score.

The pad codes default to DNA's 4 (query) and 5 (target). They are real
residues in protein (C, Q): protein callers pass ``q_pad=24,
t_pad=25`` (``core.protein.PROTEIN_Q_PAD`` / ``PROTEIN_T_PAD``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.unpack import unpack_2bit_device
from swtpu_torch.ops.variants import cached_build, resolve_engine
from swtpu_torch.utils.device import resolve_device

Q_PAD = 4
T_PAD = 5

#: shape quanta: bucket dims round up to these, so similar length mixes
#: reach the engine at the same shapes
Q_QUANT = 32
T_QUANT = 64


def bucket_edges(max_len: int, min_edge: int = 32, factor: float = 1.5):
    """Geometric bucket edges up to max_len."""
    edges = [min_edge]
    while edges[-1] < max_len:
        edges.append(
            min(int(np.ceil(edges[-1] * factor)), max_len)
        )
    return edges


_FUSED_MASK_CACHE: dict = {}


def _fused_masked_engine(engine, engine_key, n, m, q_pad, t_pad,
                         packed=False):
    """fn(qs, ts, lq, lt) on device tensors: decode (``packed``: 2-bit
    wire, [B, n / 4] and [B, m / 4] uint8), pads past each length, then
    the engine; PyTorch ops around the engine's kernel. Cached per
    (engine, shape)."""
    key = ("varlen_mask", engine_key, n, m, q_pad, t_pad, packed)

    def build():
        def run(qs, ts, lq, lt):
            dev = qs.device
            if packed:
                qs = unpack_2bit_device(qs, dev)[:, :n]
                ts = unpack_2bit_device(ts, dev)[:, :m]
            qm = torch.where(
                torch.arange(n, device=dev)[None, :] < lq[:, None], qs,
                torch.tensor(q_pad, dtype=torch.uint8, device=dev),
            )
            tm = torch.where(
                torch.arange(m, device=dev)[None, :] < lt[:, None], ts,
                torch.tensor(t_pad, dtype=torch.uint8, device=dev),
            )
            return engine(qm, tm)

        return run

    return cached_build(_FUSED_MASK_CACHE, key, build)


def _upload(arrays, dev):
    """Host arrays as tensors on ``dev``."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def sw_scores_varlen(
    qs: np.ndarray,
    ts: np.ndarray,
    params: ScoringParams,
    lens_q: Optional[Sequence[int]] = None,
    lens_t: Optional[Sequence[int]] = None,
    engine: Optional[Callable] = None,
    max_buckets: int = 4,
    q_pad: int = Q_PAD,
    t_pad: int = T_PAD,
    packed: bool = False,
    stream_chunks: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Scores for a padded variable-length batch.

    qs: [B, n_max] uint8, ts: [B, m_max] uint8 on the host, with per-pair
    lengths (default: full width). Pad codes are applied on ``device``
    (default: the card); the engine is ``best_engine(params, device)``
    unless given (on the card a kernel, never the plain tier). When the
    quantised length spread is wide (> 2x), pairs are sorted by query
    length and dispatched in at most ``max_buckets`` contiguous groups;
    otherwise one dispatch handles everything. Returns [B] int32 scores
    in input order.

    ``packed=True`` takes DNA in the 2-bit wire format instead ([B,
    ceil(n/4)] uint8, e.g. straight from a ``pack`` .npz): the device
    decodes it (``kernels/unpack.py``), so 4x fewer bytes cross the link.

    ``stream_chunks`` splits a one-dispatch batch into that many chunks,
    each uploaded and run in turn on the current stream, their scores
    joined on the device and fetched once. ``None`` means one chunk, the
    fastest on the card. The scores are the same for any value.
    """
    qs = np.asarray(qs, dtype=np.uint8)
    ts = np.asarray(ts, dtype=np.uint8)
    dev = resolve_device(device)
    B = qs.shape[0]
    n = qs.shape[1] * 4 if packed else qs.shape[1]
    m = ts.shape[1] * 4 if packed else ts.shape[1]
    lq = np.full(B, n, np.int32) if lens_q is None else np.asarray(
        lens_q, np.int32
    )
    lt = np.full(B, m, np.int32) if lens_t is None else np.asarray(
        lens_t, np.int32
    )
    engine, engine_key = resolve_engine(params, engine, dev)

    def quant(x, q):
        return int(-(-int(x) // q) * q)

    nq_max = quant(max(int(lq.max()), 1), Q_QUANT)
    nq_med = quant(max(int(np.median(lq)), 1), Q_QUANT)
    nb = max(1, min(max_buckets, B // 4096))
    if nq_max <= 2 * nq_med:
        nb = 1
    div = 4 if packed else 1
    if nb == 1:
        bn = min(n, nq_max)
        bm = min(m, quant(max(int(lt.max()), 1), T_QUANT))
        fn = _fused_masked_engine(
            engine, engine_key, bn, bm, q_pad, t_pad, packed
        )
        qv, tv = qs[:, : bn // div], ts[:, : bm // div]
        sc = max(1, min(stream_chunks or 1, B))
        cut = [B * i // sc for i in range(sc + 1)]
        out = torch.cat([
            fn(*_upload((qv[lo:hi], tv[lo:hi], lq[lo:hi], lt[lo:hi]), dev))
            for lo, hi in zip(cut[:-1], cut[1:])
        ])
        return out.cpu().numpy().astype(np.int32)

    # wide spread: sort by query length once (contiguous buckets),
    # dispatch every bucket without synchronising, fetch at the end
    order = np.argsort(lq, kind="stable")
    qs_s = np.ascontiguousarray(qs[order])
    ts_s = np.ascontiguousarray(ts[order])
    lq_s, lt_s = lq[order], lt[order]
    splits = [B * i // nb for i in range(nb + 1)]
    pending = []
    for lo, hi in zip(splits[:-1], splits[1:]):
        if lo == hi:
            continue
        bn = min(n, quant(max(int(lq_s[hi - 1]), 1), Q_QUANT))
        bm = min(m, quant(max(int(lt_s[lo:hi].max()), 1), T_QUANT))
        fn = _fused_masked_engine(
            engine, engine_key, bn, bm, q_pad, t_pad, packed
        )
        pending.append((lo, hi, fn(*_upload((
            qs_s[lo:hi, : bn // div], ts_s[lo:hi, : bm // div],
            lq_s[lo:hi], lt_s[lo:hi],
        ), dev))))
    out = np.zeros(B, np.int32)
    for lo, hi, res in pending:
        out[order[lo:hi]] = res.cpu().numpy()
    return out


def sw_scores_bucketed(
    pairs: Sequence,
    params: ScoringParams,
    engine: Optional[Callable] = None,
    max_buckets: int = 4,
    device=None,
) -> np.ndarray:
    """Scores for a list of (q, t) variable-length pairs (input order).

    Convenience wrapper over :func:`sw_scores_varlen` for list-of-arrays
    input; the array API avoids the per-pair assembly cost.
    """
    n_max = max(len(q) for q, _ in pairs)
    m_max = max(len(t) for _, t in pairs)
    qs = np.full((len(pairs), n_max), Q_PAD, np.uint8)
    ts = np.full((len(pairs), m_max), T_PAD, np.uint8)
    lq = np.empty(len(pairs), np.int64)
    lt = np.empty(len(pairs), np.int64)
    for i, (q, t) in enumerate(pairs):
        qs[i, : len(q)] = q
        ts[i, : len(t)] = t
        lq[i], lt[i] = len(q), len(t)
    return sw_scores_varlen(
        qs, ts, params, lq, lt, engine=engine, max_buckets=max_buckets,
        device=device,
    )
