"""All-vs-all top-k database search (BASELINE config 5) on one card.

Port of ``swtpu/parallel/search.py``'s single-device search
(``SearchCheckpoint``, the chunk step, the resident step, the fused
sweep, ``_retry_or_raise`` and ``all_vs_all_topk``). Queries are held on
the device; the target database goes through in chunks. Each chunk is
scored against every query by ``best_engine`` (the row-scan, affine or
profile kernel on the card, the plain tier on the CPU), reduced to its
top-k and merged into the running [Nq, k] state, all on the device.

The order is (score desc, target id asc), the JAX package's rule, where
``lax.top_k`` prefers the lower index and the merge is two stable sorts.
``torch.topk`` promises no order among equal values on CUDA, so the
state holds one int64 key a hit, ``score << 32 | (INT32_MAX - id)``:
keys are distinct for distinct ids, so the top-k of the keys is the
(score desc, id asc) order whatever ``topk`` does with ties. Pad targets
past the database end keep score -1 and id INT32_MAX, the sentinels.

Modes, bit-identical to each other: streaming (each chunk uploaded
behind the previous chunk's compute, from two pinned staging buffers on
a copy stream, each refilled only once an event says its last copy is
done), the packed 2-bit wire (DNA, packed on the host by the C++
``native.pack_2bit`` and decoded on the device by ``kernels/unpack.py``),
the resident database (uploaded once a call, chunks sliced on the
device) and the fused sweep: with no checkpoint and ``max_retries=0``
nothing needs the state on the host mid-sweep, so the loop queues every
chunk's step with no host sync until the final fetch (the JAX package
compiles this sweep as one ``lax.scan``). ``"auto"`` takes streaming raw
for both flags: on the H100 a raw chunk's upload hides behind the
previous chunk's compute, and the packed and resident walls measured
slower (PERF.md section 5).

Nothing is cached between calls: each call packs and uploads the
database it is given, so an in-place change to the database is searched
afresh. The JAX package caches the packed and the resident database on
the held reference alone and serves the earlier hits after such a
change; keying a cache on content costs a hash of the database, which
measured more than packing it in C++ or uploading it (PERF.md).

Failure recovery is the JAX package's: the host syncs every
``sync_every`` chunks (and at the end), a fault replays the window from
the last sync point's state up to ``max_retries`` times, ``checkpoint``
saves (cursor, scores, ids) at sync points in the JAX package's ``.npz``
layout (either package resumes the other's file), and a TypeError,
ValueError or NotImplementedError before the first clean step is a
deterministic error and raises at once. A CUDA fault that poisons the
context cannot be helped by a replay; it fails again up to the retry
limit and raises.

``sharded_all_vs_all_topk`` is the search over a mesh: the database
split over the ranks, one engine call a rank on its shard, each shard's
top-k by the same key, the candidates all-gathered and merged on every
rank. ``init_distributed`` (from ``parallel/mesh.py``) joins the world.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.unpack import unpack_2bit_device
from swtpu_torch.parallel.mesh import (  # noqa: F401  (init_distributed: JAX's home)
    all_gather_rows,
    init_distributed,
    mesh_rank,
)
from swtpu_torch.utils.device import resolve_device

_ID_SENTINEL = np.iinfo(np.int32).max


@dataclasses.dataclass
class SearchCheckpoint:
    """Cursor + partial results, persisted at sync points (``.npz``:
    ``cursor``, ``scores``, ``ids``)."""

    path: str

    def load(self):
        if not os.path.exists(self.path):
            return None
        z = np.load(self.path)
        return dict(cursor=int(z["cursor"]), scores=z["scores"], ids=z["ids"])

    def save(self, cursor: int, scores: np.ndarray, ids: np.ndarray):
        # explicit .npz temp name: np.savez appends .npz only when the
        # name lacks it, which silently changes the file being written
        tmp = self.path + ".tmp.npz"
        np.savez(tmp, cursor=cursor, scores=scores, ids=ids)
        os.replace(tmp, self.path)


def to_keys(scores, ids) -> torch.Tensor:
    """int64 keys ``score << 32 | (INT32_MAX - id)`` of (score, id)
    tensors: descending keys are (score desc, id asc)."""
    return (scores.long() << 32) | (_ID_SENTINEL - ids.long())


def from_keys(keys: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """(scores int32, ids int32) numpy arrays of a key tensor."""
    keys = keys.cpu()
    scores = (keys >> 32).to(torch.int32)
    ids = (_ID_SENTINEL - (keys & 0xFFFFFFFF)).to(torch.int32)
    return scores.numpy(), ids.numpy()


class _Step:
    """One chunk: score C targets against every query, take the chunk's
    top-kk and merge it into the running [Nq, k] keys. ``chunk`` is the
    [C, m] codes (packed: [C, ceil(m / 4)] bytes), or with ``resident``
    the whole padded database, sliced here at ``c0``."""

    def __init__(self, engine, Nq, n, C, m, k, kk, Nt, packed, resident, dev):
        self.engine, self.dev = engine, dev
        self.Nq, self.n, self.C, self.m, self.k, self.kk, self.Nt = Nq, n, C, m, k, kk, Nt
        self.packed, self.resident = packed, resident
        self.offsets = torch.arange(C, dtype=torch.int64, device=dev)

    def __call__(self, qs_dev, chunk, state, c0: int) -> torch.Tensor:
        Nq, n, C, m = self.Nq, self.n, self.C, self.m
        if self.resident:
            chunk = chunk[c0 : c0 + C]
        if self.packed:
            chunk = unpack_2bit_device(chunk, self.dev)[:, :m]
        qq = qs_dev[:, None, :].expand(Nq, C, n).reshape(-1, n)
        tt = chunk[None, :, :].expand(Nq, C, m).reshape(-1, m)
        scores = torch.as_tensor(self.engine(qq, tt), device=self.dev)
        ids = c0 + self.offsets
        valid = ids < self.Nt
        s = torch.where(valid[None, :], scores.reshape(Nq, C).long(), -1)
        low = torch.where(valid, _ID_SENTINEL - ids, 0)  # the id sentinel
        cand = torch.topk((s << 32) | low[None, :], self.kk, dim=1).values
        return torch.topk(torch.cat([state, cand], dim=1), self.k, dim=1).values


class _Uploader:
    """Chunks of ``rows`` rows to the device, a short tail filled with
    rows of the pad. On the card: two pinned staging buffers used in turn,
    copied on a copy stream; a buffer is refilled only once the event of
    its last copy has completed, and each chunk carries the event its
    step waits on. On the CPU: the chunk itself."""

    def __init__(self, rows: int, cols: int, dev: torch.device):
        self.rows, self.dev, self.slot = rows, dev, 0
        if dev.type == "cuda":
            self.bufs = [torch.empty((rows, cols), dtype=torch.uint8, pin_memory=True)
                         for _ in range(2)]
            self.copied = [None, None]
            self.stream = torch.cuda.Stream(dev)

    def put(self, chunk: np.ndarray, pad: int):
        """(tensor on the device, event to wait on or None)."""
        if self.dev.type != "cuda":
            out = np.full((self.rows, chunk.shape[1]), pad, np.uint8)
            out[: len(chunk)] = chunk
            return torch.from_numpy(out), None
        k, self.slot = self.slot, self.slot ^ 1
        if self.copied[k] is not None:
            self.copied[k].synchronize()
        host = self.bufs[k].numpy()
        host[: len(chunk)] = chunk
        host[len(chunk):] = pad
        with torch.cuda.stream(self.stream):
            out = self.bufs[k].to(self.dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.copied[k] = ev
        out.record_stream(torch.cuda.current_stream(self.dev))
        return out, ev


def _retry_or_raise(e, attempt, max_retries, cursor, log):
    """Log a chunk failure; re-raise once retries are exhausted, otherwise
    sleep with exponential backoff and return (caller loops)."""
    if log is not None:
        log(json.dumps(dict(
            event="search_chunk_retry", cursor=cursor, attempt=attempt,
            error=f"{type(e).__name__}: {e}"[:500],
        )))
    if attempt == max_retries:
        raise
    time.sleep(0.5 * (2**attempt))  # simple backoff


def _sync(dev: torch.device):
    """Wait for the device's queued work (a runtime fault surfaces here)."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _packed_db(targets: np.ndarray) -> np.ndarray:
    """The 2-bit wire of the database, [Nt, ceil(m / 4)] (C++ pack)."""
    from swtpu_torch import native

    Nt, m = targets.shape
    m4 = -(-m // 4) * 4
    tp = targets
    if m4 != m:
        tp = np.concatenate([tp, np.zeros((Nt, m4 - m), tp.dtype)], axis=1)
    return native.pack_2bit(tp).reshape(Nt, m4 // 4)


def _resident_db(staged: np.ndarray, C: int, pad: int,
                 dev: torch.device) -> torch.Tensor:
    """The (packed) database on the device, padded to whole chunks."""
    Nt = staged.shape[0]
    db = torch.empty((-(-Nt // C) * C, staged.shape[1]), dtype=torch.uint8, device=dev)
    db[:Nt] = torch.from_numpy(np.ascontiguousarray(staged)).to(dev)
    db[Nt:] = pad
    return db


def all_vs_all_topk(
    queries: np.ndarray,
    targets: np.ndarray,
    params: ScoringParams,
    k: int = 10,
    chunk_size: int = 1024,
    engine: Optional[Callable] = None,
    checkpoint: Optional[SearchCheckpoint] = None,
    max_retries: int = 2,
    sync_every: int = 16,
    log: Optional[Callable[[str], None]] = None,
    packed: str | bool = "auto",
    resident: str | bool = "auto",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k target hits per query over the database, on ``device`` (the
    card unless the caller passes ``device="cpu"``).

    queries: [Nq, n] uint8, targets: [Nt, m] uint8 numpy codes. Returns
    (scores [Nq, k] int32, target ids [Nq, k] int32), ordered score desc,
    id asc; a query with fewer than k targets fills with (-1, INT32_MAX).
    ``engine``: fn(qs, ts) -> [B] scores on [B, n] / [B, m] uint8 tensors
    on the device (default ``best_engine(params, device)``).

    ``packed``: ship the chunks as the 2-bit wire, decoded on the device
    (DNA codes 0-3 only). ``resident``: upload the (packed) database once
    and slice chunks on the device. ``"auto"``: neither (module note).
    ``sync_every``, ``max_retries`` and ``checkpoint``: the windowed
    replay and the cursor file (module note); with no checkpoint and
    ``max_retries=0`` the whole sweep is queued with no host sync (the
    fused sweep).
    """
    from swtpu_torch.ops.variants import resolve_engine

    dev = resolve_device(device)
    engine, _ = resolve_engine(params, engine, dev)
    queries = np.asarray(queries)
    targets = np.asarray(targets)
    Nq, Nt = queries.shape[0], targets.shape[0]
    n, m = queries.shape[1], targets.shape[1]
    packed = packed != "auto" and bool(packed)
    resident = resident != "auto" and bool(resident)
    if packed and targets.size and (params.alphabet_size != 4 or int(targets.max()) >= 4):
        raise ValueError("packed=True needs 2-bit-encodable targets (DNA codes 0-3)")
    staged = _packed_db(targets) if packed else targets
    best_s = np.full((Nq, k), -1, np.int32)
    best_i = np.full((Nq, k), _ID_SENTINEL, np.int32)
    start = 0
    if checkpoint is not None:
        state = checkpoint.load()
        if state is not None:
            start = state["cursor"]
            best_s, best_i = state["scores"], state["ids"]

    C = chunk_size
    kk = min(k, C)
    pad = 0 if packed else params.alphabet_size + 1
    step = _Step(engine, Nq, n, C, m, k, kk, Nt, packed, resident, dev)
    queries_dev = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    state = to_keys(torch.from_numpy(np.asarray(best_s)),
                    torch.from_numpy(np.asarray(best_i))).to(dev)
    if resident:
        db_dev = _resident_db(staged, C, pad, dev)
    else:
        uploader = _Uploader(C, staged.shape[1], dev)
    # with no checkpoint and no retries nothing needs the state on the
    # host mid-sweep: every step is queued behind the last (the fused sweep)
    sync = checkpoint is not None or max_retries > 0

    def padded(c0):
        if resident:
            return db_dev, None  # the step slices the chunk at c0
        # the tail chunk is padded so every step has C rows; pad rows are
        # masked out by id (>= Nt) inside the step
        return uploader.put(staged[c0 : c0 + C], pad)

    c_list = list(range(start, Nt, C))
    snap = (state, 0)  # replay point: (state, chunk index)
    step_succeeded = False  # True after the first clean execution
    attempt = 0
    i = 0
    staged_chunk = padded(c_list[0]) if c_list else None
    while i < len(c_list):
        c0 = c_list[i]
        t0 = time.perf_counter()
        try:
            cur, ready = staged_chunk
            if i + 1 < len(c_list):
                staged_chunk = padded(c_list[i + 1])  # upload rides behind compute
            if ready is not None:
                torch.cuda.current_stream(dev).wait_event(ready)
            state = step(queries_dev, cur, state, c0)
            step_succeeded = True
            at_sync = sync and (i + 1 - snap[1] >= sync_every or i + 1 == len(c_list))
            if at_sync:
                _sync(dev)
                snap = (state, i + 1)
                attempt = 0
                if checkpoint is not None:
                    checkpoint.save(c0 + C, *from_keys(state))
            if log is not None:
                log(json.dumps(dict(
                    event="search_chunk", cursor=c0, chunk=min(C, Nt - c0),
                    wall_ms=round((time.perf_counter() - t0) * 1e3, 1),
                    pairs=Nq * min(C, Nt - c0),
                )))
            i += 1
        except (TypeError, ValueError, NotImplementedError) as e:
            # before a clean step these are deterministic shape / config
            # errors: replaying cannot help; after one they may carry
            # runtime faults and replay like any other
            if not step_succeeded:
                raise
            _retry_or_raise(e, attempt, max_retries, c0, log)
            attempt += 1
            state, i = snap
            staged_chunk = padded(c_list[i])
        except Exception as e:  # runtime, device and transport faults
            _retry_or_raise(e, attempt, max_retries, c0, log)
            attempt += 1
            state, i = snap
            staged_chunk = padded(c_list[i])
    return from_keys(state)


def sharded_all_vs_all_topk(queries: np.ndarray, targets: np.ndarray,
                            params: ScoringParams, mesh, k: int = 10,
                            axis: str = "pairs", engine: Optional[Callable] = None,
                            device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k hits per query with the database split over ``mesh``'s axis
    (every rank passes the whole query set and database, as JAX's single
    controller does).

    The database is padded to the shard grid with the pad code
    ``alphabet_size + 1``. Each rank scores its shard against every query
    in one engine call (``best_engine(params)`` on ``device``, the card
    by default, or ``engine``), keeps its top ``min(k, shard)`` by the int64 key (the
    order of JAX's ``lax.top_k``: the lower id first among equal scores),
    and the candidates of every shard are all-gathered. Pad hits become
    (-1, INT32_MAX), the merge is JAX's ``lexsort((id, -score))``, and a
    query with fewer than k candidates is padded with them. Every rank
    returns the same (scores [Nq, k] int32, ids [Nq, k] int32)."""
    from swtpu_torch.ops.variants import resolve_engine

    dev = resolve_device(device)
    r, D = mesh_rank(mesh, axis)
    engine, _ = resolve_engine(params, engine, dev)
    queries, targets = np.asarray(queries), np.asarray(targets)
    (Nq, n), (Nt, m) = queries.shape, targets.shape
    shard = -(-Nt // D)
    kk = min(k, shard)
    mine = np.full((shard, m), params.alphabet_size + 1, targets.dtype)
    part = targets[r * shard:(r + 1) * shard]
    mine[:len(part)] = part
    qs = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    ts = torch.from_numpy(mine).to(dev)
    qq = qs[:, None, :].expand(Nq, shard, n).reshape(-1, n)
    tt = ts[None, :, :].expand(Nq, shard, m).reshape(-1, m)
    scores = torch.as_tensor(engine(qq, tt), device=dev).reshape(Nq, shard)
    ids = r * shard + torch.arange(shard, dtype=torch.int64, device=dev)
    cand = torch.topk(to_keys(scores, ids[None, :]), kk, dim=1).values
    gs, gi = from_keys(all_gather_rows(cand, mesh).permute(1, 0, 2).reshape(Nq, -1))
    gs, gi = gs.astype(np.int64), gi.astype(np.int64)
    pad_hit = gi >= Nt
    gs[pad_hit] = -1
    gi[pad_hit] = _ID_SENTINEL
    order = np.lexsort((gi, -gs), axis=1)[:, :k]
    out_s = np.take_along_axis(gs, order, axis=1)
    out_i = np.take_along_axis(gi, order, axis=1)
    if out_s.shape[1] < k:  # fewer gathered candidates than k
        padw = k - out_s.shape[1]
        out_s = np.pad(out_s, ((0, 0), (0, padw)), constant_values=-1)
        out_i = np.pad(out_i, ((0, 0), (0, padw)), constant_values=_ID_SENTINEL)
    return out_s.astype(np.int32), out_i.astype(np.int32)
