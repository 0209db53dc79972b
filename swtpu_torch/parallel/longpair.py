"""Long-pair alignment: one huge DP matrix swept in tiles, its query
strips over a mesh.

Port of ``swtpu/parallel/longpair.py``. A single Smith-Waterman matrix
is split into query strips, one a rank of the mesh (Lq / D rows, strip d
on rank d), and target column blocks. Rank d sweeps its blocks left to
right: tile (d, b) takes the bottom row of tile (d - 1, b) as its top
row, received from rank d - 1, the right column of tile (d, b - 1) as
its left column, and the last element of the top row received for block
b - 1 as its corner (all 0 on the matrix's own edges); it sends its
bottom row to rank d + 1 (Gotoh: the stacked (H, F) rows). A strip
longer than ``STRIP_ROWS`` runs its sub-strips in turn on its rank, the
sub-strip below taking the one above's bottom rows. Tiles compose
exactly, so the score and the endpoint are those of the whole matrix
whatever the mesh and the block.

JAX runs the ranks in lockstep over n_blocks + D - 1 pipeline steps, a
``ppermute`` each; here each block's row goes point to point (``isend``
/ ``irecv``), so a rank waits only for the row it needs and skips the
empty steps. A world of one rank sends nothing and syncs with the host
once, at the end: the one-card sweep is this sweep's world-1 case. Each
rank tracks its tiles' argmax row-major first; the [3] rows (best,
end_i, end_j) are all-gathered and merged on every rank
(``_merge_device_ends``), so every rank returns the same result.

Each tile runs ``kernels/longpair_strip.py``: the CUDA strip tile
(``csrc/sw_strip.cu``) or its plain column-scan tile (``_tile_colscan``,
``_tile_colscan_affine``, bit-equal to JAX's XLA tiles). ``block=None``
takes ``_auto_block(Lq, Lt, D)``, JAX's XLA route's step-count-optimal
divisor of Lt (the whole target at one rank); the endpoints do not
depend on the block.

``mesh``: None (one device, no process group) or a ``DeviceMesh`` from
``swtpu_torch.parallel.make_mesh``. ``engine``: ``"auto"`` runs the CUDA
strip tile on the card and the plain tile on the CPU; ``"pallas"`` (the
JAX name of the strip-tile engine) runs the CUDA tile and raises on the
CPU; ``"xla"`` runs the plain tile and raises on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import longpair_strip as kls
from swtpu_torch.kernels import sw_profile
from swtpu_torch.kernels.longpair_strip import (
    _BIG,
    NEGB,
    STRIP_ROWS,
    _extended_table,
    _tile_colscan,
    _tile_colscan_affine,
    _vec,
)
from swtpu_torch.parallel.mesh import all_gather_rows, host_staged, mesh_rank
from swtpu_torch.utils.device import resolve_device


def _mesh_of(mesh, axis):
    """(this rank's strip, the mesh size) of ``mesh``: None is one device."""
    if mesh is None:
        return 0, 1
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be None or a torch DeviceMesh (swtpu_torch.parallel.make_mesh), "
            f"not {type(mesh).__module__}.{type(mesh).__name__}")
    return mesh_rank(mesh, axis)


def _resolve_engine(engine, dev):
    if engine == "auto":
        return "xla" if dev.type == "cpu" else "pallas"
    if engine == "pallas" and dev.type == "cpu":
        raise NotImplementedError(
            "engine='pallas' runs the CUDA strip tile (csrc/sw_strip.cu); on "
            "the CPU use engine='xla' or 'auto'"
        )
    if engine == "xla" and dev.type != "cpu":
        raise NotImplementedError(
            "engine='xla' is the plain tile and runs on the CPU only; on the "
            "card use engine='auto' or 'pallas'"
        )
    if engine not in ("pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}: auto, pallas or xla")
    return engine


class _Ring:
    """The sweep's rows between neighbouring strips, point to point: from
    rank r - 1, to rank r + 1, one message a block (tag = the block)."""

    def __init__(self, mesh, r: int, D: int, dev: torch.device):
        self.dev, self.host = dev, host_staged(dev)
        self.group = group = mesh.get_group()
        self.src = dist.get_global_rank(group, r - 1) if r > 0 else None
        self.dst = dist.get_global_rank(group, r + 1) if r + 1 < D else None
        self.sent = []

    def recv(self, shape, tag: int) -> torch.Tensor:
        buf = torch.empty(shape, dtype=torch.int32,
                          device="cpu" if self.host else self.dev)
        dist.irecv(buf, src=self.src, group=self.group, tag=tag).wait()
        return buf.to(self.dev)

    def send(self, x: torch.Tensor, tag: int):
        wire = x.cpu() if self.host else x.contiguous()
        self.sent.append((dist.isend(wire, dst=self.dst, group=self.group, tag=tag),
                          wire))

    def close(self):
        for work, _ in self.sent:
            work.wait()
        self.sent = []


def _run_longpair(q, t, params: ScoringParams, mesh=None, axis="sp", block=None,
                  engine="auto", device=None):
    """The sweep: a [D, 3] int32 tensor, each rank's (best, end_i, end_j)
    row in rank order, on this rank's device (JAX's ``_run_longpair``).
    Each rank passes the whole pair and sweeps its own strip. As in JAX,
    columns past the last whole block are not swept."""
    r, D = _mesh_of(mesh, axis)
    dev = resolve_device(device, like=q)
    engine = _resolve_engine(engine, dev)
    Lq, Lt = len(q), len(t)
    if Lq == 0 or Lt == 0:
        raise ValueError(f"long pair of {Lq} x {Lt}: both lengths must be > 0")
    if Lq % D:
        raise ValueError(f"len(q) = {Lq} does not divide over a mesh of {D} devices")
    C = _auto_block(Lq, Lt, D) if block is None else int(block)
    if not 1 <= C <= Lt:
        raise ValueError(f"block {C} outside 1..len(t) = {Lt}")
    n_blocks = Lt // C
    affine = not params.is_linear
    R_rank = Lq // D
    row0 = r * R_rank  # this rank's strip
    q = q[row0:row0 + R_rank]
    if engine == "pallas":
        table = sw_profile.profile_table(params, dev)
        q, t = kls.stage_codes(q, params, dev), kls.stage_codes(t, params, dev)

        def tile(qs, ts, top, topf, lext, lext_e):
            if affine:
                return kls.tile_strip_affine(qs, ts, top, topf, lext, lext_e,
                                             params, table=table)
            return kls.tile_strip_linear(qs, ts, top, lext, params, table=table)
    else:
        q, t = _vec(q, dev, torch.int64), _vec(t, dev, torch.int64)
        table = torch.as_tensor(_extended_table(params), device=dev)
        n_codes = params.alphabet_size

        def tile(qs, ts, top, topf, lext, lext_e):
            if affine:
                return _tile_colscan_affine(
                    qs, ts, top, topf, lext[1:], lext_e[1:], lext[0], table,
                    n_codes, params.gap_open, params.gap_extend)
            return _tile_colscan(qs, ts, top, lext[1:], lext[0], table, n_codes,
                                 params.gap)

    i32 = dict(dtype=torch.int32, device=q.device)  # the staged codes' device
    best = torch.zeros((), **i32)
    gbi = torch.full((), _BIG, **i32)
    gbj = torch.full((), _BIG, **i32)
    zero_c = torch.zeros((C,), **i32)
    negb_c = torch.full((C,), NEGB, **i32)
    ring = _Ring(mesh, r, D, q.device) if D > 1 else None
    prev, prev_f = None, None  # the bottom rows (H, F) of the strip above
    for i0 in range(0, R_rank, STRIP_ROWS):
        R = min(STRIP_ROWS, R_rank - i0)
        q_strip = q[i0:i0 + R]
        receive = ring is not None and r > 0 and i0 == 0
        send = ring is not None and r + 1 < D and i0 + R == R_rank
        if receive:
            prev = torch.empty((n_blocks * C,), **i32)
            prev_f = torch.empty((n_blocks * C,), **i32) if affine else None
        row = torch.empty((n_blocks * C,), **i32)
        row_f = torch.empty((n_blocks * C,), **i32) if affine else None
        lext = torch.zeros((R + 1,), **i32)
        lext_e = torch.full((R + 1,), NEGB, **i32)
        for b in range(n_blocks):
            cols = slice(b * C, (b + 1) * C)
            if receive:
                got = ring.recv((2, C) if affine else (C,), b)
                if affine:
                    prev[cols], prev_f[cols] = got[0], got[1]
                else:
                    prev[cols] = got
            top = zero_c if prev is None else prev[cols]
            topf = None if not affine else (negb_c if prev is None else prev_f[cols])
            if prev is not None and b > 0:
                lext[0] = prev[b * C - 1]
            out = tile(q_strip, t[cols], top, topf, lext, lext_e)
            if affine:
                bot, bot_f, right, right_e, tile_best, tbi, tbj = out
                row_f[cols] = bot_f
                lext_e = torch.cat([lext_e[:1], right_e])
            else:
                bot, right, tile_best, tbi, tbj = out
            row[cols] = bot
            lext = torch.cat([lext[:1], right])
            if send:
                ring.send(torch.stack([bot, bot_f]) if affine else bot, b)
            # global endpoint, row-major-first across the tiles
            gi = row0 + i0 + tbi
            gj = b * C + tbj
            upd = (tile_best > best) | (
                (tile_best == best) & ((gi < gbi) | ((gi == gbi) & (gj < gbj))))
            best = torch.where(upd, tile_best, best)
            gbi = torch.where(upd, gi, gbi)
            gbj = torch.where(upd, gj, gbj)
        prev, prev_f = row, row_f
    if ring is not None:
        ring.close()
    pos = best > 0
    nil = torch.zeros((), **i32)
    mine = torch.stack([best, torch.where(pos, gbi, nil), torch.where(pos, gbj, nil)])
    return mine[None] if mesh is None else all_gather_rows(mine, mesh)


def _auto_block(Lq: int, Lt: int, n_dev: int, rows=None, cap=None) -> int:
    """Column-block width minimizing total anti-diagonal steps (JAX's).

    The sharded sweep runs (n_blocks + n_dev - 1) pipeline steps of one
    R x C tile each, and a tile costs R + C scan steps, so total scan
    steps = (nb + n_dev - 1) * (R + Lt / nb). One device wants nb = 1
    (one fat tile); n_dev devices trade per-step overhead against fill
    and drain. Only divisors of Lt are candidates (the sweep needs Lt %
    block == 0), and no block under 64 columns. ``rows`` / ``cap``: JAX's
    strip-tile route (a tile costs rows + C column steps, C <= cap)."""
    if n_dev == 1 and rows is None:
        # one device: the cost nb * R + Lt is least at nb = 1 (the whole
        # target), which the search below would return too
        return Lt
    R = rows if rows is not None else max(Lq // n_dev, 1)
    # divisors in O(sqrt(Lt)): an O(Lt) scan costs seconds of host time on
    # multi-megabase targets with sparse divisors
    divisors = set()
    d = 1
    while d * d <= Lt:
        if Lt % d == 0:
            divisors.add(d)
            divisors.add(Lt // d)
        d += 1

    def pick(use_cap):
        best_nb, best_cost = None, None
        for nb in sorted(divisors):
            if Lt // nb < 64:  # thinner blocks only add step overhead
                continue
            if use_cap and cap is not None and Lt // nb > cap:
                continue
            cost = (nb + n_dev - 1) * (R + Lt // nb)
            if best_cost is None or cost < best_cost:
                best_nb, best_cost = nb, cost
        return best_nb

    # no divisor passes (tiny target, or the cap excludes every one and
    # the capless retry fails too): one whole-target block
    best_nb = pick(True) or pick(False) or 1
    return Lt // best_nb


def _merge_device_ends(out) -> tuple:
    """Merge per-device (best, bi, bj) rows with the row-major-first rule
    (max value, then min row, then min column)."""
    rows = np.asarray(out).tolist()
    best = max(r[0] for r in rows)
    i, j = min((r[1], r[2]) for r in rows if r[0] == best)
    return best, i, j


def longpair_sw_score(q, t, params: ScoringParams, mesh=None, axis: str = "sp",
                      block: int = None, engine: str = "auto", device=None) -> int:
    """Local-alignment score of ONE long pair (any substitution matrix,
    linear or affine gaps), its query strips over ``mesh`` (None: one
    device; default device: the card). len(q) must divide by the mesh
    size; len(t) should divide by ``block``: columns past the last whole
    block are not swept, as in JAX. Every rank returns the same score."""
    return longpair_sw_ends(q, t, params, mesh, axis, block, engine, device)[0]


def longpair_sw_ends(q, t, params: ScoringParams, mesh=None, axis: str = "sp",
                     block: int = None, engine: str = "auto", device=None) -> tuple:
    """(score, end_i, end_j) of ONE long pair: the 1-based row-major-first
    argmax cell over the sweep's tiles (the batch ends engines'
    tie-break), merged over the ranks' rows. Score 0 maps to (0, 0). The
    sweep's one host fetch."""
    return _merge_device_ends(_run_longpair(q, t, params, mesh, axis, block, engine,
                                            device).tolist())


def longpair_sw_align(q, t, params: ScoringParams, mesh=None, axis: str = "sp",
                      block: int = None, row_block: int = 512,
                      engine: str = "auto", device=None):
    """Local alignment of ONE long pair with traceback: the device
    forward gives (score, end_i, end_j), then the low-memory host walk
    (``batch/lowmem.py``) walks the [0..end_i, 0..end_j] prefix. The
    device score checks the walk and the walk the device. The walk is the
    C++ low-memory walker, exact for any gap model. Returns (score, path)
    as ``oracle.sw.sw_traceback`` / ``oracle.affine.sw_affine_traceback``
    do."""
    from swtpu_torch.batch.lowmem import sw_traceback_lowmem

    score, ei, ej = longpair_sw_ends(q, t, params, mesh, axis=axis, block=block,
                                     engine=engine, device=device)
    if score == 0:
        return 0, [(0, 0)]
    q = np.asarray(q.cpu() if isinstance(q, torch.Tensor) else q)
    t = np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
    sc, path = sw_traceback_lowmem(q, t, params, row_block=row_block,
                                   ends=(ei, ej))
    assert sc == score and path[-1] == (ei, ej), (
        f"device/host mismatch: {score}@({ei},{ej}) vs {sc}@{path[-1]}"
    )
    return sc, path
