"""Long-pair alignment on one card: one huge DP matrix swept in tiles.

Port of ``swtpu/parallel/longpair.py`` at one device. The JAX package
splits a single Smith-Waterman matrix into query strips over a mesh
(strip d on device d) and target column blocks, and passes each strip's
bottom boundary row to the next device. Here the strips run in turn on
one card, and inside a strip the column blocks run left to right: tile
(strip d, block b) takes the bottom row of tile (d - 1, b) as its top
row, the right column of tile (d, b - 1) as its left column, and the
last element of tile (d - 1, b - 1)'s bottom row as its corner (all 0 on
the matrix's own edges). Tiles compose exactly, so the score and the
endpoint are those of the whole matrix whatever the block. The sharded
sweeps (ROADMAP.md queue A item 12b) are not ported: a mesh of more than
one device raises.

Each tile runs ``kernels/longpair_strip.py``: the CUDA strip tile
(``csrc/sw_strip.cu``) or its plain column-scan tile (``_tile_colscan``,
``_tile_colscan_affine``, bit-equal to JAX's XLA tiles). ``block=None``
sweeps the whole target as one block: at one device JAX's
``_auto_block`` picks that block too (its step count (nb + D - 1) *
(R + Lt / nb) is least at nb = 1 when D = 1); its divisor search and
the merge of per-device endpoints come with the sharded sweeps.

``engine``: ``"auto"`` runs the CUDA strip tile on the card and the
plain tile on the CPU; ``"pallas"`` (the JAX name of the strip-tile
engine) runs the CUDA tile and raises on the CPU; ``"xla"`` runs the
plain tile and raises on the card. The sweep's state (boundary rows and
columns, the running best) stays in device tensors; only the final
(best, end_i, end_j) comes back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

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
from swtpu_torch.utils.device import resolve_device


def _mesh_devices(mesh) -> int:
    """Devices of ``mesh``: None is one device; an int counts itself; an
    object with ``devices`` (a JAX-style mesh) or a sequence its size."""
    if mesh is None:
        return 1
    if isinstance(mesh, (int, np.integer)):
        return int(mesh)
    devices = getattr(mesh, "devices", mesh)
    return int(np.asarray(devices, dtype=object).size)


def _check_one_device(mesh):
    n_dev = _mesh_devices(mesh)
    if n_dev != 1:
        raise NotImplementedError(
            f"long pairs run on one card; a mesh of {n_dev} devices needs the "
            "sharded sweeps (ROADMAP.md queue A item 12b)"
        )


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


def _run_longpair(q, t, params: ScoringParams, mesh=None, axis="sp", block=None,
                  engine="auto", device=None):
    """The one-device sweep: a [3] int32 tensor (best, end_i, end_j) on
    the device it ran on. ``block=None`` is one block of the whole
    target; as in JAX, columns past the last whole block are not swept."""
    _check_one_device(mesh)
    dev = resolve_device(device, like=q)
    engine = _resolve_engine(engine, dev)
    Lq, Lt = len(q), len(t)
    if Lq == 0 or Lt == 0:
        raise ValueError(f"long pair of {Lq} x {Lt}: both lengths must be > 0")
    C = Lt if block is None else int(block)
    if not 1 <= C <= Lt:
        raise ValueError(f"block {C} outside 1..len(t) = {Lt}")
    n_blocks = Lt // C
    affine = not params.is_linear
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
    prev, prev_f = None, None  # the previous strip's bottom rows (H, F)
    for i0 in range(0, Lq, STRIP_ROWS):
        R = min(STRIP_ROWS, Lq - i0)
        q_strip = q[i0:i0 + R]
        row = torch.empty((n_blocks * C,), **i32)
        row_f = torch.empty((n_blocks * C,), **i32) if affine else None
        lext = torch.zeros((R + 1,), **i32)
        lext_e = torch.full((R + 1,), NEGB, **i32)
        for b in range(n_blocks):
            cols = slice(b * C, (b + 1) * C)
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
            # global endpoint, row-major-first across the tiles
            gi = i0 + tbi
            gj = b * C + tbj
            upd = (tile_best > best) | (
                (tile_best == best) & ((gi < gbi) | ((gi == gbi) & (gj < gbj))))
            best = torch.where(upd, tile_best, best)
            gbi = torch.where(upd, gi, gbi)
            gbj = torch.where(upd, gj, gbj)
        prev, prev_f = row, row_f
    pos = best > 0
    nil = torch.zeros((), **i32)
    return torch.stack([best, torch.where(pos, gbi, nil),
                        torch.where(pos, gbj, nil)])


def longpair_sw_score(q, t, params: ScoringParams, mesh=None, axis: str = "sp",
                      block: int = None, engine: str = "auto", device=None) -> int:
    """Local-alignment score of ONE long pair (any substitution matrix,
    linear or affine gaps) on one device (default: the card). len(t)
    should divide by ``block``; columns past the last whole block are not
    swept, as in JAX. ``mesh``: None or one device."""
    return longpair_sw_ends(q, t, params, mesh, axis, block, engine, device)[0]


def longpair_sw_ends(q, t, params: ScoringParams, mesh=None, axis: str = "sp",
                     block: int = None, engine: str = "auto", device=None) -> tuple:
    """(score, end_i, end_j) of ONE long pair: the 1-based row-major-first
    argmax cell over the sweep's tiles (the batch ends engines'
    tie-break). Score 0 maps to (0, 0). The sweep's one host fetch."""
    return tuple(_run_longpair(q, t, params, mesh, axis, block, engine,
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
