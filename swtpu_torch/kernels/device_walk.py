"""Device traceback walkers: the CUDA kernels and their plain versions.

Port of the walks of ``swtpu/kernels/pallas/banded_block.py::
_block_fwd_walk_impl`` (the block tier) and ``swtpu/kernels/xla/
banded_scan.py::_banded_fwd_walk_impl`` (the per-round tier), which JAX
runs as XLA gathers so that only scores and move strings cross the host
link. The kernels are ``csrc/sw_walk.cu`` (one thread per pair); both write
the 2-bit move wire that ``banded_scan.decode_device_walk`` reads. Their
plain version is the host walk (the oracle copy's walker per pair) encoded
to the same wire: on a CPU tensor the wrappers run it, on a CUDA tensor
the kernel, never the plain version there. Each wrapper counts its
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from swtpu_torch.kernels import _build
from swtpu_torch.kernels.sw_banded import banded_table
from swtpu_torch.kernels.sw_batch import ptr

SOURCE = "sw_walk.cu"
CH = 64  # moves are padded to a multiple of this, as JAX's chunked walk does
_P, _I = ctypes.c_void_p, ctypes.c_int


def wire_steps(max_steps: int):
    """(moves a row holds, bytes a row takes) for paths of up to
    ``max_steps`` steps: 20 bytes of meta and 2 bits a move."""
    steps = -(-int(max_steps) // CH) * CH
    return steps, 20 + steps // 4


def encode_wire(walks, max_steps: int) -> np.ndarray:
    """The wire of host walks: ``walks`` is one (score, path) per pair, path
    from the origin to the start cell of the walk; [B, row_bytes] uint8."""
    steps, row_bytes = wire_steps(max_steps)
    out = np.empty((len(walks), row_bytes), np.uint8)
    for b, (score, path) in enumerate(walks):
        pts = np.asarray(path, dtype=np.int64).reshape(-1, 2)[::-1]  # start -> origin
        d = pts[:-1] - pts[1:]
        moves = np.full(steps, 3, np.uint8)
        moves[: len(d)] = np.where(d[:, 0] & d[:, 1], 0, np.where(d[:, 0], 1, 2))
        meta = np.array([score, pts[0, 0], pts[0, 1], len(d), 1], dtype="<i4")
        out[b, :20] = meta.view(np.uint8)
        out[b, 20:] = (moves.reshape(-1, 4) << np.arange(0, 8, 2, dtype=np.uint8)).sum(
            axis=1, dtype=np.uint8)
    return out


def _fn(name, argtypes):
    lib = _build.load(SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def block_walk_plain(run) -> torch.Tensor:
    """Plain version of :func:`block_walk`: ``walk_block_history`` per pair
    on the host copy of the forward's history, encoded to the wire."""
    from swtpu_torch.oracle.banded_block import walk_block_history

    h = lambda x: None if x is None else x.cpu().numpy()  # noqa: E731
    hist, bases = h(run.hist), h(run.bases)
    score, ey, ej, nr = (h(x) for x in (run.state[1] - run.X, run.state[2],
                                        run.state[3], run.n_rows))
    qs, ts = h(run.qT).T, h(run.t16)
    B, n, m = qs.shape[0], qs.shape[1], ts.shape[1]
    lq = np.full(B, n) if run.lens_q is None else h(run.lens_q)
    lt = np.full(B, m) if run.lens_t is None else h(run.lens_t)
    walks = []
    for p in range(B):
        rows = int(nr[p])
        rb = bases[np.arange(rows) // run.K, p] + np.arange(rows) % run.K
        path = walk_block_history(
            hist[:rows, :, p], rb, (int(ey[p]), int(ej[p])), qs[p, : lq[p]],
            ts[p, : lt[p]], match=run.match, mismatch=run.mismatch, gap=run.gap,
            x_threshold=run.X, matrix=run.matrix)
        walks.append((int(score[p]), path))
    return torch.from_numpy(encode_wire(walks, n + m + 1))


def block_walk_launch_t(run) -> torch.Tensor:
    """The block walk's launch alone on a finished forward's device tensors
    (``banded_block._Run`` with its history); returns the [B, row_bytes]
    uint8 wire on the device."""
    dev = run.qT.device
    if dev.type != "cuda" or run.hist is None:
        raise ValueError("the block walk takes a forward's history on a CUDA device")
    n, B = run.qT.shape
    m = run.t16.shape[1]
    steps, row_bytes = wire_steps(n + m + 1)
    if B * row_bytes >= 2**31 or n * run.W * B >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    wire = torch.empty((B, row_bytes), dtype=torch.uint8, device=dev)
    stride = 0 if run.table is None else run.table.shape[0]
    score = (run.state[1] - run.X).contiguous()
    lib, fn = _fn("swtpu_block_walk", [_P] * 10 + [_I] * 12 + [_P])
    with torch.cuda.device(dev):
        err = fn(ptr(run.qT), ptr(run.t16), ptr(run.table), ptr(run.hist),
                 ptr(run.bases), ptr(score), ptr(run.state[2]), ptr(run.state[3]),
                 ptr(run.n_rows), ptr(wire), B, n, m, run.W, run.K, run.X, run.match,
                 run.mismatch, run.gap, stride, steps, row_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "block_walk")
    return wire


def block_walk(run) -> torch.Tensor:
    """The block tier's device walk over a finished linear forward
    (``banded_block._Run`` with history): one wire row per pair (the kernel
    on CUDA tensors, the plain version on CPU ones)."""
    if run.affine:
        raise NotImplementedError(
            "the device walk is linear-gap, as JAX's: walk Gotoh results on the host "
            "(banded_block_traceback_host)")
    if run.qT.device.type == "cpu":
        return block_walk_plain(run)
    out = block_walk_launch_t(run)
    block_walk.launches += 1
    return out


block_walk.launches = 0


def xdrop_walk_plain(res, padded, bandwidth=32, x_threshold=70, match=1, mismatch=1,
                     gap=1, matrix=None) -> torch.Tensor:
    """Plain version of :func:`xdrop_walk`: ``batch.traceback.banded_traceback``
    per pair over the host copy of the per-round history, encoded to the
    wire."""
    from swtpu_torch.batch.traceback import banded_traceback

    W = int(bandwidth)
    res = res.numpy()
    qp, tp, lq, lt = (x.cpu().numpy() for x in padded)
    n, m = qp.shape[1] - W - 1, tp.shape[1] - 2 * W
    walks = []
    for b in range(qp.shape[0]):
        path = banded_traceback(
            qp[b, 1:1 + lq[b]], tp[b, W:W + lt[b]], res.history_for(b),
            res.pos_y[:, b], int(res.n_rounds[b]), int(res.max_round[b]),
            int(res.score[b]) + x_threshold, match, mismatch, gap, W, matrix=matrix)
        walks.append((int(res.score[b]), path))
    return torch.from_numpy(encode_wire(walks, n + m + 1))


def xdrop_walk_launch_t(res, padded, bandwidth, x_threshold, match, mismatch, gap,
                        table=None) -> torch.Tensor:
    """The per-round walk's launch alone: ``res`` the per-round kernel's
    result with its int32 history, ``padded`` the forward's (qp, tp, lq,
    lt): int16 padded rows and int32 lengths, all on one CUDA device;
    returns the wire on the device."""
    qp, tp, lens_q, lens_t = padded
    dev = qp.device
    W = int(bandwidth)
    B = qp.shape[0]
    hist = res.band_history
    if (dev.type != "cuda" or hist is None or hist.dtype != torch.int32
            or res.offsets is not None or hist.device != dev):
        raise ValueError("the per-round walk takes the kernel's int32 history on the "
                         "rows' CUDA device")
    for x, dt in ((qp, torch.int16), (tp, torch.int16), (lens_q, torch.int32),
                  (lens_t, torch.int32)):
        if x.dtype != dt or x.device != dev or not x.is_contiguous() or x.shape[0] != B:
            raise ValueError(f"the per-round walk takes contiguous {dt} rows and lengths "
                             f"with {B} rows, got {x.dtype} {tuple(x.shape)}")
    R = hist.shape[0]
    n, m = qp.shape[1] - W - 1, tp.shape[1] - 2 * W
    steps, row_bytes = wire_steps(n + m + 1)
    if B * row_bytes >= 2**31 or R * B * W >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    wire = torch.empty((B, row_bytes), dtype=torch.uint8, device=dev)
    stride = 0 if table is None else table.shape[0]
    lib, fn = _fn("swtpu_xdrop_walk", [_P] * 11 + [_I] * 12 + [_P])
    with torch.cuda.device(dev):
        err = fn(ptr(qp), ptr(tp), ptr(lens_q), ptr(lens_t), ptr(table), ptr(hist),
                 ptr(res.pos_y), ptr(res.score), ptr(res.max_round), ptr(res.n_rounds),
                 ptr(wire), B, qp.shape[1], tp.shape[1], R, W, int(x_threshold),
                 int(match), int(mismatch), int(gap), stride, steps, row_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "xdrop_walk")
    return wire


def xdrop_walk(res, padded, bandwidth=32, x_threshold=70, match=1, mismatch=1, gap=1,
               matrix=None) -> torch.Tensor:
    """The per-round tier's device walk over a linear forward's result
    (``banded_batch.banded_batch`` with its int32 history): one wire row per
    pair. ``padded``: the forward's (qp, tp, lq, lt), as
    ``banded_scan._prep_padded`` makes them; the kernel on CUDA tensors, the
    plain version on CPU ones."""
    qp, tp, lq, lt = padded
    if qp.device.type == "cpu":
        return xdrop_walk_plain(res, padded, bandwidth, x_threshold, match, mismatch,
                                gap, matrix)
    out = xdrop_walk_launch_t(
        res, (qp, tp, lq.to(torch.int32), lt.to(torch.int32)), bandwidth, x_threshold,
        match, mismatch, gap, None if matrix is None else banded_table(matrix, qp.device))
    xdrop_walk.launches += 1
    return out


xdrop_walk.launches = 0
