"""Device traceback walkers: the CUDA kernels and their plain versions.

Port of the walks of ``swtpu/kernels/pallas/banded_block.py::
_block_fwd_walk_impl`` (the block tier) and ``swtpu/kernels/xla/
banded_scan.py::_banded_fwd_walk_impl`` (the per-round tier), which JAX
runs as XLA gathers so that only scores and move strings cross the host
link. The kernels are ``csrc/sw_walk.cu`` (producer CTAs map the moves of
a chunk of rows or rounds at a time into a scratch map, for the block walk
a group of pairs together in large batches, and a follower CTA a pair
follows it from a ring in shared memory); both write the 2-bit move wire
that
``banded_scan.decode_device_walk`` reads. Their plain version is the host
walk (the oracle copy's walker per pair) encoded to the same wire: on a
CPU tensor the wrappers run it, on a CUDA tensor the kernel, never the
plain version there. Each wrapper counts its launches in
``<wrapper>.launches``. ``block_walk_mirror`` and ``xdrop_walk_mirror``
replay the kernels' two-phase schedule with tensor ops (tests only);
``_block_serial_launch_t`` and ``_xdrop_serial_launch_t`` launch the
earlier one-thread-a-pair kernels, which no entry point runs.
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
#: the most rows (block walk) or rounds (per-round walk) a map chunk holds
CHUNK = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
MINF = -(1 << 30)
# map entry flags (sw_walk.cu); from bit 8 the next entry's address, here
# its index in the ring times 4 (the kernel adds the ring's shared address)
E_EXIT, E_CROSS, E_STALL = 4, 8, 16
STALL = 3 | E_STALL
NBUF = 4  # chunks in a follower's ring (sw_walk.cu)
#: pairs a block-walk producer CTA maps together in large batches (the
#: kernel takes 1 or 8), and the batch size from which it does: on the
#: H100, grouping loses at 8 16K-mers, where the follower binds, and wins
#: at 128, where the map does (chip_smoke.py phase 27 times both)
GROUP, GROUP_FROM = 8, 64


def default_chunk(entries_a_row: int) -> int:
    """Rows (rounds) a map chunk holds: the largest power of two up to CHUNK
    that keeps a follower's ring of NBUF chunks within 68 KB (so three
    CTAs fit an SM); ``entries_a_row`` is W + 1 (block) or W (per-round)."""
    c = CHUNK
    while c > 1 and NBUF * c * entries_a_row * 4 > 68 * 1024:
        c //= 2
    return c


def _padded(entries: int) -> int:
    """A chunk's entries in the map, padded to 16 bytes (sw_walk.cu's Sp)."""
    return -(-entries // 4) * 4


def default_group(B: int) -> int:
    """Pairs a block-walk producer CTA maps together: GROUP when the batch
    has at least GROUP_FROM pairs (then a staged cell's copies read whole
    32-byte sectors of the [n, W, B] history), else 1 (every pair's map
    on producers of its own)."""
    return GROUP if B >= GROUP_FROM else 1


def _map_scratch(B, max_chunks, Sp, dev):
    """The map kernels' scratch: every chunk's entries, a zeroed flag a chunk
    that its producer CTA raises once they are written, and a zeroed ticket
    counter that hands out the CTAs' roles."""
    return (torch.empty((B, max_chunks, Sp), dtype=torch.int32, device=dev),
            torch.zeros(B * max_chunks + 1, dtype=torch.int32, device=dev))


def wire_steps(max_steps: int):
    """(moves a row holds, bytes a row takes) for paths of up to
    ``max_steps`` steps: 20 bytes of meta and 2 bits a move."""
    steps = -(-int(max_steps) // CH) * CH
    return steps, 20 + steps // 4


def _wire_row(score, sy, sx, moves, ok, steps) -> np.ndarray:
    """One pair's wire row: the meta, then ``moves`` padded with 3s."""
    padded = np.full(steps, 3, np.uint8)
    padded[: len(moves)] = moves
    row = np.empty(20 + steps // 4, np.uint8)
    row[:20] = np.array([score, sy, sx, len(moves), int(ok)], dtype="<i4").view(np.uint8)
    row[20:] = (padded.reshape(-1, 4) << np.arange(0, 8, 2, dtype=np.uint8)).sum(
        axis=1, dtype=np.uint8)
    return row


def encode_wire(walks, max_steps: int) -> np.ndarray:
    """The wire of host walks: ``walks`` is one (score, path) per pair, path
    from the origin to the start cell of the walk; [B, row_bytes] uint8."""
    steps, row_bytes = wire_steps(max_steps)
    out = np.empty((len(walks), row_bytes), np.uint8)
    for b, (score, path) in enumerate(walks):
        pts = np.asarray(path, dtype=np.int64).reshape(-1, 2)[::-1]  # start -> origin
        d = pts[:-1] - pts[1:]
        moves = np.where(d[:, 0] & d[:, 1], 0, np.where(d[:, 0], 1, 2))
        out[b] = _wire_row(score, pts[0, 0], pts[0, 1], moves, True, steps)
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


def block_walk_launch_t(run, _chunk=None, _group=None) -> torch.Tensor:
    """The block walk's launch alone on a finished forward's device tensors
    (``banded_block._Run`` with its history); returns the [B, row_bytes]
    uint8 wire on the device. ``_chunk``: rows a map chunk holds (default
    ``default_chunk(W + 1)``; tests force small ones; 0 launches the
    earlier serial kernel); ``_group``: pairs a producer CTA maps together
    (default ``default_group(B)``; tests and chip_smoke.py force both)."""
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
    C = default_chunk(run.W + 1) if _chunk is None else int(_chunk)
    G = default_group(B) if _group is None else int(_group)
    max_chunks = -(-n // C) if C else 0
    scratch = _map_scratch(B, max_chunks, _padded(C * (run.W + 1)), dev) if C else (None,) * 2
    lib, fn = _fn("swtpu_block_walk", [_P] * 10 + [_I] * 14 + [_P, _P, _I, _P])
    with torch.cuda.device(dev):
        err = fn(ptr(run.qT), ptr(run.t16), ptr(run.table), ptr(run.hist),
                 ptr(run.bases), ptr(score), ptr(run.state[2]), ptr(run.state[3]),
                 ptr(run.n_rows), ptr(wire), B, n, m, run.W, run.K, run.X, run.match,
                 run.mismatch, run.gap, stride, steps, row_bytes, C, G, ptr(scratch[0]),
                 ptr(scratch[1]), max_chunks, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "block_walk")
    return wire


def _block_serial_launch_t(run) -> torch.Tensor:
    """The earlier block walk kernel (a thread per pair, a chain of
    dependent loads a step), off every entry point: what chip_smoke.py and
    the card tests time and hold beside :func:`block_walk_launch_t`."""
    return block_walk_launch_t(run, _chunk=0)


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
                        table=None, _chunk=None) -> torch.Tensor:
    """The per-round walk's launch alone: ``res`` the per-round kernel's
    result with its int32 history, ``padded`` the forward's (qp, tp, lq,
    lt): int16 padded rows and int32 lengths, all on one CUDA device;
    returns the wire on the device. ``_chunk``: rounds a map chunk holds
    (default ``default_chunk(W)``; tests force small ones; 0 launches the
    earlier serial kernel)."""
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
    C = default_chunk(W) if _chunk is None else int(_chunk)
    max_chunks = -(-R // C) if C else 0
    scratch = _map_scratch(B, max_chunks, _padded(C * W), dev) if C else (None,) * 2
    lib, fn = _fn("swtpu_xdrop_walk", [_P] * 11 + [_I] * 13 + [_P, _P, _I, _P])
    with torch.cuda.device(dev):
        err = fn(ptr(qp), ptr(tp), ptr(lens_q), ptr(lens_t), ptr(table), ptr(hist),
                 ptr(res.pos_y), ptr(res.score), ptr(res.max_round), ptr(res.n_rounds),
                 ptr(wire), B, qp.shape[1], tp.shape[1], R, W, int(x_threshold),
                 int(match), int(mismatch), int(gap), stride, steps, row_bytes, C,
                 ptr(scratch[0]), ptr(scratch[1]), max_chunks,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "xdrop_walk")
    return wire


def _xdrop_serial_launch_t(res, padded, bandwidth, x_threshold, match, mismatch, gap,
                           table=None) -> torch.Tensor:
    """The earlier per-round walk kernel (a thread per pair), off every
    entry point: timed and held beside :func:`xdrop_walk_launch_t`."""
    return xdrop_walk_launch_t(res, padded, bandwidth, x_threshold, match, mismatch,
                               gap, table, _chunk=0)


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


# -- plain mirrors of the kernels' two-phase schedule (tests only) -----------


def _sub(yc, xc, table, match, mismatch):
    """``sub_score`` of sw_walk.cu on code tensors (a table clamps codes
    outside [0, stride) to its last row / column)."""
    if table is not None:
        st = table.shape[0]
        qi = torch.where((yc >= 0) & (yc < st), yc, st - 1)
        ti = torch.where((xc >= 0) & (xc < st), xc, st - 1)
        return table[qi, ti]
    return torch.where((yc >= 0) & (xc >= 0) & (yc == xc), match, -mismatch)


def _choose(v, diag, up, left, s, gap, i_pos, j_pos, dead_tests):
    """The walk's rule at each cell: (move 0 diag / 1 up / 2 left, whether a
    move exists); the block walk tests its neighbours for death, the
    per-round walk (as its kernel) does not."""
    live = (lambda x: x > MINF) if dead_tests else (lambda x: True)  # noqa: E731
    can_d = i_pos & j_pos & live(diag) & (diag + s == v)
    can_u = i_pos & live(up) & (up - gap == v)
    can_l = j_pos & live(left) & (left - gap == v)
    mv = torch.where(can_d, 0, torch.where(can_u, 1, 2))
    return mv, can_d | can_u | can_l


def _follow(entry, addr, steps, i, j, chunk_of, ch=0):
    """The follower: entries from ring address ``addr`` in chunk ``ch`` until
    a stall, an exit or the step cap; ``entry(addr, ch)`` reads chunk ch's
    map. Returns (moves, i, j, stalled)."""
    moves = []
    while len(moves) < steps:
        e = entry(addr, ch)
        if e & E_STALL:
            return moves, i, j, True
        mv = e & 3
        moves.append(mv)
        i, j = i - (mv != 2), j - (mv != 1)
        addr = e >> 8
        if e & E_EXIT:
            break
        if e & E_CROSS:
            ch = chunk_of(i, j)
    return moves, i, j, False


def _ring_reader(chunk_map, Sp):
    """``entry(addr, ch)`` over chunk maps made on first use, checking that
    the ring address names chunk ch's buffer."""
    maps = {}

    def entry(addr, ch):
        if ch not in maps:
            maps[ch] = chunk_map(ch).flatten().tolist()
        buf, off = divmod(addr // 4, Sp)
        assert buf == ch % NBUF, (addr, ch)
        return maps[ch][off]

    return entry


def block_walk_mirror(run, chunk=None, group=1) -> torch.Tensor:
    """Plain mirror of ``block_walk_kernel`` (tests only): per pair, the move
    map of ``chunk`` rows at a time, top chunk first, as tensor ops, in the
    kernel's entries (the move, the exit and cross flags, the next cell's
    index in a ring of NBUF chunks; slot W of a row is its out-of-band
    column 0; the start cell takes the walk's start value score + X); then
    the follower over the entries and row 0's gap chain. Chunks are
    anchored at the largest end row of the pair's ``group`` (the kernel's
    producers stage one row for the group's pairs together), and the
    follower starts in the chunk that holds its end row. Returns the [B,
    row_bytes] wire."""
    C = default_chunk(run.W + 1) if chunk is None else int(chunk)
    h = lambda x: x.cpu().long()  # noqa: E731
    hist, bases, qT, t = h(run.hist), h(run.bases), h(run.qT), h(run.t16)
    table = None if run.table is None else h(run.table)
    score, ey_, ej_, nr_ = (h(x).tolist() for x in (
        run.state[1] - run.X, run.state[2], run.state[3], run.n_rows))
    n, B = qT.shape
    m = t.shape[1]
    W, K, X, gap = run.W, run.K, run.X, run.gap
    steps, row_bytes = wire_steps(n + m + 1)
    Sp = _padded(C * (W + 1))
    out = np.empty((B, row_bytes), np.uint8)
    for b in range(B):
        sc, ey, ej, nr = score[b], ey_[b], ej_[b], nr_[b]
        hb, bb, qb = hist[:, :, b], bases[:, b], qT[:, b]
        tb = torch.cat([torch.full((1,), -1), t[b]])  # tb[j] = t[j - 1]

        def rbase(y, bb=bb):
            yc = (y - 1).clamp(min=0)
            return bb[yc // K] + yc % K

        def val(y, j, hb=hb, nr=nr, sc=sc, rbase=rbase):
            """block_val: the stored cell with the final row's cutoff, the
            chains of row 0 and of column 0 out of band, else -2^30."""
            y, j = torch.broadcast_tensors(torch.as_tensor(y), torch.as_tensor(j))
            c0 = X - j * gap
            out = torch.where((y == 0) & (j >= 0) & ((c0 > 0) | (j == 0)), c0, MINF)
            live = (y >= 1) & (y <= nr)
            k = j - rbase(y)
            inb = live & (k >= 0) & (k < W)
            raw = hb[(y - 1).clamp(0, max(n - 1, 0)), k.clamp(0, W - 1)]
            raw = torch.where((y == nr) & (raw < sc), 0, raw)
            out = torch.where(inb, torch.where(raw != 0, raw, MINF), out)
            cy = X - y * gap
            return torch.where(live & ~inb & (j == 0) & (cy > 0), cy, out)

        def step_of(y, j, v, val=val, qb=qb, tb=tb):
            """The move at cells (y >= 1) with value v, and whether one exists."""
            diag, up, left = val(y - 1, j - 1), val(y - 1, j), val(y, j - 1)
            yc = qb[(y - 1).clamp(min=0)]
            xc = torch.where((j >= 1) & (j <= m), tb[j.clamp(0, m)], -1)
            s = torch.where(j > 0, _sub(yc, xc, table, run.match, run.mismatch), 0)
            return _choose(v, diag, up, left, s, gap, y > 0, j > 0, True)

        k0 = ej - (int(rbase(torch.tensor(ey))) if 1 <= ey <= nr else 0)
        if not (1 <= ey <= nr and (0 <= k0 < W or ej == 0)):
            # forwards give no start the map cannot hold but the all-dead
            # one, the origin: the kernel writes its empty path (and stalls
            # on any other)
            if (ey, ej) != (0, 0):
                raise ValueError(f"pair {b}: a start the map cannot hold, {(ey, ej)}")
            out[b] = _wire_row(sc, 0, 0, [], True, steps)
            continue
        g0_ = b // group * group
        top = max(min(max(e, 0), n) for e in ey_[g0_:g0_ + group])
        c0 = (top - ey) // C

        def chunk_map(c, ey=ey, ej=ej, sc=sc, val=val, rbase=rbase, step_of=step_of,
                      top=top):
            y_hi = top - c * C
            y_lo = y_hi - C + 1
            y = torch.arange(y_lo, y_hi + 1)[:, None]
            k = torch.arange(W + 1)[None, :]
            rb = rbase(y)
            j = torch.where(k < W, rb + k, 0)
            cell = (y >= 1) & ((k < W) | ~((rb <= 0) & (rb + W > 0)))
            v = torch.where((y == ey) & (j == ej), sc + X, val(y, j))
            mv, can = step_of(y, j, v)
            ny, nj = y - (mv != 2).long(), j - (mv != 1).long()
            nk0 = nj - rbase(ny)
            nk = torch.where((nk0 >= 0) & (nk0 < W), nk0, W)
            nc = torch.where(ny < y_lo, c + 1, c)
            idx = (nc % NBUF) * Sp + (ny - (top - (nc + 1) * C + 1)) * (W + 1) + nk
            ent = mv | torch.where(ny == 0, E_EXIT,
                                   torch.where(nc != c, E_CROSS, 0) | (4 * idx << 8))
            return torch.where(cell & (v > MINF) & can, ent, STALL)

        y_lo = top - (c0 + 1) * C + 1
        g0 = 4 * ((c0 % NBUF) * Sp + (ey - y_lo) * (W + 1) + (k0 if 0 <= k0 < W else W))
        moves, i, j, stalled = _follow(_ring_reader(chunk_map, Sp), g0, steps, ey, ej,
                                       lambda i, j, top=top: (top - i) // C, c0)
        ok = not stalled
        if ok and i == 0:  # row 0: the gap chain, left to the origin
            v = X - j * gap
            while j > 0 and len(moves) < steps:
                c0 = X - (j - 1) * gap
                left = c0 if (c0 > 0 or j == 1) else MINF
                if not (left > MINF and left - gap == v):
                    ok = False
                    break
                moves.append(2)
                j, v = j - 1, left
        out[b] = _wire_row(sc, ey, ej, moves, ok and i == 0 and j == 0, steps)
    return torch.from_numpy(out)


def xdrop_walk_mirror(res, padded, bandwidth=32, x_threshold=70, match=1, mismatch=1,
                      gap=1, matrix=None, chunk=None) -> torch.Tensor:
    """Plain mirror of ``xdrop_walk_kernel`` (tests only): per pair, the
    start (the largest slot of max_round holding score + X), then the move
    map of ``chunk`` rounds at a time, top chunk first, as tensor ops in the
    kernel's entries, and the follower over them. Returns the [B,
    row_bytes] wire."""
    W, X = int(bandwidth), int(x_threshold)
    C = default_chunk(W) if chunk is None else int(chunk)
    h = lambda x: torch.as_tensor(x).cpu().long()  # noqa: E731
    hist, posy = h(res.band_history), h(res.pos_y)
    score, r0_, nrounds_ = (h(x).tolist() for x in (res.score, res.max_round,
                                                     res.n_rounds))
    qp, tp, lq, lt = (h(x) for x in padded)
    table = None if matrix is None else h(banded_table(matrix, "cpu"))
    R, B = posy.shape
    QL, TL = qp.shape[1], tp.shape[1]
    n_, m_ = QL - W - 1, TL - 2 * W
    steps, row_bytes = wire_steps(n_ + m_ + 1)
    Sp = _padded(C * W)
    out = np.empty((B, row_bytes), np.uint8)
    for b in range(B):
        n, m, nrounds, sc, r0 = int(lq[b]), int(lt[b]), nrounds_[b], score[b], r0_[b]
        target = sc + X
        hb, pyb, qb, tb = hist[:, b], posy[:, b], qp[b], tp[b]

        def py(r, pyb=pyb):
            return pyb[torch.as_tensor(r).clamp(0, R - 1)]

        def val(r, y, x, k, hb=hb, n=n, m=m, nrounds=nrounds):
            valid = ((y >= 0) & (y <= n) & (x >= 0) & (x <= m) & (r >= 0)
                     & (r < nrounds) & (k >= 0) & (k < W))
            raw = hb[r.clamp(0, R - 1), k.clamp(0, W - 1)]
            return torch.where(valid & (raw != 0), raw, MINF)

        def step_of(i, j, v, val=val, py=py, qb=qb, tb=tb):
            """The move at cells (i, j) of value v, whether one exists, and
            the next cell's round and slot."""
            r = i + j
            k_up = (W - 1) - ((i - 1) - py(r - 1))
            k_diag = (W - 1) - ((i - 1) - py(r - 2))
            up, left = val(r - 1, i - 1, j, k_up), val(r - 1, i, j - 1, k_up - 1)
            diag = val(r - 2, i - 1, j - 1, k_diag)
            s = _sub(qb[i.clamp(0, QL - 1)], tb[(W + j - 1).clamp(0, TL - 1)], table,
                     match, mismatch)
            mv, can = _choose(v, diag, up, left, s, gap, i > 0, j > 0, False)
            nk = torch.where(mv == 0, k_diag, torch.where(mv == 1, k_up, k_up - 1))
            return mv, can, r - 1 - (mv == 0).long(), nk

        if not (0 <= r0 < nrounds and r0 < R):  # the kernel stalls (forwards give none)
            raise ValueError(f"pair {b}: max_round {r0} outside the written rounds")
        ks = torch.arange(W)
        yk = py(r0) + (W - 1 - ks)
        vk = hb[r0]
        hit = (vk == target) & (vk != 0) & (yk >= 0) & (yk <= n) & (r0 - yk >= 0) & (
            r0 - yk <= m)
        kstar = int(ks[hit].max()) if bool(hit.any()) else -1
        sy = int(py(r0)) + (W - 1 - max(kstar, 0))
        sx = r0 - sy
        i, j, moves, ok = sy, sx, [], kstar >= 0
        if ok and (i or j):

            def chunk_map(c, r0=r0, val=val, py=py, step_of=step_of):
                r_hi = r0 - c * C
                r_lo = r_hi - C + 1
                r = torch.arange(r_lo, r_hi + 1)[:, None]
                k = torch.arange(W)[None, :]
                i = py(r) + (W - 1 - k)
                j = r - i
                v = val(r, i, j, k)
                mv, can, nr, nk = step_of(i, j, v)
                nc = torch.where(nr >= r_lo, c, torch.where(nr >= r_lo - C, c + 1, c + 2))
                idx = (nc % NBUF) * Sp + (nr - (r0 - (nc + 1) * C + 1)) * W + nk
                ent = mv | torch.where(nr == 0, E_EXIT,
                                       torch.where(nc != c, E_CROSS, 0) | (4 * idx << 8))
                return torch.where((r >= 1) & (v > MINF) & can, ent, STALL)

            moves, i, j, stalled = _follow(
                _ring_reader(chunk_map, Sp), 4 * ((C - 1) * W + kstar), steps, i, j,
                lambda i, j, r0=r0: (r0 - (i + j)) // C)
            ok = not stalled
        out[b] = _wire_row(sc, sy, sx, moves, ok and i == 0 and j == 0, steps)
    return torch.from_numpy(out)
