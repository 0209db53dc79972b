"""Block-adaptive banded X-drop forward pass and traceback: the CUDA
kernels and their plain PyTorch versions.

Port of ``swtpu/kernels/pallas/banded_block.py``: ``BandedBlockBatchResult``,
``banded_block_batch_pallas`` (here :func:`banded_block_batch`),
``_banded_block_impl`` (the loop over blocks), ``banded_block_traceback_host``,
``banded_block_align_device`` with ``_block_fwd_walk_impl``'s walk rules,
and ``bench_forward_fn``. The contract is ``oracle.banded_block``
(``banded_xdrop_block`` linear, ``banded_xdrop_block_affine`` Gotoh):
scores, row-major-first endpoints, n_rows, per-block bases/deltas and the
H-only band history, bit for bit.

The forward is B9, :func:`block_forward` (``_block_kernel`` and
``_block_kernel_folded``, one kernel for both: the fold is TPU layout),
one launch of ``csrc/sw_block.cu`` for every block of every pair, a warp
a pair: each pair runs its blocks until it is done, reads its corridor
window in place (B10's function), and does each block's end (X-drop
against the updated max, dead test, first-argmax recentering, realign)
and the loop's bookkeeping (done, n_rows, bases, deltas, the history rows,
the final-row X-drop of a varlen pair that ends inside the block). Its
left chain is a max-plus scan across the warp, exact for gap penalties
>= 0; a negative penalty takes the oracle's serial chain in the earlier
per-block kernels under the host loop (:func:`block_loop`): B10,
:func:`block_gather` (``_gather_kernel`` / ``_gather_twin``: each pair's
window, ``win[c, b] = t[b, base_b + c - 1]``, -1 outside the target or
past its length, [K + W - 1, B]), then the per-block B9,
:func:`block_rows`, a thread per pair, each block, asking ``done.all()``
every :data:`POLL` blocks. The blocks after a pair is done hold what that
loop leaves, in both routes: its frozen base and delta 0 where the loop ran
them, zeros past the poll that saw every pair done. The device walk is
``block_walk`` of ``csrc/sw_walk.cu`` (``kernels.device_walk``).

On the CPU every step runs its plain version (the loop with the plain B10
and B9; :func:`block_forward_plain` mirrors the one-launch schedule); on a
CUDA device the kernels, never the plain versions: a failed build or
launch raises. The plain B9 computes each row's left chain as a max-plus
scan (a cummax in gap-rebiased coordinates, segmented at the column-0
pin): the oracle's dead tests only drop terms that are at most 0 when
every gap penalty is >= 0, so the scan is exact there; a negative penalty
runs the oracle's serial chain over the slots instead.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from swtpu_torch.kernels import _build
from swtpu_torch.kernels.banded_batch import _gaps
from swtpu_torch.kernels.banded_scan import _host, decode_device_walk
from swtpu_torch.kernels.device_walk import block_walk
from swtpu_torch.kernels.sw_banded import banded_table
from swtpu_torch.kernels.sw_batch import ptr
from swtpu_torch.utils.device import resolve_device

SOURCE = "sw_block.cu"
CHUNK = 16  # widths are multiples of this (the TPU kernel's slot groups)
LANE = 128  # block + width <= LANE + 1: the TPU gather window
POLL = 4  # blocks between the host's done.all() checks
EF_DEAD = -(2**28)
EF_CUT = EF_DEAD // 2
MINF = -(2**30)
_BIG = 1 << 40  # segment offset of the plain row scans (int64)


@dataclasses.dataclass
class BandedBlockBatchResult:
    """Batched block-tier forward results (the oracle's
    ``BandedBlockResult``, batched). Tensors on the device the call ran on
    (``numpy()`` copies them to the host).

    band_history / bases / deltas rows past a pair's ``n_rows`` (its death
    block) are unspecified: every consumer reads below ``n_rows``.
    """

    score: "torch.Tensor | np.ndarray"  # [B] int32, max - X
    end_y: "torch.Tensor | np.ndarray"  # [B] int32 (0 = all-dead start)
    end_j: "torch.Tensor | np.ndarray"  # [B]
    n_rows: "torch.Tensor | np.ndarray"  # [B] rows computed (<= n)
    bases: "torch.Tensor | np.ndarray | None" = None  # [NB, B] block base
    deltas: "torch.Tensor | np.ndarray | None" = None  # [NB, B]
    band_history: "torch.Tensor | np.ndarray | None" = None  # [n, W, B] int32

    def numpy(self) -> "BandedBlockBatchResult":
        return BandedBlockBatchResult(*(
            None if x is None else _host(x) for x in dataclasses.astuple(self)))


def _geometry(width, block, dmax):
    """(W, K, D) after the JAX entry's guards (ValueError)."""
    W, K = int(width), int(block)
    if W % CHUNK or W < CHUNK:
        raise ValueError(f"width must be a multiple of {CHUNK}")
    D = min(K, W // 2) if dmax is None else int(dmax)
    if D < 1:
        raise ValueError("dmax must be >= 1")
    if K < 1:
        raise ValueError("block must be >= 1")
    if K + W > LANE + 1:
        raise ValueError(f"block + width must be <= {LANE + 1} (the gather window)")
    return W, K, D


def _codes16(x, device):
    """[B, L] int16 codes on ``device`` (-1 and below are pads)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.dtype.is_floating_point or x.dtype == torch.bool:
        raise TypeError(f"sequence codes must be integers, got {x.dtype}")
    if x.dim() == 1:
        x = x[None]
    if x.dim() != 2:
        raise ValueError(f"codes must be [B, L], got shape {tuple(x.shape)}")
    if x.dtype != torch.int16:
        x = x.to(device).to(torch.int64).clamp(min=-1, max=2**15 - 1).to(torch.int16)
    return x.to(device)


def _lens(lens, B, L, device):
    if lens is None:
        return None
    out = torch.as_tensor(np.asarray(lens) if not isinstance(lens, torch.Tensor)
                          else lens, device=device).to(torch.int64)
    if tuple(out.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(out.shape)}")
    if B and (int(out.min()) < 0 or int(out.max()) > L):
        raise ValueError(f"lengths must lie in [0, {L}]")
    return out


def _prep(qs, ts, lens_q, lens_t, device):
    """The device layouts: qT [n, B] int16 (pair b's row y - 1 at
    ``qT[y - 1, b]``), t16 [B, m] int16 with -1 past each pair's length
    (the oracle's pads for j > len_t), lens_q / lens_t as int32 [B] or
    None."""
    qs = _codes16(qs, device)
    ts = _codes16(ts, device)
    B, n = qs.shape
    m = ts.shape[1]
    if ts.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {ts.shape[0]} targets")
    lt = _lens(lens_t, B, m, device)
    t16 = ts.contiguous()
    if lt is not None:
        past = torch.arange(m, device=device)[None, :] >= lt[:, None]
        t16 = torch.where(past, torch.tensor(-1, dtype=torch.int16, device=device), ts)
        t16 = t16.contiguous()
    lq = _lens(lens_q, B, n, device)
    i32 = (lambda x: None if x is None else x.to(torch.int32))
    return qs.t().contiguous(), t16, i32(lq), i32(lt)


# --- B10: the corridor window gather ----------------------------------------


def block_gather_plain(t16, bases, C):
    """Plain version of :func:`block_gather`: [C, B] int16,
    ``win[c, b] = t16[b, bases[b] + c - 1]``, -1 outside [0, m)."""
    B, m = t16.shape
    pos = bases.to(torch.int64)[None, :] + torch.arange(C, device=t16.device)[:, None] - 1
    inside = (pos >= 0) & (pos < m)
    if m == 0:
        return torch.full((C, B), -1, dtype=torch.int16, device=t16.device)
    got = t16.t().gather(0, pos.clamp(0, m - 1))
    return torch.where(inside, got, torch.tensor(-1, dtype=torch.int16, device=t16.device))


def _lib_fn(name, argtypes):
    lib = _build.load(SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _cuda_stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def gather_launch_t(t16, bases, C):
    """The B10 launch alone: t16 [B, m] contiguous int16 and bases [B]
    int32 on one CUDA device; returns the [C, B] int16 window."""
    dev = t16.device
    B, m = t16.shape
    for x, dt in ((t16, torch.int16), (bases, torch.int32)):
        if (x.dtype != dt or x.device != dev or dev.type != "cuda"
                or not x.is_contiguous() or x.shape[0] != B):
            raise ValueError(
                f"the gather kernel takes contiguous {dt} tensors with {B} rows on one "
                f"CUDA device, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if max(B * C, B * m) >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {m}, {C}")
    win = torch.empty((C, B), dtype=torch.int16, device=dev)
    lib, fn = _lib_fn("swtpu_block_gather", [_P] * 3 + [_I] * 3 + [_P])
    with torch.cuda.device(dev):
        err = fn(ptr(t16), ptr(bases), ptr(win), B, m, C, _cuda_stream(dev))
    _build.check(lib, err, "block_gather")
    return win


def block_gather(t16, bases, C):
    """B10: each pair's corridor window of C characters at its base, [C, B]
    int16 (the kernel on a CUDA tensor, the plain version on a CPU one)."""
    if t16.device.type == "cpu":
        return block_gather_plain(t16, bases, C)
    out = gather_launch_t(t16, bases, C)
    block_gather.launches += 1
    return out


block_gather.launches = 0


# --- B9: one block of rows and its block-end work ----------------------------


@dataclasses.dataclass
class _Run:
    """One forward's fixed inputs and its device state (updated in place by
    each block: carried [CW, B], state [4, B] = base, max, end_y, end_j,
    done / n_rows [B], bases / deltas [NB, B], history [n, W, B])."""

    qT: torch.Tensor
    t16: torch.Tensor
    lens_q: Optional[torch.Tensor]
    lens_t: Optional[torch.Tensor]
    table: Optional[torch.Tensor]
    matrix: Optional[np.ndarray]
    n: int
    W: int
    K: int
    X: int
    match: int
    mismatch: int
    gap: int
    go: Optional[int]
    ge: Optional[int]
    D: int
    carried: torch.Tensor
    state: torch.Tensor
    done: torch.Tensor
    n_rows: torch.Tensor
    bases: torch.Tensor
    deltas: torch.Tensor
    hist: Optional[torch.Tensor]

    @property
    def affine(self):
        return self.go is not None

    @property
    def B(self):
        return self.qT.shape[1]


def _new_run(qT, t16, lens_q, lens_t, table, matrix, W, K, X, match, mismatch, gap,
             go, ge, D, with_history):
    n, B = qT.shape
    dev = qT.device
    NB = -(-n // K) if n else 0
    base0 = 1 - W // 2
    j0 = base0 - 1 + np.arange(W)
    if go is not None:
        chain = np.where(j0 == 0, X, X - go - (j0 - 1) * ge)
        carried0 = np.concatenate([np.where(j0 >= 0, np.maximum(chain, 0), 0),
                                   np.full(W, EF_DEAD)])
    else:
        carried0 = np.maximum(np.where(j0 >= 0, X - j0 * gap, 0), 0)
    i32 = dict(dtype=torch.int32, device=dev)
    carried = torch.as_tensor(carried0.astype(np.int32), device=dev)[:, None]
    state = torch.tensor([base0, X, 0, 0], **i32)[:, None]
    return _Run(
        qT, t16, lens_q, lens_t, table, matrix, n, W, K, X, match, mismatch, gap,
        go, ge, D, carried=carried.expand(-1, B).contiguous(),
        state=state.expand(-1, B).contiguous(),
        done=torch.zeros((B,), **i32), n_rows=torch.zeros((B,), **i32),
        bases=torch.zeros((max(NB, 1), B), **i32),
        deltas=torch.zeros((max(NB, 1), B), **i32),
        hist=torch.zeros((n, W, B), **i32) if with_history else None,
    )


def _scores(run, qc, tc):
    """Substitution scores of query codes qc against window codes tc (int64):
    uniform match where equal and tc >= 0, else -mismatch; a matrix reads
    the banded extended table, any code outside it (pads) at its min."""
    if run.table is None:
        return torch.where((qc == tc) & (tc >= 0), run.match, -run.mismatch)
    stride = run.table.shape[0]
    qi = torch.where((qc >= 0) & (qc < stride), qc, stride - 1)
    ti = torch.where((tc >= 0) & (tc < stride), tc, stride - 1)
    return run.table.reshape(-1).to(torch.int64)[qi * stride + ti]


def _chain(first, vals, step, seg):
    """Max-plus chain x_k = max(vals_k, x_{k-1} - step), x_{-1} = first
    ([B]), over slots (dim 0), restarted where ``seg`` turns on (the pin:
    vals there already hold the restart value). A cummax in rebiased
    coordinates x_k + k * step; segments are split by a large offset."""
    W = vals.shape[0]
    k = torch.arange(W, device=vals.device, dtype=torch.int64)[:, None]
    off = seg.to(torch.int64) * _BIG
    u = torch.cat([first[None] - step, vals + k * step + off])
    u = torch.cummax(u, dim=0).values[1:]
    return u - off - k * step


def _row_plain(run, win, r, y, base, P, PF):
    """Row y (block row r) for every pair: the oracle's recurrence on [W, B]
    int64 tensors. Returns (H, F) (F None for linear)."""
    W = run.W
    dev = P.device
    k = torch.arange(W, device=dev)[:, None]
    bpr = base + r  # [B] the row's corridor base
    qc = run.qT[y - 1].to(torch.int64)[None, :]
    tc = win[r:r + W].to(torch.int64)
    s = _scores(run, qc, tc)
    zero = torch.zeros((1, P.shape[1]), dtype=torch.int64, device=dev)
    Pn = torch.cat([P[1:], zero])  # up neighbour, slot W dead
    pin_mask = (bpr[None, :] + k) == 0
    seg = torch.cumsum(pin_mask.to(torch.int64), 0) > 0
    if run.go is None:
        g = run.gap
        pin = max(run.X - y * g, 0)
        diag = torch.where(P > 0, P + s, 0).clamp(min=0)
        up = torch.where(Pn > 0, Pn - g, 0)
        a = torch.maximum(diag, up)
        a = torch.where(pin_mask, pin, a)
        left0 = torch.where(bpr == 1, pin, 0).to(torch.int64)
        if g >= 0:
            H = _chain(left0, a, g, seg)
            return torch.where(pin_mask, pin, H), None
        H, left = torch.empty_like(a), left0  # the oracle's serial chain
        for k_ in range(W):
            left = torch.maximum(a[k_], torch.where(left > 0, left - g, 0))
            H[k_] = left = torch.where(pin_mask[k_], pin, left)
        return H, None
    go, ge = run.go, run.ge
    chain = run.X if y == 0 else run.X - go - (y - 1) * ge
    pin_h = max(chain, 0)
    PFn = torch.cat([PF[1:], torch.full_like(zero, EF_DEAD)])
    diag = torch.where(P > 0, P + s, MINF)
    f = torch.maximum(torch.where(PFn > EF_CUT, PFn - ge, MINF),
                      torch.where(Pn > 0, Pn - go, MINF))
    a = torch.maximum(torch.maximum(diag, f), torch.zeros_like(f))
    a = torch.where(pin_mask, pin_h, a)
    left0 = torch.where(bpr == 1, pin_h, 0).to(torch.int64)
    if min(go, ge) >= 0:
        # E: e_k = max(e_{k-1} - min(go, ge), a_{k-1} - go) on its positive part
        c = min(go, ge)
        first = torch.where(left0 > 0, left0 - go, MINF) + c  # e_0 + step
        seg_e = torch.cat([torch.zeros_like(seg[:1]), seg[:-1]])  # slots past the pin
        vals = torch.cat([torch.full_like(zero, MINF), a[:-1] - go])
        e = _chain(first, vals, c, seg_e)
        H = torch.where(pin_mask, pin_h, torch.maximum(a, e))
    else:  # the oracle's serial chain, dead tests and all
        H, hl, el = torch.empty_like(a), left0, torch.full_like(left0, EF_DEAD)
        for k_ in range(W):
            e = torch.maximum(torch.where(el > EF_CUT, el - ge, MINF),
                              torch.where(hl > 0, hl - go, MINF))
            v = torch.where(pin_mask[k_], pin_h, torch.maximum(a[k_], e))
            e = torch.where(pin_mask[k_] | (v == 0), EF_DEAD, torch.clamp(e, min=EF_DEAD))
            H[k_] = hl = v
            el = e
    F = torch.where(pin_mask, chain, f)
    F = torch.where(H == 0, EF_DEAD, torch.clamp(F, min=EF_DEAD))
    return H, F


def block_rows_plain(run: _Run, b: int, Kb: int, win: torch.Tensor) -> None:
    """Plain version of :func:`block_rows`: block ``b`` (rows b*K + 1 ..
    b*K + Kb) for every pair not yet done, in place on ``run``'s state."""
    W, B, dev = run.W, run.B, run.qT.device
    y0 = b * run.K
    live = run.done == 0
    base = run.state[0].to(torch.int64)
    maxg = run.state[1].to(torch.int64)
    end_y = run.state[2].to(torch.int64)
    end_j = run.state[3].to(torch.int64)
    P = run.carried[:W].to(torch.int64)
    PF = run.carried[W:].to(torch.int64) if run.affine else None
    lens = (torch.full((B,), run.n, dtype=torch.int64, device=dev)
            if run.lens_q is None else run.lens_q.to(torch.int64))
    k = torch.arange(W, device=dev)[:, None]
    for r in range(Kb):
        y = y0 + r + 1
        act = y <= lens
        H, F = _row_plain(run, win, r, y, base, P, PF)
        H = torch.where(act[None], H, P)
        if PF is not None:
            F = torch.where(act[None], F, PF)
        rm = H.amax(0)
        kmax = (H == rm[None]).to(torch.int8).argmax(0)
        upd = act & (rm > maxg)
        maxg = torch.where(upd, rm, maxg)
        end_y = torch.where(upd, y, end_y)
        end_j = torch.where(upd, base + r + kmax, end_j)
        P, PF = H, F
        if run.hist is not None:
            run.hist[y - 1] = torch.where(live[None], H, 0).to(torch.int32)
    # block end: X-drop against the updated max, dead test, first argmax
    z = torch.where(P < (maxg - run.X)[None], 0, P)
    last_y = y0 + Kb  # the block's last row
    if run.hist is not None:
        run.hist[last_y - 1] = torch.where(live[None], z, 0).to(torch.int32)
        if run.lens_q is not None:
            # a pair that ends inside the block: its own final row gets the
            # X-drop too (the cutoff is known only now)
            ender = live & (lens < last_y) & (lens > y0)
            idx = ender.nonzero().flatten()
            if idx.numel():
                run.hist[lens[idx] - 1, :, idx] = z[:, idx].t().to(torch.int32)
    am_v = z.amax(0)
    am_k = (z == am_v[None]).to(torch.int8).argmax(0)
    alive = am_v > 0
    delta = torch.where(alive, (am_k - W // 2).clamp(-run.D, run.D), 0)
    src = k + delta[None]
    inr = (src >= 0) & (src < W)
    carried = torch.where(inr, z.gather(0, src.clamp(0, W - 1)), 0)
    if PF is not None:
        fz = torch.where(z == 0, EF_DEAD, PF)
        carried = torch.cat([carried, torch.where(inr, fz.gather(0, src.clamp(0, W - 1)),
                                                  EF_DEAD)])
    last = last_y >= lens
    run.bases[b] = run.state[0]
    run.deltas[b] = torch.where(live & ~last & alive, delta, 0).to(torch.int32)
    new_state = torch.stack([base + (Kb + delta) * alive, maxg, end_y, end_j])
    run.state.copy_(torch.where(live[None], new_state.to(torch.int32), run.state))
    run.carried.copy_(torch.where(live[None], carried.to(torch.int32), run.carried))
    nr = torch.minimum(lens, torch.tensor(last_y, device=dev))
    run.n_rows.copy_(torch.where(live, nr.to(torch.int32), run.n_rows))
    run.done.copy_(run.done | (live & (~alive | last)).to(torch.int32))


def rows_launch_t(run: _Run, b: int, Kb: int, win: torch.Tensor) -> None:
    """The B9 launch alone on ``run``'s device tensors (block b, Kb rows,
    the [Kb + W - 1, B] int16 window); updates them in place."""
    dev = run.qT.device
    B, W = run.B, run.W
    if dev.type != "cuda" or win.device != dev or win.dtype != torch.int16 \
            or tuple(win.shape) != (Kb + W - 1, B) or not win.is_contiguous():
        raise ValueError(
            f"the block kernel takes a contiguous [{Kb + W - 1}, {B}] int16 window on "
            f"the state's CUDA device, got {win.dtype} {tuple(win.shape)} on {win.device}")
    if run.n * W * B >= 2**31 or B * (Kb + W) >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {run.n}, {W}")
    stride = 0 if run.table is None else run.table.shape[0]
    lib, fn = _lib_fn("swtpu_block_rows", [_I] + [_P] * 11 + [_I] * 14 + [_P])
    with torch.cuda.device(dev):
        err = fn(
            int(run.affine), ptr(run.qT), ptr(win), ptr(run.table), ptr(run.lens_q),
            ptr(run.carried), ptr(run.state), ptr(run.done), ptr(run.n_rows),
            ptr(run.bases), ptr(run.deltas), ptr(run.hist),
            B, run.n, W, b, b * run.K, Kb, run.X, run.match, run.mismatch, run.gap,
            run.go or 0, run.ge or 0, run.D, stride, _cuda_stream(dev),
        )
    _build.check(lib, err, "block_rows")


def block_rows(run: _Run, b: int, Kb: int, win: torch.Tensor) -> None:
    """B9: block b's rows and block-end work for every live pair (the kernel
    on CUDA tensors, the plain version on CPU ones). Counts its launches in
    ``block_rows.launches``."""
    if run.qT.device.type == "cpu":
        block_rows_plain(run, b, Kb, win)
        return
    rows_launch_t(run, b, Kb, win)
    block_rows.launches += 1


block_rows.launches = 0


# --- B9 as one launch: the whole forward, a warp per pair -------------------

LANES = 32  # a warp: the lanes that share one pair's band


def lane_slots(W: int) -> int:
    """Slots a lane holds in the one-launch forward: ceil(W / 32); lane l
    holds slots [l * S, l * S + S), the ones past W are phantoms."""
    return -(-W // LANES)


def _lane_chain(a, first, step, S):
    """The max-plus chain x_k = max(a_k, x_{k-1} - step), x_{-1} = first,
    over [B, 32 * S] slots as a warp computes it: a serial pass over each
    lane's S slots, an inclusive Hillis-Steele scan of the lane totals over
    the 32 lanes (shift d carries d * S slots of decay), the exclusive carry
    into each lane and a second serial pass. 0 is the identity: a >= 0 and
    first >= 0, and a chain term <= 0 never wins."""
    B = a.shape[0]
    a3 = a.view(B, LANES, S)
    t = torch.zeros((B, LANES), dtype=a.dtype, device=a.device)
    t[:, 0] = first
    for s in range(S):
        t = torch.maximum(a3[:, :, s], t - step)
    d = 1
    while d < LANES:
        shifted = torch.cat([torch.zeros_like(t[:, :d]), t[:, :-d]], 1)
        t = torch.maximum(t, shifted - d * S * step)
        d *= 2
    h = torch.cat([first[:, None], t[:, :-1]], 1)
    out = torch.empty_like(a3)
    for s in range(S):
        h = torch.maximum(a3[:, :, s], h - step)
        out[:, :, s] = h
    return out.view(B, LANES * S)


def _scan_exact(run: _Run) -> bool:
    """Whether the warp's max-plus scan computes the left chain exactly:
    gap penalties >= 0 (linear gap; Gotoh's open and extend)."""
    return min(run.go, run.ge) >= 0 if run.affine else run.gap >= 0


def _stop_block(run: _Run, dlive: torch.Tensor, early_exit: bool) -> int:
    """The full blocks the host loop would run: all of them, or up to the
    first multiple of POLL past every pair's last live block."""
    NBf = run.n // run.K
    if not early_exit or dlive.numel() == 0:
        return NBf
    most = int(dlive.max())
    return min(NBf, -(-most // POLL) * POLL)


def block_forward_plain(run: _Run, early_exit: bool = True) -> _Run:
    """Plain PyTorch mirror of :func:`block_forward`'s schedule, in place on
    ``run``: each pair runs its blocks until it is done (per-pair early
    stop), reads its corridor window from ``t16`` at its base (no B10), and
    computes each row as a warp does (``lane_slots`` slots a lane, the left
    chain by :func:`_lane_chain`, the column-0 pin as a candidate: every
    slot left of it holds a negative column, dead since the start); each
    lane keeps its own best (strict >, rows then slots in order) and the
    block end reduces them (value, then least row, then least column).
    Blocks after a pair is done get its frozen base and delta 0 as far as
    the host loop of :func:`_forward` would have run them (POLL), the tail
    block always. Gap penalties >= 0 only."""
    if not _scan_exact(run):
        raise ValueError("the one-launch forward takes gap penalties >= 0")
    W, K, n, X, D = run.W, run.K, run.n, run.X, run.D
    B, dev = run.B, run.qT.device
    S = lane_slots(W)
    NS = LANES * S
    i64 = dict(dtype=torch.int64, device=dev)
    m = run.t16.shape[1]
    NBf, K_tail = divmod(n, K)
    NB = NBf + (1 if K_tail else 0)
    k = torch.arange(NS, **i64)
    valid = (k < W)[None]
    lane_of = k // S

    def slots(x, fill):  # [W, B] -> [B, NS]
        out = torch.full((B, NS), fill, **i64)
        out[:, :W] = x.t().to(torch.int64)
        return out

    affine = run.affine
    P = slots(run.carried[:W], 0)
    PF = slots(run.carried[W:], EF_DEAD) if affine else None
    base = run.state[0].to(torch.int64)
    lb_v = run.state[1].to(torch.int64)[:, None].repeat(1, LANES)
    lb_y = run.state[2].to(torch.int64)[:, None].repeat(1, LANES)
    lb_j = run.state[3].to(torch.int64)[:, None].repeat(1, LANES)
    lens = (torch.full((B,), n, **i64) if run.lens_q is None
            else run.lens_q.to(torch.int64))
    done = run.done != 0
    dlive = torch.zeros((B,), **i64)
    n_rows = run.n_rows.to(torch.int64)
    zero_col = torch.zeros((B, 1), **i64)
    for blk in range(NB):
        live = ~done
        if not bool(live.any()):
            break
        Kb = K if blk < NBf else K_tail
        y0, last_y = blk * K, blk * K + Kb
        pos = base[:, None] + torch.arange(Kb + W - 1, **i64)[None] - 1
        inside = (pos >= 0) & (pos < m)
        win = (torch.full(pos.shape, -1, **i64) if m == 0 else torch.where(
            inside, run.t16.to(torch.int64).gather(1, pos.clamp(0, m - 1)), -1))
        for r in range(Kb):
            y = y0 + r + 1
            act = live & (y <= lens)
            bpr = base + r
            qc = run.qT[y - 1].to(torch.int64)[:, None]
            s = _scores(run, qc, win[:, r + k.clamp(max=W - 1)])
            Pn = torch.cat([P[:, 1:], zero_col], 1)
            Pn[:, W - 1:] = 0
            pin = valid & ((bpr[:, None] + k) == 0)
            if not affine:
                g = run.gap
                pinv = max(X - y * g, 0)
                a = torch.maximum(torch.where(P > 0, P + s, 0),
                                  torch.where(Pn > 0, Pn - g, 0)).clamp(min=0)
                a = torch.where(valid, torch.where(pin, pinv, a), 0)
                H = _lane_chain(a, torch.where(bpr == 1, pinv, 0), g, S)
                F = None
            else:
                go, ge = run.go, run.ge
                chain = X - go - (y - 1) * ge
                pin_h = max(chain, 0)
                PFn = torch.cat([PF[:, 1:], torch.full_like(zero_col, EF_DEAD)], 1)
                PFn[:, W - 1:] = EF_DEAD
                f = torch.maximum(torch.where(PFn > EF_CUT, PFn - ge, MINF),
                                  torch.where(Pn > 0, Pn - go, MINF))
                a = torch.maximum(torch.where(P > 0, P + s, MINF), f).clamp(min=0)
                a = torch.where(valid, torch.where(pin, pin_h, a), 0)
                # E's positive part: z_k = max(a_k - go, z_{k-1} - min(go, ge)),
                # H_k = max(a_k, z_{k-1}), z_{-1} from column 0 (bpr == 1)
                zfirst = torch.where(bpr == 1, pin_h - go, 0).clamp(min=0)
                z = _lane_chain((a - go).clamp(min=0), zfirst, min(go, ge), S)
                H = torch.maximum(a, torch.cat([zfirst[:, None], z[:, :-1]], 1))
                F = torch.where(pin, chain, f)
                F = torch.where(H == 0, EF_DEAD, F.clamp(min=EF_DEAD))
                F = torch.where(valid, F, EF_DEAD)
            H = torch.where(act[:, None], H, P)
            if affine:
                F = torch.where(act[:, None], F, PF)
            for s_ in range(S):  # each lane's best, its slots in order
                col = torch.arange(LANES, device=dev) * S + s_
                v = H[:, col]
                upd = act[:, None] & (col < W)[None] & (v > lb_v)
                lb_v = torch.where(upd, v, lb_v)
                lb_y = torch.where(upd, y, lb_y)
                lb_j = torch.where(upd, bpr[:, None] + col[None], lb_j)
            P, PF = H, F
            if run.hist is not None:
                idx = live.nonzero().flatten()
                run.hist[y - 1, :, idx] = H[idx, :W].t().to(torch.int32)
        # block end: the max over the lanes, X-drop, first argmax, realign
        M = lb_v.max(1).values
        z = torch.where(valid & (P >= (M - X)[:, None]), P, 0)
        if run.hist is not None:
            idx = live.nonzero().flatten()
            run.hist[last_y - 1, :, idx] = z[idx, :W].t().to(torch.int32)
            if run.lens_q is not None:
                idx = (live & (lens < last_y) & (lens > y0)).nonzero().flatten()
                if idx.numel():
                    run.hist[lens[idx] - 1, :, idx] = z[idx, :W].to(torch.int32)
        am_v = z.max(1).values
        am_k = (z == am_v[:, None]).to(torch.int8).argmax(1)
        alive = am_v > 0
        delta = torch.where(alive, (am_k - W // 2).clamp(-D, D), 0)
        src = k[None] + delta[:, None]
        inr = valid & (src >= 0) & (src < W)
        srcc = src.clamp(0, W - 1)
        Pnew = torch.where(inr, z.gather(1, srcc), 0)
        if affine:
            PFz = torch.where(z == 0, EF_DEAD, PF)
            PFnew = torch.where(inr, PFz.gather(1, srcc), EF_DEAD)
            PF = torch.where(live[:, None], PFnew, PF)
        last = last_y >= lens
        run.bases[blk] = torch.where(live, base, run.bases[blk].to(torch.int64)).to(
            torch.int32)
        run.deltas[blk] = torch.where(live & ~last & alive, delta, 0).to(torch.int32)
        P = torch.where(live[:, None], Pnew, P)
        base = torch.where(live & alive, base + Kb + delta, base)
        n_rows = torch.where(live, torch.clamp(lens, max=last_y), n_rows)
        ended = live & (~alive | last)
        dlive = torch.where(ended, blk + 1, dlive)
        done = done | ended
    # blocks after each pair is done: its frozen base and delta 0 where the
    # host loop would have run them (the tail block always runs)
    b_stop = _stop_block(run, dlive, early_exit)
    for blk in range(NB):
        ran = blk < b_stop or blk == NBf
        frozen = done & (dlive <= blk) & ran
        run.bases[blk] = torch.where(frozen, base, run.bases[blk].to(torch.int64)).to(
            torch.int32)
        run.deltas[blk] = torch.where(frozen, 0, run.deltas[blk])
    M = lb_v.max(1).values
    at_m = lb_v == M[:, None]
    ey = torch.where(at_m, lb_y, _BIG).min(1).values
    ej = torch.where(at_m & (lb_y == ey[:, None]), lb_j, _BIG).min(1).values
    run.state.copy_(torch.stack([base, M, ey, ej]).to(torch.int32))
    carried = P[:, :W].t()
    if affine:
        carried = torch.cat([carried, PF[:, :W].t()])
    run.carried.copy_(carried.to(torch.int32))
    run.n_rows.copy_(n_rows.to(torch.int32))
    run.done.copy_(done.to(torch.int32))
    return run


def forward_launch_t(run: _Run, early_exit: bool = True) -> None:
    """The one-launch B9 alone on ``run``'s CUDA tensors (gap penalties
    >= 0); updates them in place."""
    dev = run.qT.device
    B, W, n = run.B, run.W, run.n
    if dev.type != "cuda":
        raise ValueError(f"the block kernel runs on a CUDA device, got {dev}")
    if not _scan_exact(run):
        raise ValueError("the one-launch forward takes gap penalties >= 0")
    if n * W * B >= 2**31 or B * run.t16.shape[1] >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {n}, {W}")
    stride = 0 if run.table is None else run.table.shape[0]
    scratch = torch.zeros((2 + B,), dtype=torch.int32, device=dev)
    lib, fn = _lib_fn("swtpu_block_forward", [_I] + [_P] * 12 + [_I] * 15 + [_P])
    with torch.cuda.device(dev):
        err = fn(
            int(run.affine), ptr(run.qT), ptr(run.t16), ptr(run.table),
            ptr(run.lens_q), ptr(run.carried), ptr(run.state), ptr(run.done),
            ptr(run.n_rows), ptr(run.bases), ptr(run.deltas), ptr(run.hist),
            ptr(scratch), B, n, run.t16.shape[1], W, run.K, run.X, run.match,
            run.mismatch, run.gap, run.go or 0, run.ge or 0, run.D, stride,
            int(early_exit), POLL, _cuda_stream(dev),
        )
    _build.check(lib, err, "block_forward")


def block_forward(run: _Run, early_exit: bool = True) -> _Run:
    """B9 as one launch: the whole forward, every block of every pair, a
    warp per pair (the kernel on CUDA tensors, its schedule's plain mirror
    :func:`block_forward_plain` on CPU ones). Gap penalties >= 0. Counts
    its launches in ``block_forward.launches``."""
    if run.qT.device.type == "cpu":
        return block_forward_plain(run, early_exit)
    if run.n and run.B:
        forward_launch_t(run, early_exit)
        block_forward.launches += 1
    return run


block_forward.launches = 0


def block_loop(run: _Run, early_exit: bool = True, gather=block_gather,
               rows=block_rows) -> _Run:
    """The loop over blocks: B10 then B9 per block, in place on ``run``; the
    full blocks stop early once every pair is done (checked every
    :data:`POLL` blocks), the tail block of n % K rows always runs."""
    n, K, W = run.n, run.K, run.W
    NBf, K_tail = divmod(n, K)
    for b in range(NBf):
        if early_exit and b and b % POLL == 0 and not bool((run.done == 0).any()):
            break
        rows(run, b, K, gather(run.t16, run.state[0], K + W - 1))
    if K_tail:
        rows(run, NBf, K_tail, gather(run.t16, run.state[0], K_tail + W - 1))
    return run


def _forward(run: _Run, early_exit: bool = True, plain: bool = False) -> _Run:
    """The forward (``_banded_block_impl``). On a CUDA device with gap
    penalties >= 0: one B9 launch (:func:`block_forward`). Otherwise
    :func:`block_loop`: on the card with the per-block kernels (negative
    penalties: the oracle's serial chain, which the warp's scan does not
    compute), on the CPU or with ``plain`` with their plain versions
    (what the card's checks hold the kernels against)."""
    on_card = not plain and run.qT.device.type != "cpu"
    if on_card and _scan_exact(run):
        return block_forward(run, early_exit)
    if on_card:
        return block_loop(run, early_exit)
    return block_loop(run, early_exit, block_gather_plain, block_rows_plain)


def _setup(qs, ts, match, mismatch, gap, width, block, x_threshold, dmax, matrix,
           with_history, gap_open, gap_extend, lens_q, lens_t, device):
    W, K, D = _geometry(width, block, dmax)
    gap, go, ge = _gaps(gap, gap_open, gap_extend)
    if (lens_q is not None or lens_t is not None) and go is not None:
        raise NotImplementedError("affine block tier does not take per-pair lens yet")
    dev = resolve_device(device, like=qs)
    qT, t16, lq, lt = _prep(qs, ts, lens_q, lens_t, dev)
    table = None if matrix is None else banded_table(matrix, dev)
    matrix = None if matrix is None else np.asarray(matrix)
    return _new_run(qT, t16, lq, lt, table, matrix, W, K, int(x_threshold),
                    int(match), int(mismatch), gap, go, ge, D, with_history)


def banded_block_batch(
    qs,
    ts,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    width: int = 64,
    block: int = 32,
    x_threshold: int = 70,
    dmax: Optional[int] = None,
    matrix=None,
    with_history: bool = False,
    with_meta: bool = False,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    lens_q=None,
    lens_t=None,
    device=None,
) -> BandedBlockBatchResult:
    """Batched block-adaptive banded X-drop forward pass.

    qs [B, n] / ts [B, m] codes (numpy or torch; any alphabet with
    ``matrix``, 0-3 DNA without). Bit-exact per pair against
    ``oracle.banded_block.banded_xdrop_block`` (linear) /
    ``banded_xdrop_block_affine`` (``gap_open != gap_extend``; history
    H-only, E/F host-reconstructible) with the same (width, block,
    x_threshold, dmax). ``with_meta`` also returns the per-block
    bases/deltas, ``with_history`` the int32 band history [n, W, B];
    lens_q / lens_t (linear only) run each pair at its own lengths.
    Tensors on ``device`` (default: the card).
    """
    run = _setup(qs, ts, match, mismatch, gap, width, block, x_threshold, dmax,
                 matrix, with_history, gap_open, gap_extend, lens_q, lens_t, device)
    return _result(_forward(run), with_meta)


def _result(run: _Run, with_meta: bool) -> BandedBlockBatchResult:
    return BandedBlockBatchResult(
        score=run.state[1] - run.X, end_y=run.state[2], end_j=run.state[3],
        n_rows=run.n_rows, bases=run.bases if with_meta else None,
        deltas=run.deltas if with_meta else None, band_history=run.hist,
    )


def banded_block_batch_plain(qs, ts, match=1, mismatch=1, gap=1, width=64, block=32,
                             x_threshold=70, dmax=None, matrix=None, with_history=False,
                             with_meta=False, gap_open=None, gap_extend=None,
                             lens_q=None, lens_t=None, device=None):
    """Plain version of :func:`banded_block_batch` on any device: the same
    loop with the plain B10 and B9."""
    run = _setup(qs, ts, match, mismatch, gap, width, block, x_threshold, dmax,
                 matrix, with_history, gap_open, gap_extend, lens_q, lens_t, device)
    return _result(_forward(run, plain=True), with_meta)


def banded_block_traceback_host(
    res: BandedBlockBatchResult,
    qs,
    ts,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    block: int = 32,
    x_threshold: int = 70,
    matrix=None,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
) -> List[List[Tuple[int, int]]]:
    """Host walk over a with_history + with_meta forward result: the
    oracle's walker per pair (paths bit-equal to the oracle). Affine results
    (gap_open != gap_extend) walk the Gotoh three-state path over
    host-reconstructed E/F bands."""
    from swtpu_torch.oracle.banded_block import (
        walk_block_history,
        walk_block_history_affine,
    )

    gap, gap_open, gap_extend = _gaps(gap, gap_open, gap_extend)
    res = res.numpy()
    qs, ts = (x.cpu().numpy() if isinstance(x, torch.Tensor) else x for x in (qs, ts))
    K = int(block)
    paths = []
    for p in range(len(res.score)):
        nr = int(res.n_rows[p])
        rb = res.bases[np.arange(nr) // K, p] + np.arange(nr) % K
        end = (int(res.end_y[p]), int(res.end_j[p]))
        hist = res.band_history[:nr, :, p]
        if gap_open is not None:
            paths.append(walk_block_history_affine(
                hist, rb, end, qs[p], ts[p], match=match, mismatch=mismatch,
                gap_open=gap_open, gap_extend=gap_extend, x_threshold=x_threshold,
                matrix=matrix))
        else:
            paths.append(walk_block_history(
                hist, rb, end, qs[p], ts[p], match=match, mismatch=mismatch,
                gap=gap, x_threshold=x_threshold, matrix=matrix))
    return paths


def banded_block_align_device(
    qs,
    ts,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    width: int = 64,
    block: int = 32,
    x_threshold: int = 70,
    dmax: Optional[int] = None,
    matrix=None,
    lens_q=None,
    lens_t=None,
    device=None,
):
    """Block-tier forward AND traceback on the device (linear gaps): only
    scores and 2-bit move wires cross to the host. Paths bit-equal to
    :func:`banded_block_traceback_host` / the oracle. Returns [(score,
    path)] per pair, path in the oracle's 1-based (y, j) origin -> endpoint
    convention. On the card the walk is ``device_walk.block_walk``; on the
    CPU its plain version (the oracle's walker, encoded to the same wire).
    """
    run = _setup(qs, ts, match, mismatch, gap, width, block, x_threshold, dmax,
                 matrix, True, None, None, lens_q, lens_t, device)
    _forward(run)
    return decode_device_walk(block_walk(run))


def bench_forward_fn(
    qs,
    ts,
    match=1,
    mismatch=1,
    gap=1,
    width=64,
    block=32,
    x_threshold=70,
    dmax=None,
    matrix=None,
    with_history=False,
    gap_open=None,
    gap_extend=None,
    device=None,
):
    """(fn, devargs) for timing: ``fn(qT, t16)`` runs the whole forward,
    every block (``early_exit`` off), on the staged device tensors and
    returns the [B] scores."""
    run = _setup(qs, ts, match, mismatch, gap, width, block, x_threshold, dmax,
                 matrix, with_history, gap_open, gap_extend, None, None, device)

    def fn(qT, t16):
        r = _new_run(qT, t16, None, None, run.table, run.matrix, run.W, run.K, run.X,
                     run.match, run.mismatch, run.gap, run.go, run.ge, run.D,
                     with_history)
        return _forward(r, early_exit=False).state[1] - run.X

    return fn, (run.qT, run.t16)
