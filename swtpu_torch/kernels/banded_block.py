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

Two kernels of ``csrc/sw_block.cu`` run each block, as JAX's
``lax.while_loop`` ran its two Pallas calls:

- B10, :func:`block_gather` (``_gather_kernel`` / ``_gather_twin``): each
  pair's corridor window, ``win[c, b] = t[b, base_b + c - 1]``, -1 outside
  the target or past its length, in the slot-major [K + W - 1, B] layout
  B9 reads (JAX's ``twin``);
- B9, :func:`block_rows` (``_block_kernel`` and ``_block_kernel_folded``,
  one kernel for both: the fold is TPU layout): the block's K rows for
  every live pair, then the block-end work (X-drop against the updated
  max, dead test, first-argmax recentering, realign) and the loop's
  bookkeeping (done mask, n_rows, bases, deltas, the history rows, the
  final-row X-drop of a varlen pair that ends inside the block), updating
  the carried rows and state in place.

The host loop launches B10 then B9 per block and asks ``done.all()`` every
:data:`POLL` blocks: frozen pairs make extra blocks no-ops. The device walk
is ``block_walk`` of ``csrc/sw_walk.cu`` (``kernels.device_walk``).

On the CPU every step runs its plain version; on a CUDA device the kernels,
never the plain versions: a failed build or launch raises. The plain B9
computes each row's left chain as a max-plus scan (a cummax in gap-rebiased
coordinates, segmented at the column-0 pin): the oracle's dead tests only
drop terms that are at most 0 when every gap penalty is >= 0, so the scan is
exact there; a negative penalty runs the oracle's serial chain over the
slots instead.
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


def _forward(run: _Run, early_exit: bool = True, plain: bool = False) -> _Run:
    """The loop over blocks (``_banded_block_impl``): B10 then B9 per block;
    the full blocks stop early once every pair is done (checked every
    :data:`POLL` blocks), the tail block of n % K rows always runs.
    ``plain``: the plain versions on any device (what the card's checks
    hold the kernels against)."""
    n, K, W = run.n, run.K, run.W
    gather = block_gather_plain if plain else block_gather
    rows = block_rows_plain if plain else block_rows
    NBf, K_tail = divmod(n, K)
    for b in range(NBf):
        if early_exit and b and b % POLL == 0 and not bool((run.done == 0).any()):
            break
        rows(run, b, K, gather(run.t16, run.state[0], K + W - 1))
    if K_tail:
        rows(run, NBf, K_tail, gather(run.t16, run.state[0], K_tail + W - 1))
    return run


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
