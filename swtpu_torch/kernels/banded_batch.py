"""Batched adaptive-banded X-drop forward pass: the CUDA kernels and their
plain PyTorch version.

Port of ``swtpu/kernels/pallas/banded_batch.py``
(``banded_xdrop_batch_pallas``), ``swtpu/kernels/pallas/banded_packed.py``
(``banded_xdrop_batch_packed``) and, past their widths, the XLA forward
``swtpu/kernels/xla/banded_scan.py::banded_xdrop_batch``, which JAX's TPU
dispatch runs for any band wider than its Pallas kernel's 96 (one
contract and one result type for all three). Both kernels are in
``csrc/sw_xdrop.cu``, whose head note says what they replace, what bounds
them and how:

- ``xdrop_round_kernel``: one warp per pair, instantiated for 1-4 band
  cells per lane, so it takes every bandwidth from 1 to
  :data:`ROUND_MAX_WIDTH` = 128 (the TPU kernels took up to 96); its W =
  32 and W = 64 instantiations serve what JAX sent to the packed kernel;
- past it, the XLA forward's counterpart on the card, on the same round
  body in two designs: ``xdrop_wide_warp_kernel``, one warp per pair with
  5-8 cells a lane, for the bands from 129 to :data:`WIDE_WARP_MAX_WIDTH`
  = 256; ``xdrop_wide_kernel``, one CTA per pair of ceil(W / 128) warps of
  128 register cells that exchange their round maxima and edge cells
  through shared-memory slots, one barrier a round, up to
  :data:`MAX_WIDTH` = 1024. Each is the faster at the widths it takes.

:func:`banded_form` names the kernel a bandwidth takes. All read the raw
[B, n] / [B, m] codes and the lengths (:func:`stage`) and pad in-kernel,
so the wrapper pads nothing. What bounds them (a pair's rounds are a
chain: the round's latency) and how they are built is in the head note of
``csrc/sw_xdrop.cu``. The plain version is the XLA tier's copy,
``banded_scan.banded_xdrop_batch``; :func:`xdrop_round_mirror` (one warp:
the warp kernel and the one-warp wide form) and :func:`xdrop_wide_mirror`
(the CTA) replay the kernels' own round schedules on the CPU (tests
only). The earlier kernel of the same source, over padded rows, stays off
every entry point (:func:`_earlier_launch_t`, timed beside it).

``banded_batch`` runs where its device says: on the CPU the plain
version, for any bandwidth; on a CUDA device a kernel, never the plain
version there: a bandwidth past :data:`MAX_WIDTH` raises
NotImplementedError naming its ROADMAP.md item, a failed build or launch
raises. Its result holds tensors on the device
(``BandedBatchResult.numpy()`` copies them to the host). It counts the
warp kernel's launches in ``banded_batch.launches`` (those at W = 32 or
64, the packed kernel's calls in JAX, also in
``banded_batch.launches_w32_w64``) and the wide band's (W > 128) in
``banded_batch.launches_wide``, those of its one-warp form also in
``banded_batch.launches_wide_warp``. ``early_exit`` is accepted and changes
nothing: each warp or CTA retires when its pair ends. The kernels write a
pair's history, ``pos_y`` and ``offsets`` only below its ``n_rounds``,
where every reader stops; past it they hold whatever the allocation held
(the plain version fills them as the XLA tier's masked rounds leave
them).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from swtpu_torch.kernels import _build
from swtpu_torch.kernels.banded_scan import (
    BandedBatchResult,
    _banded_ext_table,
    banded_xdrop_batch,
)
from swtpu_torch.kernels.sw_banded import banded_table
from swtpu_torch.kernels.sw_batch import ptr
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_xdrop.cu"
ROUND_MAX_WIDTH = 128  # the warp kernel: 32 lanes x 4 cells per lane
WIDE_WARP_MAX_WIDTH = 256  # the wide band's one-warp form: 8 cells per lane
MAX_WIDTH = 1024  # the wide band's CTA: 8 warps of 128 cells
PACKED_WIDTHS = (32, 64)


def _gaps(gap, gap_open, gap_extend):
    """gap_open == gap_extend is exactly linear (as the JAX kernels' entry
    points rule): (gap, gap_open, gap_extend)."""
    if gap_open is not None and gap_open == gap_extend:
        return int(gap_open), None, None
    if gap_open is not None:
        return int(gap), int(gap_open), int(gap_extend)
    return int(gap), None, None


def banded_form(bandwidth: int):
    """The kernel that takes a band of this width on the card: ``"round"``
    (the warp kernel, W <= 128), ``"wide_warp"`` (the wide band's one-warp
    form, 129 <= W <= 256), ``"wide"`` (the wide band's CTA, 257 <= W <=
    1024), or None (no kernel: :func:`width_refusal` says why)."""
    W = int(bandwidth)
    if 1 <= W <= ROUND_MAX_WIDTH:
        return "round"
    if ROUND_MAX_WIDTH < W <= WIDE_WARP_MAX_WIDTH:
        return "wide_warp"
    if WIDE_WARP_MAX_WIDTH < W <= MAX_WIDTH:
        return "wide"
    return None


def width_refusal(bandwidth: int):
    """Why no per-round kernel takes this bandwidth (:func:`banded_form`
    names none), or None."""
    if banded_form(bandwidth) is None:
        return (f"the per-round banded kernels take bandwidths 1..{MAX_WIDTH} (got "
                f"{bandwidth}); ROADMAP.md queue A item 18 lists the bands past "
                f"{MAX_WIDTH}: run it on the CPU")
    return None


def _xdrop_fn(name="swtpu_sw_xdrop"):
    lib = _build.load(SOURCE)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 12 + [i] * 11 + [p]
        fn.restype = ctypes.c_int
    return lib, fn


def _lens(lens, B, L, device):
    """Per-pair lengths as a contiguous int32 [B] tensor on ``device``, or
    None for every pair L long; raises outside [0, L] (checked on the host
    for host lengths)."""
    if lens is None:
        return None
    out = torch.as_tensor(np.asarray(lens) if not isinstance(lens, torch.Tensor)
                          else lens)
    if tuple(out.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(out.shape)}")
    if B and (int(out.min()) < 0 or int(out.max()) > L):
        raise ValueError(f"lengths must lie in [0, {L}]")
    return out.to(device=device, dtype=torch.int32).contiguous()


def stage(qs, ts, lens_q, lens_t, device):
    """What the kernel takes: raw codes as contiguous uint8 [B, n] / [B, m]
    on ``device`` (``as_codes``: any integer type, codes above 255 clamp to
    255) and int32 [B] lengths, or None for full rows. No padding: the
    kernel reads a position outside a pair's length, or its row, as a pad.
    Returns (q, t, lens_q, lens_t)."""
    q = as_codes(qs, device).contiguous()
    t = as_codes(ts, device).contiguous()
    B = q.shape[0]
    if t.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {t.shape[0]} targets")
    return q, t, _lens(lens_q, B, q.shape[1], device), _lens(lens_t, B, t.shape[1],
                                                            device)


def _outputs(B, n, m, W, X, with_history, compress_history, device):
    if with_history and compress_history and X > 254:
        raise ValueError("8-bit history needs x_threshold <= 254")
    R_cap = (max(n, m) + 1) * 2 - 1
    if max(B, n, m, R_cap) >= 2**31:
        raise ValueError(f"shape too large for one launch: {B}, {n}, {m}")
    i32 = dict(dtype=torch.int32, device=device)
    out = torch.empty((3, B), **i32)
    hist = posy = offs = None
    if with_history:
        hist = torch.empty((R_cap, B, W), dtype=torch.uint8 if compress_history
                           else torch.int32, device=device)
        posy = torch.empty((R_cap, B), **i32)
        if compress_history:
            offs = torch.empty((R_cap, B), **i32)
    return out[0], out[1], out[2], hist, posy, offs


def _check_table(table, device, what):
    stride = 0
    if table is not None:
        stride = table.shape[0]
        if (table.dtype != torch.int32 or table.device != device
                or table.shape != (stride, stride) or not table.is_contiguous()):
            raise ValueError(
                f"the {what} takes a square contiguous int32 table on the rows' "
                f"device, got {table.dtype} {tuple(table.shape)} on {table.device}")
    return stride


def _check_width(W, *forms):
    """The widths a launch takes, by :func:`banded_form`: those of
    ``forms`` (the CTA launch: every form's)."""
    form = banded_form(W)
    if form is None:
        raise NotImplementedError(width_refusal(W))
    if form not in forms:
        raise NotImplementedError(f"bandwidth {W} is for the {form} kernel "
                                  f"(banded_form: {form!r})")


def _launch(name, rows, lens_q, lens_t, n, m, bandwidth, x_threshold, match,
            mismatch, gap, gap_open, gap_extend, table, with_history,
            compress_history, what, forms=("round",)):
    device = rows[0].device
    W, X = int(bandwidth), int(x_threshold)
    _check_width(W, *forms)
    stride = _check_table(table, device, what)
    B = rows[0].shape[0]
    score, max_round, n_rounds, hist, posy, offs = _outputs(
        B, n, m, W, X, with_history, compress_history, device)
    lib, fn = _xdrop_fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            int(gap_open is not None), ptr(rows[0]), ptr(rows[1]), ptr(lens_q),
            ptr(lens_t), ptr(table), ptr(score), ptr(max_round), ptr(n_rounds),
            None if compress_history else ptr(hist),
            ptr(hist) if compress_history else None, ptr(posy), ptr(offs),
            B, rows[0].shape[1], rows[1].shape[1], W, X, int(match), int(mismatch),
            int(gap), int(gap_open or 0), int(gap_extend or 0), stride, stream,
        )
    _build.check(lib, err, name)
    return score, max_round, n_rounds, hist, posy, offs


def _check_staged(q, t, lens_q, lens_t, what):
    device = q.device
    B = q.shape[0]
    for x, dtype, kind in ((q, torch.uint8, "codes"), (t, torch.uint8, "codes"),
                           (lens_q, torch.int32, "lengths"),
                           (lens_t, torch.int32, "lengths")):
        if x is None and kind == "lengths":
            continue
        if (x.dtype != dtype or x.device != device or device.type != "cuda"
                or not x.is_contiguous() or x.shape[0] != B):
            raise ValueError(
                f"the {what} takes contiguous {dtype} {kind} with {B} rows on one "
                f"CUDA device, got {x.dtype} {tuple(x.shape)} on {x.device}")


def xdrop_launch_t(q, t, lens_q, lens_t, bandwidth, x_threshold, match, mismatch,
                   gap, gap_open=None, gap_extend=None, table=None,
                   with_history=True, compress_history=False):
    """The warp kernel's launch alone (W <= 128), on what :func:`stage`
    makes: q [B, n] and t [B, m] contiguous uint8 raw codes and int32 [B]
    lengths (or None: full rows), all on one CUDA device; ``table``
    (``sw_banded.banded_table``) selects the general-matrix mode; affine
    when gap_open is given. Allocates the outputs and launches on the
    device's current stream. Returns (score, max_round, n_rounds,
    band_history, pos_y, offsets); the last three None as the mode leaves
    them."""
    _check_staged(q, t, lens_q, lens_t, "per-round banded kernel")
    return _launch("swtpu_sw_xdrop", (q, t), lens_q, lens_t, q.shape[1], t.shape[1],
                   bandwidth, x_threshold, match, mismatch, gap, gap_open, gap_extend,
                   table, with_history, compress_history, "per-round banded kernel")


def xdrop_wide_launch_t(q, t, lens_q, lens_t, bandwidth, x_threshold, match,
                        mismatch, gap, gap_open=None, gap_extend=None, table=None,
                        with_history=True, compress_history=False):
    """The wide band's CTA launch alone (a CTA a pair, any W from 1 to
    :data:`MAX_WIDTH`; the wrapper sends it W > 256): the same inputs and
    outputs as :func:`xdrop_launch_t`."""
    _check_staged(q, t, lens_q, lens_t, "wide per-round banded kernel")
    return _launch("swtpu_sw_xdrop_wide", (q, t), lens_q, lens_t, q.shape[1],
                   t.shape[1], bandwidth, x_threshold, match, mismatch, gap, gap_open,
                   gap_extend, table, with_history, compress_history,
                   "wide per-round banded kernel", forms=("round", "wide_warp", "wide"))


def xdrop_wide_warp_launch_t(q, t, lens_q, lens_t, bandwidth, x_threshold, match,
                             mismatch, gap, gap_open=None, gap_extend=None, table=None,
                             with_history=True, compress_history=False):
    """The wide band's one-warp launch alone (a warp a pair, W from 129 to
    :data:`WIDE_WARP_MAX_WIDTH`): the same inputs and outputs as
    :func:`xdrop_launch_t`."""
    _check_staged(q, t, lens_q, lens_t, "wide per-round banded kernel")
    return _launch("swtpu_sw_xdrop_wide_warp", (q, t), lens_q, lens_t, q.shape[1],
                   t.shape[1], bandwidth, x_threshold, match, mismatch, gap, gap_open,
                   gap_extend, table, with_history, compress_history,
                   "wide per-round banded kernel", forms=("wide_warp",))


def _earlier_launch_t(qp, tp, lens_q, lens_t, bandwidth, x_threshold, match,
                      mismatch, gap, gap_open=None, gap_extend=None, table=None,
                      with_history=True, compress_history=False):
    """The earlier kernel (a warp per pair over padded rows, two code loads
    a cell a round), off every entry point: timed and held beside
    :func:`xdrop_launch_t`. Takes qp [B, 1 + n + W] / tp [B, 2W + m]
    contiguous int16 rows as ``banded_scan._prep_padded`` makes them and
    int32 [B] lengths on one CUDA device."""
    W = int(bandwidth)
    for x, dtype in ((qp, torch.int16), (tp, torch.int16), (lens_q, torch.int32),
                     (lens_t, torch.int32)):
        if (x.dtype != dtype or x.device != qp.device or qp.device.type != "cuda"
                or not x.is_contiguous() or x.shape[0] != qp.shape[0]):
            raise ValueError(f"the earlier per-round kernel takes contiguous {dtype} "
                             f"rows on one CUDA device, got {x.dtype} on {x.device}")
    n, m = qp.shape[1] - W - 1, tp.shape[1] - 2 * W
    if n < 0 or m < 0:
        raise ValueError(f"padded rows too short for bandwidth {W}")
    return _launch("swtpu_sw_xdrop_earlier", (qp, tp), lens_q, lens_t, n, m, W,
                   x_threshold, match, mismatch, gap, gap_open, gap_extend, table,
                   with_history, compress_history, "earlier per-round kernel")


def banded_batch_plain(qs, ts, lens_q=None, lens_t=None, match=1, mismatch=1,
                       gap=1, bandwidth=32, x_threshold=70, compress_history=False,
                       with_history=True, early_exit=False, gap_open=None,
                       gap_extend=None, matrix=None, device=None):
    """Plain PyTorch version of :func:`banded_batch` (the XLA tier's
    copy, with the same linear rule for gap_open == gap_extend)."""
    gap, gap_open, gap_extend = _gaps(gap, gap_open, gap_extend)
    return banded_xdrop_batch(
        qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth, x_threshold,
        compress_history=compress_history, with_history=with_history,
        gap_open=gap_open, gap_extend=gap_extend, matrix=matrix, device=device,
    )


def banded_batch(qs, ts, lens_q=None, lens_t=None, match=1, mismatch=1, gap=1,
                 bandwidth=32, x_threshold=70, compress_history=False,
                 with_history=True, early_exit=False, gap_open=None,
                 gap_extend=None, matrix=None, device=None) -> BandedBatchResult:
    """Batched adaptive-banded X-drop forward pass (the per-round kernel).

    Same contract and result type as ``banded_scan.banded_xdrop_batch``:
    per alignment bit-equal to the scalar banded oracle (linear gaps) /
    the affine banded oracle (gap_open != gap_extend; the history stays
    H-only, E/F are host-reconstructible, see
    ``batch.traceback.reconstruct_affine_bands``). qs: [B, n], ts: [B, m]
    codes (numpy or torch); optional per-pair lengths; ``mismatch`` is a
    positive penalty; ``matrix`` ([A, A] signed scores, up to 30 letters)
    selects the general-matrix mode. Returns a BandedBatchResult of
    tensors on ``device`` (default: the card).
    """
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return banded_batch_plain(
            qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth, x_threshold,
            compress_history, with_history, early_exit, gap_open, gap_extend,
            matrix, dev,
        )
    W = int(bandwidth)
    form = banded_form(W)
    if form is None:
        raise NotImplementedError(width_refusal(W))
    gap, gap_open, gap_extend = _gaps(gap, gap_open, gap_extend)
    launch = {"round": xdrop_launch_t, "wide_warp": xdrop_wide_warp_launch_t,
              "wide": xdrop_wide_launch_t}[form]
    out = launch(
        *stage(qs, ts, lens_q, lens_t, dev), W, x_threshold, match, mismatch, gap,
        gap_open, gap_extend, None if matrix is None else banded_table(matrix, dev),
        with_history, compress_history,
    )
    if form == "round":
        banded_batch.launches += 1
        banded_batch.launches_w32_w64 += W in PACKED_WIDTHS
    else:
        banded_batch.launches_wide += 1
        banded_batch.launches_wide_warp += form == "wide_warp"
    score, max_round, n_rounds, hist, posy, offs = out
    return BandedBatchResult(score, max_round, n_rounds, hist, posy, offs)


banded_batch.launches = 0
banded_batch.launches_w32_w64 = 0
banded_batch.launches_wide = 0
banded_batch.launches_wide_warp = 0


# -- plain mirrors of the kernels' round schedule (tests only) -------------

DEAD = -(2**29)  # a cut or dead H, kept minus the gap (csrc/sw_xdrop.cu)
_ANY = 1 << 20  # what a shuffle leaves at a band end no cut test lets through


def xdrop_round_mirror(qs, ts, lens_q=None, lens_t=None, match=1, mismatch=1,
                       gap=1, bandwidth=32, x_threshold=70, compress_history=False,
                       with_history=True, gap_open=None, gap_extend=None,
                       matrix=None) -> BandedBatchResult:
    """The warp kernel's arithmetic and schedule replayed in numpy, pair by
    pair, on the 32 * CPL physical cells of a warp (W <= 256: the warp
    kernel, and past 128 the wide band's one-warp form): H kept minus the gap
    with cut cells at -2^29, E and F floored at 0 and cleared through the
    cut test of the cell that holds them, the cut applied when a candidate
    is selected, the direction from the uncut end values, the codes held
    per cell and shifted, the entering codes from 64-code windows moved on
    between blocks of 32 rounds, phantom cells capped at 0 (targets running
    ahead in them). Band ends the kernel fills with no value (E at cell 0,
    F at the last cell) hold a large positive one here, which the cut tests
    must keep out. Same contract as :func:`banded_batch`; history, pos_y
    and offsets are 0 at and past each pair's n_rounds. Nothing on the card
    path calls it."""
    _check_width(int(bandwidth), "round", "wide_warp")
    return _round_mirror(qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth,
                         x_threshold, compress_history, with_history, gap_open,
                         gap_extend, matrix, cta=False)


def xdrop_wide_mirror(qs, ts, lens_q=None, lens_t=None, match=1, mismatch=1,
                      gap=1, bandwidth=160, x_threshold=70, compress_history=False,
                      with_history=True, gap_open=None, gap_extend=None,
                      matrix=None) -> BandedBatchResult:
    """The wide band's CTA schedule replayed in numpy, pair by pair: the
    warp kernel's round (:func:`xdrop_round_mirror`) on ceil(W / 128) warps
    of 128 cells (4 a lane), each warp shifting its own cells and taking
    its entering codes from its own windows; what crosses warps goes
    through slot sets indexed by round parity, written before the round's
    one barrier and read after it: each warp's round max and its first and
    last real cell, uncut (H - G, F of the first, E of the last). From the
    slots every warp takes the round max, band[0] and band[W - 1] for the
    direction, and its neighbours' edge cells as the fills of its shifts
    (warp w's first cell from warp w - 1's last, its last from warp w +
    1's first), so the cut lands late across warp edges too. Same contract
    as :func:`banded_batch`, for any W from 1 to :data:`MAX_WIDTH`;
    history, pos_y and offsets are 0 at and past each pair's n_rounds.
    Nothing on the card path calls it."""
    _check_width(int(bandwidth), "round", "wide_warp", "wide")
    return _round_mirror(qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth,
                         x_threshold, compress_history, with_history, gap_open,
                         gap_extend, matrix, cta=True)


def _round_mirror(qs, ts, lens_q, lens_t, match, mismatch, gap, bandwidth, x_threshold,
                  compress_history, with_history, gap_open, gap_extend, matrix, cta):
    """Both kernels' round body (csrc/sw_xdrop.cu ``xdrop_pair``): one warp
    of 32 ceil(W / 32) cells, or (``cta``) ceil(W / 128) warps of 128
    exchanging through the parity slots. The cells are [warps, C]."""
    gap, gap_open, gap_extend = _gaps(gap, gap_open, gap_extend)
    q = as_codes(qs, torch.device("cpu")).numpy().astype(np.int64)
    t = as_codes(ts, torch.device("cpu")).numpy().astype(np.int64)
    B, n = q.shape
    m = t.shape[1]
    W, X = int(bandwidth), int(x_threshold)
    if with_history and compress_history and X > 254:
        raise ValueError("8-bit history needs x_threshold <= 254")
    lq = np.full(B, n) if lens_q is None else np.asarray(lens_q, np.int64)
    lt = np.full(B, m) if lens_t is None else np.asarray(lens_t, np.int64)
    affine = gap_open is not None
    G = gap_open if affine else gap
    CPL = 4 if cta else -(-W // 32)
    C = 32 * CPL  # cells a warp
    nw = -(-W // C)
    P = C * nw
    exact = W == P
    k = np.arange(P).reshape(nw, C)  # warp w's cells C w .. C w + C - 1
    base = np.arange(nw) * C
    end_k = np.minimum(C, W - base) - 1  # each warp's last real cell
    rows = np.arange(nw)
    if matrix is not None:
        tab = _banded_ext_table(matrix).astype(np.int64)
        stride = tab.shape[0]
        tab = tab.reshape(-1) + G
    sm, smm = match + G, G - mismatch

    def raw(row, idx, L):
        idx = np.asarray(idx)
        ok = (idx >= 0) & (idx < L)
        return np.where(ok, row[np.clip(idx, 0, max(len(row) - 1, 0))] if len(row)
                        else -1, -1)

    def q_code(c):
        if matrix is not None:
            return np.where(c >= 0, np.minimum(c, stride - 1), stride - 2) * stride
        return c

    def t_code(c):
        if matrix is not None:
            return np.where(c >= 0, np.minimum(c, stride - 1), stride - 1)
        return np.where(c >= 0, c, -2)

    def score(qc, tc):
        return tab[qc + tc] if matrix is not None else np.where(qc == tc, sm, smm)

    def dn(a, fill):  # out[k] = a[k - 1] within each warp, fill at its first cell
        return np.concatenate([np.broadcast_to(fill, (nw,))[:, None], a[:, :-1]], axis=1)

    def up(a, fill):  # out[k] = a[k + 1] within each warp, fill at its last cell
        return np.concatenate([a[:, 1:], np.broadcast_to(fill, (nw,))[:, None]], axis=1)

    R_cap = (max(n, m) + 1) * 2 - 1
    score_o, max_round_o, n_rounds_o = (np.zeros(B, np.int32) for _ in range(3))
    hist = np.zeros((R_cap, B, W), np.int32)
    posy = np.zeros((R_cap, B), np.int32)
    offs = np.zeros((R_cap, B), np.int32)
    cap = np.where(k < W, 1 << 30, 0)
    for b in range(B):
        qb, tb, Lq, Lt = q[b], t[b], int(lq[b]), int(lt[b])
        rcap = (max(Lq, Lt) + 1) * 2 - 1
        # each warp's windows start at its own entering codes: a down move
        # brings query code d + W - 2 - C w to its first cell, a right move
        # target code u - W + C w + C - 1 to its last
        q_lead, t_lead = W - 1 - base, base + C - W
        qc = q_code(raw(qb, W - 2 - k, Lq))
        tc = t_code(raw(tb, k - W, Lt))
        v = np.where(k == W - 1, X, 0)
        rng = v - G
        hg = np.full((nw, C), DEAD)
        vg = np.full((nw, C), DEAD)
        e = np.zeros((nw, C), np.int64)
        f = np.zeros((nw, C), np.int64)
        d = u = 0
        ms, max_round, n_rounds = X, 0, 1
        # the windows: 64 codes from q_lead + qw and t_lead + tw, moved on by
        # 32 between blocks of 32 rounds once a block has used 32 of them;
        # the entering codes at window lanes d - qw and u - tw
        qw = tw = 0
        slots = [None, None]  # the CTA's slot sets, by round parity

        def qwin():
            assert 0 <= d - qw < 64
            return q_code(raw(qb, q_lead[:, None] + qw + np.arange(64), Lq))

        def twin():
            assert 0 <= u - tw < 64
            return t_code(raw(tb, t_lead[:, None] + tw + np.arange(64), Lt))

        def write(r, cut, y):
            res = np.where(v >= max(cut, 1), v, 0).reshape(-1)[:W]
            hist[r, b] = np.where(res > 0, res - cut + 1, 0) if compress_history else res
            posy[r, b], offs[r, b] = y, cut

        def candidates(r):
            """The next round's operands for both moves, uncut, and what the
            direction needs: (candidates, round max, band[0], band[W - 1])."""
            qsd, tsu = dn(qc, qwin()[:, d - qw]), up(tc, twin()[:, u - tw])
            sd, su, ed, fu = dn(rng, DEAD), up(rng, DEAD), dn(e, _ANY), up(f, _ANY)
            if cta:  # before the barrier: publish; after it: read
                slots[r % 2] = dict(max=v.max(axis=1), first_h=rng[:, 0], first_f=f[:, 0],
                                    last_h=rng[rows, end_k], last_e=e[rows, end_k])
                s = slots[r % 2]
                sd[1:, 0], ed[1:, 0] = s["last_h"][:-1], s["last_e"][:-1]
                su[:-1, -1], fu[:-1, -1] = s["first_h"][1:], s["first_f"][1:]
                ends = int(s["max"].max()), s["first_h"][0] + G, s["last_h"][-1] + G
            else:
                ends = int(v.max()), v[0, 0], v[0, W - 1]
            return (sd, su, qsd, tsu, vg + score(qc, tsu), hg + score(qsd, tc), ed, fu), ends

        write(0, 0, 0)
        (sd, su, qsd, tsu, dr, dd, ed, fu), (_, b0, bw) = candidates(0)
        right = bw > max(b0, -1)
        thr = 1 - G
        for r in range(1, rcap):
            if (u >= W + Lt) if right else (d > Lq):
                break
            hs = rng if right else sd
            vs = su if right else rng
            dg = dr if right else dd
            hp, vp = hs >= thr, vs >= thr
            hg = np.where(hp, hs, DEAD)
            vg = np.where(vp, vs, DEAD)
            if affine:
                e = np.maximum(np.maximum(np.where(hp, e if right else ed, 0) - gap_extend,
                                          hg), 0)
                f = np.maximum(np.maximum(np.where(vp, fu if right else f, 0) - gap_extend,
                                          vg), 0)
                x = np.maximum(np.maximum(np.maximum(dg, e), f), 0)
            else:
                x = np.maximum(np.maximum(np.maximum(dg, hg), vg), 0)
            if not exact:
                x = np.minimum(x, cap)
            v, rng = x, x - G
            qc = qc if right else qsd
            tc = tsu if right else tc
            u, d = u + right, d + (not right)
            (sd, su, qsd, tsu, dr, dd, ed, fu), (rmax, b0, bw) = candidates(r)
            if rmax > ms:
                ms, max_round = rmax, r
            cut = ms - X
            thr = max(cut, 1) - G
            right = bw > max(b0, cut - 1)
            n_rounds = r + 1
            write(r, cut, d)
            if rmax == 0:
                break
            if r % 32 == 0:  # between blocks
                qw += 32 * (d - qw >= 32)
                tw += 32 * (u - tw >= 32)
        score_o[b], max_round_o[b], n_rounds_o[b] = ms - X, max_round, n_rounds
    out = [torch.from_numpy(x) for x in (score_o, max_round_o, n_rounds_o)]
    if not with_history:
        return BandedBatchResult(*out, None, None)
    hist = torch.from_numpy(hist.astype(np.uint8) if compress_history else hist)
    return BandedBatchResult(*out, hist, torch.from_numpy(posy),
                             torch.from_numpy(offs) if compress_history else None)
