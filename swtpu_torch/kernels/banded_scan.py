"""Batched adaptive-banded X-drop semi-global alignment (forward pass) —
the plain PyTorch tier.

Port of ``swtpu/kernels/xla/banded_scan.py`` (``banded_xdrop_batch``,
``BandedBatchResult``, ``_banded_ext_table``, ``_prep_padded``): a
behavioural mirror of the scalar banded oracle
(``SemiGlobal_AdaptiveBanded_XDrop_111_32_70``, source.cpp:1836-1976,
``oracle.semiglobal.banded_xdrop``), vectorized over a batch of
alignments. It is the plain version of the per-round kernel
(``kernels/banded_batch.py``): the engine on the CPU, and what
``chip_smoke.py`` holds the kernel against on the card.

Per round (one anti-diagonal per round, y + x == round), on [B, W]
tensors:
- direction: right iff band[0] < band[W-1], ties go down (source.cpp:1891);
- band state shifts (horizontal/vertical/diagonal) exactly as
  source.cpp:1893-1907, with 0 = dead cell that never propagates
  (source.cpp:1922-1924);
- scores offset by +x_threshold; X-dropped cells zeroed; an all-dead round
  or a boundary overrun ends that alignment (masked "done", since pairs in
  a batch finish at different rounds);
- band history + per-round positions are returned for the host traceback
  (``batch.traceback.banded_traceback``).

The XLA tier's per-block prefetch queues (a TPU gather cost) are not
carried over: each round gathers its band's characters directly. The
loop stops once every pair is done (checked every 32 rounds) and fills
the remaining rounds as the XLA tier's masked rounds leave them: history
and positions 0, offsets the final max_score - X.

Also here, as in the XLA module: ``banded_xdrop_align_device`` (forward
and traceback on the device, only scores and move strings to the host;
``_banded_fwd_walk_impl``'s walk is ``device_walk.xdrop_walk``) and
``decode_device_walk``, the numpy decoder of the 2-bit move wire that both
device walkers write (JAX decodes in C++ when its native module is built;
both give the same tuples).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from swtpu_torch.utils.device import as_codes, resolve_device

EF_DEAD = -(2**28)  # dead E/F (oracle/banded_affine.py)
MINF = -(2**30)  # no contribution inside a round


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class BandedBatchResult:
    score: "torch.Tensor | np.ndarray"  # [B] final scores (offset removed)
    max_round: "torch.Tensor | np.ndarray"  # [B]
    n_rounds: "torch.Tensor | np.ndarray"  # [B] rounds written (history valid below)
    band_history: "torch.Tensor | np.ndarray | None"  # [R, B, W] int32 / uint8 / None
    pos_y: "torch.Tensor | np.ndarray | None"  # [R, B]
    #: per-round offsets when the history is 8-bit compressed (else None).
    #: Live cells store v - offset[r] + 1 in [1, X+1]; 0 = dead. This is the
    #: reference's own 8-bit trick: X-drop guarantees live values lie within
    #: x_threshold of the running max, so a per-round offset rebias keeps the
    #: band in 8 bits (offset_diff accumulation, source.cpp:2105-2119).
    offsets: "torch.Tensor | np.ndarray | None" = None

    def history_for(self, b: int) -> np.ndarray:
        """Reconstructed int32 band history for alignment b (host array)."""
        h = _host(self.band_history[:, b])
        if self.offsets is None:
            return h
        h = h.astype(np.int32)
        off = _host(self.offsets[:, b])[:, None]
        return np.where(h > 0, h - 1 + off, 0)

    def numpy(self) -> "BandedBatchResult":
        """The same result with every field a host numpy array."""
        return BandedBatchResult(*(
            None if x is None else _host(x)
            for x in (self.score, self.max_round, self.n_rounds,
                      self.band_history, self.pos_y, self.offsets)
        ))


def _banded_ext_table(matrix) -> np.ndarray:
    """Extended substitution table for the banded family: any pad index
    scores matrix.min() (the banded oracles' pad contract — the uniform
    mode's 'pads score -mismatch' generalized)."""
    matrix = np.asarray(matrix, dtype=np.int32)
    A = matrix.shape[0]
    stride = 8 if A <= 6 else 32
    if A + 2 > stride:
        raise NotImplementedError(f"alphabet of {A} letters unsupported")
    ext = np.full((stride, stride), int(matrix.min()), dtype=np.int32)
    ext[:A, :A] = matrix
    return ext


def _prep_padded(qs, ts, lens_q, lens_t, bandwidth, device,
                 dtype=torch.int32):
    """Padded rows for the forward: qp [B, 1+n+W] / tp [B, W+m+W] of
    ``dtype`` on ``device`` with -1 (≙ 0xF0) pads and -1 past each
    pair's length, per the oracle's layout; lens as int64 [B] tensors."""
    qs = as_codes(qs, device)
    ts = as_codes(ts, device)
    B, n = qs.shape
    m = ts.shape[1]
    if ts.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {ts.shape[0]} targets")
    W = int(bandwidth)

    def lens_of(lens, L):
        if lens is None:
            return torch.full((B,), L, dtype=torch.int64, device=device)
        out = torch.as_tensor(lens, device=device).to(torch.int64)
        if tuple(out.shape) != (B,):
            raise ValueError(f"lengths must be [{B}], got {tuple(out.shape)}")
        if B and (int(out.min()) < 0 or int(out.max()) > L):
            raise ValueError(f"lengths must lie in [0, {L}]")
        return out

    lq, lt = lens_of(lens_q, n), lens_of(lens_t, m)
    pad = torch.tensor(-1, dtype=dtype, device=device)
    qp = torch.full((B, 1 + n + W), -1, dtype=dtype, device=device)
    tp = torch.full((B, W + m + W), -1, dtype=dtype, device=device)
    qp[:, 1:1 + n] = torch.where(
        torch.arange(n, device=device)[None, :] < lq[:, None], qs.to(dtype), pad)
    tp[:, W:W + m] = torch.where(
        torch.arange(m, device=device)[None, :] < lt[:, None], ts.to(dtype), pad)
    return qp, tp, lq, lt


def _shift_down(a, fill):  # out[k] = a[k-1], out[0] = fill
    return torch.cat([torch.full_like(a[:, :1], fill), a[:, :-1]], dim=1)


def _shift_up(a, fill):  # out[k] = a[k+1], out[W-1] = fill
    return torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], dim=1)


def banded_xdrop_batch(
    qs,
    ts,
    lens_q=None,
    lens_t=None,
    match=1,
    mismatch=1,
    gap=1,
    bandwidth=32,
    x_threshold=70,
    compress_history=False,
    with_history=True,
    gap_open=None,
    gap_extend=None,
    matrix=None,
    device=None,
) -> BandedBatchResult:
    """Batched adaptive-banded X-drop forward pass.

    qs: [B, n], ts: [B, m] codes (numpy or torch); optional per-pair
    lengths (defaults full width). Returns a BandedBatchResult of int32
    tensors on ``device`` (default: the card; the history int32, or uint8
    with ``offsets`` when ``compress_history``), field for field equal to
    the JAX XLA tier's and, per alignment, to
    ``oracle.banded_xdrop(..., return_state=True)`` (linear gaps) /
    ``oracle.banded_affine.banded_affine_xdrop`` (gap_open != gap_extend;
    as in the XLA tier, gap_open == gap_extend runs the linear recurrence
    with ``gap``). ``matrix`` ([A, A] signed scores) selects the
    general-matrix / protein mode (match/mismatch ignored).
    with_history=False returns scores and rounds only (band_history and
    pos_y None).
    """
    if with_history and compress_history and x_threshold > 254:
        raise ValueError("8-bit history needs x_threshold <= 254")
    dev = resolve_device(device, like=qs)
    W = int(bandwidth)
    X = int(x_threshold)
    if W < 1:
        raise ValueError(f"bandwidth must be >= 1, got {W}")
    qp, tp, lq, lt = _prep_padded(qs, ts, lens_q, lens_t, W, dev)
    affine = gap_open is not None and gap_open != gap_extend
    go, ge = (int(gap_open), int(gap_extend)) if affine else (0, 0)
    gap, match, mismatch = int(gap), int(match), int(mismatch)
    B = qp.shape[0]
    n_max = qp.shape[1] - W - 1
    m_max = tp.shape[1] - 2 * W
    R_cap = (max(n_max, m_max) + 1) * 2 - 1
    if matrix is not None:
        table = torch.as_tensor(_banded_ext_table(matrix), device=dev)
        stride = table.shape[0]
        table = table.reshape(-1)

    i32 = dict(dtype=torch.int32, device=dev)
    k = torch.arange(W, device=dev)[None, :]
    result = torch.zeros((B, W), **i32)
    result[:, W - 1] = X
    horizontal = torch.zeros((B, W), **i32)
    vertical = torch.zeros((B, W), **i32)
    now_y = torch.zeros((B,), dtype=torch.int64, device=dev)
    now_x = torch.full((B,), W - 1, dtype=torch.int64, device=dev)
    max_score = torch.full((B,), X, **i32)
    max_round = torch.zeros((B,), **i32)
    n_rounds = torch.ones((B,), **i32)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    if affine:
        e_band = torch.full((B, W), EF_DEAD, **i32)
        f_band = torch.full((B, W), EF_DEAD, **i32)
    rcap = (torch.maximum(lq, lt) + 1) * 2 - 1
    zero = torch.zeros((), **i32)
    if with_history:
        hist = torch.zeros((R_cap, B, W), **i32)
        hist[0] = result
        posy = torch.zeros((R_cap, B), **i32)
        offs = torch.zeros((R_cap, B), **i32)

    for r in range(1, R_cap):
        right = result[:, 0] < result[:, W - 1]
        rt = right[:, None]
        diagonal = torch.where(rt, vertical, horizontal)
        h_new = torch.where(rt, result, _shift_down(result, 0))
        v_new = torch.where(rt, _shift_up(result, 0), result)
        nx = now_x + right
        ny = now_y + ~right
        # a boundary overrun ends the alignment BEFORE this round is
        # recorded (source.cpp:1898-1900, 1909-1911); so does the per-pair
        # round cap (max(n, m) + 1) * 2 - 1
        overrun = torch.where(right, nx > W + lt + W - 1, ny > lq + 1)
        done_pre = done | overrun | (r >= rcap)
        active = ~done_pre
        yc = qp.gather(1, (ny[:, None] + (W - 1) - k).clamp(max=qp.shape[1] - 1))
        xc = tp.gather(1, (nx[:, None] - (W - 1) + k).clamp(max=tp.shape[1] - 1))
        if matrix is None:
            sc = torch.where((yc >= 0) & (xc >= 0) & (yc == xc), match,
                             -mismatch).to(torch.int32)
        else:
            # pad rows/cols of the table hold matrix.min()
            qi = torch.where(yc >= 0, yc.clamp(max=stride - 1), stride - 2)
            ti = torch.where(xc >= 0, xc.clamp(max=stride - 1), stride - 1)
            sc = table[qi * stride + ti]
        r_new = torch.where(diagonal != 0, torch.clamp(diagonal + sc, min=0), zero)
        if affine:
            he = torch.where(rt, e_band, _shift_down(e_band, EF_DEAD))
            vf = torch.where(rt, _shift_up(f_band, EF_DEAD), f_band)
            e_new = torch.maximum(
                torch.where(he > EF_DEAD // 2, he - ge, MINF),
                torch.where(h_new != 0, h_new - go, MINF),
            )
            f_new = torch.maximum(
                torch.where(vf > EF_DEAD // 2, vf - ge, MINF),
                torch.where(v_new != 0, v_new - go, MINF),
            )
            r_new = torch.maximum(r_new, torch.where(e_new > MINF // 2, e_new, zero))
            r_new = torch.maximum(r_new, torch.where(f_new > MINF // 2, f_new, zero))
        else:
            r_new = torch.where(h_new != 0, torch.maximum(r_new, h_new - gap), r_new)
            r_new = torch.where(v_new != 0, torch.maximum(r_new, v_new - gap), r_new)
        round_max = r_new.amax(dim=1)

        upd = active & (max_score < round_max)
        max_score = torch.where(upd, round_max, max_score)
        max_round = torch.where(upd, r, max_round)
        r_new = torch.where(r_new < (max_score[:, None] - X), zero, r_new)

        # freeze the state of finished pairs
        at = active[:, None]
        result = torch.where(at, r_new, result)
        horizontal = torch.where(at, h_new, horizontal)
        vertical = torch.where(at, v_new, vertical)
        now_y = torch.where(active, ny, now_y)
        now_x = torch.where(active, nx, now_x)
        n_rounds = torch.where(active, r + 1, n_rounds)
        done = done_pre | (active & (round_max == 0))
        if affine:
            e_band = torch.where(at, torch.where(r_new == 0, EF_DEAD, e_new), e_band)
            f_band = torch.where(at, torch.where(r_new == 0, EF_DEAD, f_new), f_band)
        if with_history:
            # live cells sit in (max_score - X, max_score]; the offset
            # rebias below is what lets callers keep the history in 8 bits
            hist[r] = torch.where(at, r_new, zero)
            posy[r] = torch.where(active, ny.to(torch.int32), zero)
            offs[r] = max_score - X
        if r % 32 == 0 and bool(done.all()):
            if with_history:
                offs[r + 1:] = max_score - X
            break

    score = max_score - X
    if not with_history:
        return BandedBatchResult(score, max_round, n_rounds, None, None)
    if compress_history:
        # 8-bit history, compressed on the device
        hist = torch.where(hist > 0, hist - offs[:, :, None] + 1, zero).to(torch.uint8)
        return BandedBatchResult(score, max_round, n_rounds, hist, posy, offs)
    return BandedBatchResult(score, max_round, n_rounds, hist, posy)


def banded_xdrop_align_device(
    qs,
    ts,
    lens_q=None,
    lens_t=None,
    match=1,
    mismatch=1,
    gap=1,
    bandwidth=32,
    x_threshold=70,
    matrix=None,
    device=None,
):
    """Batched adaptive-banded X-drop alignment, forward AND traceback on
    the device (linear gaps). Output bit-equal to ``banded_align_batch``'s
    host walk; only scores and move strings cross to the host. On the card
    the forward is a per-round kernel (``banded_batch.banded_batch``, int32
    history: the warp kernel up to W = 128, the wide kernel up to 1024) and
    the walk ``device_walk.xdrop_walk`` (its ring of chunks sized by W,
    ``device_walk.default_chunk``); on the CPU their plain versions.
    Returns [(score, path)] per pair."""
    from swtpu_torch.kernels.banded_batch import banded_batch
    from swtpu_torch.kernels.device_walk import xdrop_walk

    dev = resolve_device(device, like=qs)
    W = int(bandwidth)
    res = banded_batch(qs, ts, lens_q, lens_t, match, mismatch, gap, W, x_threshold,
                       with_history=True, compress_history=False, matrix=matrix,
                       device=dev)
    padded = _prep_padded(qs, ts, lens_q, lens_t, W, dev, torch.int16)
    wire = xdrop_walk(res, padded, W, x_threshold, match, mismatch, gap, matrix)
    return decode_device_walk(wire)


def decode_device_walk(wire, as_arrays=False):
    """Host decode of the device walkers' wire format: per pair 20 bytes of
    meta (score, start_y, start_x, n_steps, ok: little-endian int32)
    followed by 2-bit packed moves (0 diag, 1 up, 2 left, 3 done).

    Default: [(score, path)] tuple lists with the host walkers' path
    convention (origin -> start cell). ``as_arrays=True`` returns (scores
    int32 [B], path_len int32 [B], paths int32 [B, max_points, 2]) instead.
    A pair whose walk stalled (ok 0) raises AssertionError, as the host
    walkers do. The C++ decoder (``swtpu_torch.native.decode_move_wire``)
    does the bit unpacking, as in the JAX package; numpy where
    ``native.available`` says False.
    """
    from swtpu_torch import native

    wire = np.ascontiguousarray(_host(wire))
    if native.available():
        scores, plen, paths = native.decode_move_wire(wire)
        if as_arrays:
            return scores, plen, paths
        # two columns zipped into tuples: a list a point would cost twice
        return [(int(scores[b]), list(zip(paths[b, : plen[b], 0].tolist(),
                                          paths[b, : plen[b], 1].tolist())))
                for b in range(wire.shape[0])]
    meta = np.ascontiguousarray(wire[:, :20]).view("<i4").T  # [5, B]
    packed = wire[:, 20:]
    score, sy, sx, nsteps, ok = meta
    moves = (packed[:, :, None] >> (np.arange(4, dtype=np.uint8) * 2)[None, None]) & 3
    moves = moves.reshape(packed.shape[0], -1)
    out, arrs = [], []
    for b in range(packed.shape[0]):
        if not ok[b]:
            raise AssertionError(f"inconsistent device banded traceback at pair {b}")
        mv = moves[b, : nsteps[b]].astype(np.int64)
        ys = np.concatenate([[sy[b]], sy[b] - np.cumsum((mv == 0) | (mv == 1))])
        xs = np.concatenate([[sx[b]], sx[b] - np.cumsum((mv == 0) | (mv == 2))])
        if as_arrays:
            arrs.append(np.stack([ys[::-1], xs[::-1]], axis=1))
            continue
        out.append((int(score[b]), list(zip(ys[::-1].tolist(), xs[::-1].tolist()))))
    if as_arrays:
        paths = np.zeros((packed.shape[0], 4 * packed.shape[1] + 1, 2), np.int32)
        for b, a in enumerate(arrs):
            paths[b, : len(a)] = a
        return score.astype(np.int32), (nsteps + 1).astype(np.int32), paths
    return out
