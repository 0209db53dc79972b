"""Batched local-alignment scores on the anti-diagonal (wavefront)
schedule: the CUDA wavefront kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/sw_wavefront.py`` (``sw_wavefront_pallas``,
``_profile_table``). One alignment's DP matrix is swept along
anti-diagonals with one lane per query position (n <= 128) and pairs on
the other axis; any substitution matrix, linear gap only (affine raises,
as in JAX). The kernel is ``csrc/sw_wavefront.cu`` (a warp per pair),
whose head note says what it replaces, what bounds it and how.

``sw_wavefront_plain`` repeats the TPU kernel step by step on [B, 128]
tensors: the same 128 lanes (phantom ones past n score -2^20), the same
``ceil((n + m - 1) / 32) * 32`` steps, and -2^20 for codes off the
target and codes >= the alphabet. It builds each diagonal's scores as it
goes; the TPU's precomputed score stream (``_prepare``) is a workaround
for gathers on its vector unit and is not carried over.

``sw_wavefront`` runs where its device says: on the CPU the plain
version, on a CUDA device the kernel (counted in
``sw_wavefront.launches``), never the plain version there; a failed
build or launch raises. Queries longer than 128 go pair by pair to the
strip tile with zero boundaries (``longpair_strip.strip_tile``: the CUDA
strip kernel on the card, the plain tile on the CPU), as JAX routes them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import _build
from swtpu_torch.kernels.sw_batch import ptr
from swtpu_torch.utils.device import as_codes, resolve_device

SOURCE = "sw_wavefront.cu"
Q_PAD = 4
T_PAD = 5
NEG = -(2**20)
LANE = 128  # query positions per pair
STEPS_PB = 32  # the TPU's diagonals per grid step: the step count's multiple
MAX_LETTERS = 31  # the kernel's table is at most 32 x 32 with the pad row

_tables: Dict[Tuple[bytes, Tuple[int, ...], str], torch.Tensor] = {}


def _profile_table(params: ScoringParams) -> np.ndarray:
    """[A + 1, A + 1] int32: the matrix, with the pad row and column
    (code A) at -2^20."""
    A = params.alphabet_size
    tab = np.full((A + 1, A + 1), NEG, dtype=np.int32)
    tab[:A, :A] = params.matrix.astype(np.int32)
    return tab


def wavefront_steps(n: int, m: int) -> int:
    """The TPU's step count: n + m - 1 diagonals padded to 32."""
    return -(-(n + m - 1) // STEPS_PB) * STEPS_PB


def wavefront_table(params: ScoringParams, device: torch.device) -> torch.Tensor:
    """``_profile_table`` on ``device``, built once per scoring and device."""
    key = (params.matrix.tobytes(), params.matrix.shape, str(device))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= 64:
            _tables.clear()
        table = torch.as_tensor(_profile_table(params), device=device)
        _tables[key] = table
    return table


def _guard(params: ScoringParams) -> None:
    if not params.is_linear:
        raise NotImplementedError(
            "affine wavefront would need two more serial-loop shifts "
            "(E/F lane shifts); use xla_diag / rowscan tiers for Gotoh"
        )


def sw_wavefront_plain(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Plain PyTorch version of the wavefront kernel (n <= 128): [B]
    int32 scores, step for step the TPU kernel's sweep."""
    _guard(params)
    dev = resolve_device(device, like=qs)
    qs, ts = as_codes(qs, dev), as_codes(ts, dev)
    B, n = qs.shape
    m = ts.shape[1]
    if n > LANE:
        raise ValueError(f"the wavefront sweep takes n <= {LANE} (got {n})")
    A = params.alphabet_size
    gap = int(params.gap)
    n_steps = wavefront_steps(n, m)
    table = torch.as_tensor(_profile_table(params), device=dev)
    # prof[b, j, c] = S[q_b[j], c] over the A + 1 codes; phantom lanes NEG
    prof = table[qs.long().clamp(max=A)]
    if n < LANE:
        prof = torch.cat([prof, prof.new_full((B, LANE - n, A + 1), NEG)], dim=1)
    tin = torch.full((B, n_steps + 1), A + 1, dtype=torch.uint8, device=dev)
    tin[:, :m] = ts
    j_idx = torch.arange(LANE, device=dev)
    zero = torch.zeros((B, LANE), dtype=torch.int32, device=dev)
    h1, h1r, h2r, best = zero, zero, zero, zero
    for d in range(n_steps):
        # lane j at step d scores cell (j + 1, d - j + 1): target char t[d - j]
        raw = d - j_idx
        t_at = torch.where((raw < 0) | (raw > n_steps),
                           torch.full_like(raw, n_steps), raw)
        tchar = tin[:, t_at].long().clamp(max=A)
        s = prof.gather(2, tchar[:, :, None])[:, :, 0]  # column A is NEG
        h = torch.maximum(torch.maximum(h2r + s, h1 - gap),
                          torch.clamp(h1r - gap, min=0))
        best = torch.maximum(best, h)
        hr = torch.cat([zero[:, :1], h[:, :-1]], dim=1)  # lane 0 takes 0
        h1, h1r, h2r = h, hr, h1r
    return best.amax(dim=1)


def _wavefront_fn():
    lib = _build.load(SOURCE)
    fn = lib.swtpu_sw_wavefront
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def wavefront_launch_t(qs, ts, table, params: ScoringParams) -> torch.Tensor:
    """The launch alone: qs [B, n <= 128] and ts [B, m] contiguous uint8
    codes and the table of :func:`wavefront_table` on one CUDA device."""
    B, n = qs.shape
    m = ts.shape[1]
    A = params.alphabet_size
    if n > LANE or A > MAX_LETTERS:
        raise NotImplementedError(
            f"the wavefront kernel takes n <= {LANE} and <= {MAX_LETTERS} letters "
            f"(got n = {n}, {A} letters); longer queries go to the strip tile")
    for x in (qs, ts):
        if x.dtype != torch.uint8 or not x.is_contiguous() or x.device != qs.device:
            raise ValueError("the wavefront kernel takes contiguous uint8 codes "
                             "on one device")
    if ts.shape[0] != B:
        raise ValueError(f"batch mismatch: {B} queries vs {ts.shape[0]} targets")
    out = torch.empty((B,), dtype=torch.int32, device=qs.device)
    lib, fn = _wavefront_fn()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = fn(ptr(qs), ptr(ts), ptr(table), A, ptr(out), B, n, m,
                 wavefront_steps(n, m), int(params.gap), stream)
    _build.check(lib, err, "sw_wavefront")
    return out


def sw_wavefront(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Anti-diagonal schedule scores; qs: [B, n], ts: [B, m] codes (pads
    A / A + 1). Any substitution matrix, linear gap. Returns [B] int32 on
    ``device`` (default: the card), equal to the batch kernels / oracle.
    n > 128 runs each pair through the strip tile."""
    _guard(params)
    dev = resolve_device(device, like=qs)
    qs, ts = as_codes(qs, dev), as_codes(ts, dev)
    B, n = qs.shape
    if n > LANE:
        from swtpu_torch.kernels.longpair_strip import strip_tile

        m = ts.shape[1]
        zc = torch.zeros((m,), dtype=torch.int32, device=dev)
        zr = torch.zeros((n,), dtype=torch.int32, device=dev)
        outs = [strip_tile(qs[b], ts[b], zc, zr, 0, params, device=dev)[2]
                for b in range(B)]
        return (torch.stack(outs) if outs else
                torch.zeros((0,), device=dev)).to(torch.int32)
    if dev.type == "cpu":
        return sw_wavefront_plain(qs, ts, params, dev)
    out = wavefront_launch_t(qs.contiguous(), ts.contiguous(),
                             wavefront_table(params, dev), params)
    sw_wavefront.launches += 1
    return out


sw_wavefront.launches = 0
