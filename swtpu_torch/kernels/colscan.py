"""Column-parallel Smith-Waterman schedule: the plain PyTorch tier.

Port of ``swtpu/kernels/xla/colscan.py`` (JAX has no Pallas kernel
here). One pair is vectorised across the query; a loop walks the target
positions. Within a target column the vertical-gap chain has a closed
form,

    H[p] = max(pre[p], H[p-1] - gap) = max_{q <= p} (pre[q] - (p - q) * gap),

a max-plus prefix scan with linear decay, computed by log2(n) doubling
steps over static shifts (no lazy-F loop). Per-column scores come from a
per-pair query profile and the alphabet select tree
(``sw_scan.select_scores``); codes >= the alphabet score -2^20.

It is the ``colscan`` member of ``ops.variants.VARIANTS``: a plain tier
that runs on the CPU. On the card it raises, as the other plain tiers'
variants do; ``align --engine colscan`` runs ``best_engine`` there.
"""

from __future__ import annotations

import torch

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.sw_scan import _extended_table, select_scores
from swtpu_torch.utils.device import as_codes, resolve_device

NEG = -(2**29)


def _profile(qs, table, stride):
    """prof[b, i, c] = S[q_b[i], c] (c over the extended alphabet)."""
    q_pad = stride - 2
    return table[qs.long().clamp(max=q_pad)]  # [B, n, stride]


def _maxplus_prefix(pre, gap, n):
    """H[p] = max_{q <= p}(pre[q] - (p - q) * gap) by log-doubling over
    static shifts."""
    x = pre
    shift = 1
    while shift < n:
        shifted = torch.cat([x.new_full((x.shape[0], shift), NEG), x[:, :-shift]],
                            dim=1)
        x = torch.maximum(x, shifted - shift * gap)
        shift *= 2
    return x


def _setup(qs, ts, params, dev):
    table = torch.as_tensor(_extended_table(params), device=dev)
    stride = table.shape[0]
    qs, ts = as_codes(qs, dev), as_codes(ts, dev)
    ts = ts.long().clamp(max=stride - 1)
    return _profile(qs, table, stride), ts, qs.shape[1], ts.shape[1]


def _colscan_impl(qs, ts, params, dev):
    prof, ts, n, m = _setup(qs, ts, params, dev)
    gap = int(params.gap)
    A = params.alphabet_size
    B = prof.shape[0]
    h_prev = torch.zeros((B, n), dtype=torch.int32, device=dev)
    best = torch.zeros((B,), dtype=torch.int32, device=dev)
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for j in range(m):
        s = select_scores(prof, ts[:, j:j + 1], A)  # [B, n]
        diag = torch.cat([zcol, h_prev[:, :-1]], dim=1)
        pre = torch.clamp(torch.maximum(diag + s, h_prev - gap), min=0)
        # exact vertical-gap propagation: max-plus prefix scan down the query
        h = torch.clamp(_maxplus_prefix(pre, gap, n), min=0)
        best = torch.maximum(best, h.amax(dim=1))
        h_prev = h
    return best


def _colscan_affine_impl(qs, ts, params, dev):
    """Gotoh column scan. With go >= ge the vertical F chain decouples:
    F[p] = max_{q <= p-1} (pre[q] - go - (p-1-q) * ge), the same max-plus
    prefix over pre - go with decay ge, shifted down one. E is
    element-wise from the previous column."""
    prof, ts, n, m = _setup(qs, ts, params, dev)
    go, ge = int(params.gap_open), int(params.gap_extend)
    A = params.alphabet_size
    B = prof.shape[0]
    h_prev = torch.zeros((B, n), dtype=torch.int32, device=dev)
    e_prev = torch.full((B, n), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros((B,), dtype=torch.int32, device=dev)
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    ncol = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    for j in range(m):
        s = select_scores(prof, ts[:, j:j + 1], A)
        e = torch.maximum(e_prev - ge, h_prev - go)
        diag = torch.cat([zcol, h_prev[:, :-1]], dim=1)
        pre = torch.clamp(torch.maximum(diag + s, e), min=0)
        fscan = _maxplus_prefix(pre - go, ge, n)
        f = torch.cat([ncol, fscan[:, :-1]], dim=1)
        h = torch.maximum(pre, f)
        best = torch.maximum(best, h.amax(dim=1))
        h_prev, e_prev = h, e
    return best


def sw_batch_colscan(qs, ts, params: ScoringParams, device=None) -> torch.Tensor:
    """Batched SW scores, column-parallel schedule, linear or affine, on
    the CPU: [B] int32. Same contract as ``sw_batch_diag`` (pads q: A,
    t: A + 1; variable length free). Affine needs gap_open >= gap_extend
    (the F-chain decoupling). A CUDA device raises: this plain tier has
    no kernel."""
    dev = resolve_device(device, like=qs)
    if dev.type != "cpu":
        raise NotImplementedError(
            "colscan is a plain tier and runs on the CPU only; on the card "
            "use best_engine"
        )
    if not params.is_linear:
        if params.gap_open < params.gap_extend:
            raise NotImplementedError(
                "colscan affine needs gap_open >= gap_extend"
            )
        return _colscan_affine_impl(qs, ts, params, dev)
    return _colscan_impl(qs, ts, params, dev)
