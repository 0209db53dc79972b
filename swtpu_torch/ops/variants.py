"""Engine dispatch: the fastest engine for a scoring system on a device.

Port of ``swtpu/ops/variants.py`` (``best_engine``, ``best_ends_engine``,
``resolve_engine``, ``cached_build``). The rule:

- on a CUDA device, uniform linear scoring (gap > 0) goes to the
  ``sw_batch`` kernels and uniform affine scoring (gap_open,
  gap_extend > 0) to the ``sw_affine`` kernels. Any other scoring raises
  NotImplementedError pointing to ROADMAP.md: the card never runs the
  plain tier in a kernel's place;
- on the CPU the plain anti-diagonal tier serves every scoring system.

Unlike the JAX dispatch there is no ``try/except NotImplementedError``
around a kernel: the wrappers' own guards (``sw_batch._guard_linear``,
``sw_affine._guard_affine``) run where the engine is chosen, and one that
fails, fails there.
"""

from __future__ import annotations

from typing import Callable

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.affine_scan import (
    sw_affine_batch_diag,
    sw_affine_batch_diag_ends,
)
from swtpu_torch.kernels.sw_affine import _guard_affine, sw_affine, sw_affine_ends
from swtpu_torch.kernels.sw_batch import _guard_linear, sw_batch, sw_batch_ends
from swtpu_torch.kernels.sw_scan import sw_batch_diag, sw_batch_diag_ends
from swtpu_torch.utils.device import resolve_device


def best_ends_engine(params: ScoringParams, device=None) -> Callable:
    """fn(qs, ts) -> (score, end_i, end_j) int32 [B] tensors on ``device``
    (default: the card). Endpoints are the 1-based argmax cell under the
    first-max-in-row-major-scan rule; score 0 maps to (0, 0). Used by the
    traceback engines to bound the host walk to the [0..end_i, 0..end_j]
    submatrix."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        if params.is_linear:
            return lambda q, t: sw_batch_diag_ends(q, t, params, dev)
        return lambda q, t: sw_affine_batch_diag_ends(q, t, params, dev)
    if params.is_linear:
        _guard_linear(params)
        return lambda q, t: sw_batch_ends(q, t, params, dev)
    _guard_affine(params)
    return lambda q, t: sw_affine_ends(q, t, params, dev)


def best_engine(params: ScoringParams, device=None) -> Callable:
    """fn(qs, ts) -> [B] int32 scores on ``device`` (default: the card):
    the CUDA row-scan kernels on the card, the plain tier on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        if params.is_linear:
            return lambda q, t: sw_batch_diag(q, t, params, dev)
        return lambda q, t: sw_affine_batch_diag(q, t, params, dev)
    if params.is_linear:
        _guard_linear(params)
        return lambda q, t: sw_batch(q, t, params, dev)
    _guard_affine(params)
    return lambda q, t: sw_affine(q, t, params, dev)


def resolve_engine(params: ScoringParams, engine=None, device=None):
    """(engine, cache_key) for keyed engine caches.

    With no caller engine, returns ``best_engine(params, device)`` keyed
    by the scoring values and the device (stable across calls). A
    caller-owned engine is keyed on the object itself — not ``id()``:
    ids are recycled after gc; the cache entry keeps the object alive,
    which is what makes the key stable.
    """
    if engine is not None:
        return engine, engine
    dev = resolve_device(device)
    return best_engine(params, dev), (
        params.matrix.tobytes(), params.gap_open, params.gap_extend, str(dev),
    )


def cached_build(cache: dict, key, build, cap: int = 64):
    """cache[key], building (and inserting) on miss; a full cache (``cap``
    entries) is cleared first, so a process sweeping many keys rebuilds
    rather than grows."""
    fn = cache.get(key)
    if fn is None:
        if len(cache) >= cap:
            cache.clear()
        fn = build()
        cache[key] = fn
    return fn
