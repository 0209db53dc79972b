"""Engine dispatch: the fastest engine for a scoring system on a device.

Port of ``swtpu/ops/variants.py`` (``best_engine``, ``best_ends_engine``,
``resolve_engine``, ``cached_build``). The rule (:func:`local_form`):

- on a CUDA device, uniform linear scoring with gap > 0 goes to the
  ``sw_batch`` kernels, uniform Gotoh with gap_open, gap_extend > 0 to the
  ``sw_affine`` kernels, any other matrix (4x4 DNA, BLOSUM62, up to 30
  letters) with entries in [-127, 127] and gaps > 0 to the ``sw_profile``
  kernels, and every scoring those guards refuse (a gap of 0 or below,
  Gotoh with gap_extend <= 0, entries past [-127, 127]) to the
  ``sw_general`` kernel, where JAX's TPU dispatch falls through to its XLA
  tier. The card never runs the plain tier in a kernel's place; only an
  alphabet past 30 letters, which the plain tier refuses too, raises
  NotImplementedError, when the engine is built;
- on the CPU the plain anti-diagonal tier serves every scoring system.

Unlike the JAX dispatch there is no ``try/except NotImplementedError``
around a kernel: the wrappers' own guards (``sw_batch.linear_refusal``,
``sw_affine.affine_refusal``, ``sw_profile.profile_refusal``) decide the
form before anything launches, and a failed launch raises.

``VARIANTS`` is the registry of named score engines (``align
--engine``), JAX's names in JAX's order: ``oracle`` (the numpy oracle),
``xla_diag`` (the plain anti-diagonal tier), ``wavefront`` (the
anti-diagonal kernel, ``kernels/sw_wavefront.py``), ``colscan`` (the
column-parallel plain tier), ``rowscan``, ``rowscan_prof`` and
``rowscan_bf16`` (the row-scan kernels). The plain tiers' names
(``xla_diag``, ``colscan``) run on the CPU only. Each name has a guard
predicate (``variant_supported``), and ``variant_engine`` picks from the
predicates, before anything runs, the engine the CLI uses.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.affine_scan import (
    sw_affine_batch_diag,
    sw_affine_batch_diag_ends,
)
from swtpu_torch.kernels.colscan import sw_batch_colscan
from swtpu_torch.kernels.sw_affine import affine_refusal, sw_affine, sw_affine_ends
from swtpu_torch.kernels.sw_batch import (
    _uniform_match_mismatch,
    linear_refusal,
    sw_batch,
    sw_batch_ends,
)
from swtpu_torch.kernels.sw_bf16 import bf16_tier_supported, padded_rows, sw_bf16
from swtpu_torch.kernels.sw_general import general_refusal, sw_general, sw_general_ends
from swtpu_torch.kernels.sw_profile import (
    profile_refusal,
    sw_profile,
    sw_profile_ends,
)
from swtpu_torch.kernels.sw_scan import sw_batch_diag, sw_batch_diag_ends
from swtpu_torch.kernels.sw_wavefront import sw_wavefront, wavefront_refusal
from swtpu_torch.utils.device import resolve_device


def local_form(params: ScoringParams):
    """The kernel family that takes ``params`` on the card: ``"rowscan"``
    (uniform, linear gap > 0), ``"affine"`` (uniform Gotoh, gaps > 0),
    ``"profile"`` (any other matrix with entries in [-127, 127], gaps > 0),
    ``"general"`` (every other scoring up to 30 letters), or None (no
    kernel, nor the plain tier: ``sw_general.general_refusal`` says why).
    A pure function of the scoring: nothing is launched."""
    if general_refusal(params):
        return None
    if _uniform_match_mismatch(params) is None:
        return "profile" if profile_refusal(params) is None else "general"
    if params.is_linear:
        return "rowscan" if linear_refusal(params) is None else "general"
    return "affine" if affine_refusal(params) is None else "general"


def _cuda_kernel(params: ScoringParams, ends: bool) -> Callable:
    """The kernel wrapper that takes ``params`` on the card
    (:func:`local_form`)."""
    form = local_form(params)
    if form is None:
        raise NotImplementedError(general_refusal(params))
    if form == "rowscan":
        return sw_batch_ends if ends else sw_batch
    if form == "affine":
        return sw_affine_ends if ends else sw_affine
    if form == "profile":
        return sw_profile_ends if ends else sw_profile
    return sw_general_ends if ends else sw_general


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
    kernel = _cuda_kernel(params, ends=True)
    return lambda q, t: kernel(q, t, params, dev)


def best_engine(params: ScoringParams, device=None) -> Callable:
    """fn(qs, ts) -> [B] int32 scores on ``device`` (default: the card):
    the CUDA row-scan, profile or general kernel on the card
    (:func:`local_form`), the plain tier on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        if params.is_linear:
            return lambda q, t: sw_batch_diag(q, t, params, dev)
        return lambda q, t: sw_affine_batch_diag(q, t, params, dev)
    kernel = _cuda_kernel(params, ends=False)
    return lambda q, t: kernel(q, t, params, dev)


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


def _oracle(qs, ts, params: ScoringParams, device=None):
    from swtpu_torch.oracle import sw_score_batch

    return sw_score_batch(np.asarray(qs), np.asarray(ts), params).astype(
        np.int32
    )


def _xla_diag(qs, ts, params: ScoringParams, device=None):
    dev = resolve_device(device, like=qs)
    if dev.type != "cpu":
        raise NotImplementedError(
            "xla_diag is the plain tier and runs on the CPU only; on the "
            "card use best_engine"
        )
    return sw_batch_diag(qs, ts, params, dev)


def _wavefront(qs, ts, params: ScoringParams, device=None):
    return sw_wavefront(qs, ts, params, device)


def _colscan(qs, ts, params: ScoringParams, device=None):
    return sw_batch_colscan(qs, ts, params, device)


def _rowscan(qs, ts, params: ScoringParams, device=None):
    return sw_batch(qs, ts, params, device)


def _rowscan_prof(qs, ts, params: ScoringParams, device=None):
    return sw_profile(qs, ts, params, device)


def _rowscan_bf16(qs, ts, params: ScoringParams, device=None):
    return sw_bf16(qs, ts, params, device=device)


#: fn(qs, ts, params, device=None) -> [B] int32 scores, by name
VARIANTS: Dict[str, Callable] = {
    "oracle": _oracle,
    "xla_diag": _xla_diag,
    "wavefront": _wavefront,
    "colscan": _colscan,
    "rowscan": _rowscan,
    "rowscan_prof": _rowscan_prof,
    "rowscan_bf16": _rowscan_bf16,
}


def get_variant(name: str) -> Callable:
    if name not in VARIANTS:
        raise KeyError(f"unknown variant {name!r}; have {sorted(VARIANTS)}")
    return VARIANTS[name]


def variant_supported(name: str, params: ScoringParams, n: int,
                      on_card: bool = False) -> bool:
    """Whether variant ``name`` takes this scoring at query length ``n``:
    the guard of its wrapper, as a predicate (KeyError for an unknown
    name); ``on_card``: the guard it runs on a CUDA device (the wavefront
    kernel takes a linear gap of any sign, as its plain version does)."""
    get_variant(name)
    if name == "wavefront" and on_card:
        return wavefront_refusal(params) is None
    if name == "rowscan":
        return linear_refusal(params) is None
    if name == "rowscan_prof":
        return profile_refusal(params) is None
    if name == "rowscan_bf16":
        return bf16_tier_supported(params, padded_rows(n))
    # oracle, xla_diag, wavefront, colscan: the linear engines (align
    # uses variants only under linear scoring)
    return params.is_linear


#: the plain tiers' names: on the card their place is best_engine's
PLAIN_TIERS = ("xla_diag", "colscan")


def variant_engine(name: str, params: ScoringParams, n: int,
                   device=None) -> Callable:
    """fn(qs, ts) -> [B] int32 scores for ``align --engine name`` on
    [B, n] queries. A registered name whose predicate passes runs its
    own engine; on the card a plain tier's name (``xla_diag``,
    ``colscan``), and anywhere a name whose predicate fails or that the
    registry lacks, run ``best_engine`` (on the card a kernel, on the CPU
    the plain tier), as JAX falls back to its XLA tier. Decided before
    anything runs."""
    dev = resolve_device(device)
    if (name in VARIANTS and not (dev.type != "cpu" and name in PLAIN_TIERS)
            and variant_supported(name, params, n, on_card=dev.type != "cpu")):
        fn = VARIANTS[name]
        return lambda q, t: fn(q, t, params, dev)
    return best_engine(params, dev)
