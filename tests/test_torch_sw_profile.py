"""The port's profile wrappers (at device="cpu") vs the JAX package.

swtpu_torch.kernels.sw_profile runs its plain PyTorch version on a CPU
tensor; the JAX side runs the Pallas packed-profile kernel in interpret
mode, as tests/test_pallas_kernels.py does, or the XLA tier where the
Pallas entry refuses the shape. Same numpy inputs (seed 10000), scores
and endpoints equal, tolerance 0. Scorings cross with
``scoring_from_numpy``. The CUDA kernel itself is held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

The Pallas kernel scores pads at -128 and the XLA tier (and the port) at
-2^20; the two agree on tail pads, which is all the Pallas cases use.
Internal pads are compared with the XLA tier only.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.core.protein import BLOSUM62
from swtpu.core.scoring import ScoringParams, dna_matrix
from swtpu.kernels.pallas.sw_profile import (
    sw_batch_profile_pallas,
    sw_batch_profile_pallas_ends,
)
from swtpu.kernels.xla.affine_scan import (
    sw_affine_batch_diag,
    sw_affine_batch_diag_ends,
)
from swtpu.kernels.xla.sw_scan import sw_batch_diag, sw_batch_diag_ends
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import sw_batch as port_batch
from swtpu_torch.kernels import sw_profile as port_profile
from swtpu_torch.kernels.sw_scan import _extended_table

DNA_MATRIX = np.array(
    [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]
)
SCORINGS = {
    "blosum62_linear11": ScoringParams.linear(BLOSUM62, 11),
    "blosum62_gotoh11_1": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1),
    "dna_general_linear2": ScoringParams.linear(DNA_MATRIX, 2),
}
WRAPPERS = {
    "scores": (port_profile.sw_profile, sw_batch_profile_pallas),
    "ends": (port_profile.sw_profile_ends, sw_batch_profile_pallas_ends),
}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def tup(x):
    return x if isinstance(x, tuple) else (x,)


def codes(rng, shape, alphabet_size):
    hi = 20 if alphabet_size == 24 else alphabet_size
    return rng.integers(0, hi, size=shape).astype(np.uint8)


def padded_inputs(p, B=50, n=90, m=100, pad_q=70, pad_t=90):
    """B = 50 (not a multiple of the TPU's 1024-pair tile); n = 90 > 64,
    so the Pallas kernel streams row groups; query tail pads from pad_q,
    target tail pads from pad_t on half of the pairs."""
    A = p.alphabet_size
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, (B, n), A), codes(rng, (B, m), A)
    qs[:, pad_q:] = A
    ts[: B // 2, pad_t:] = A + 1
    return qs, ts


def assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("which", list(WRAPPERS))
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_wrapper_on_cpu_equals_pallas(scoring, which):
    fn, pallas_fn = WRAPPERS[which]
    p = SCORINGS[scoring]
    qs, ts = padded_inputs(p)
    with pltpu.force_tpu_interpret_mode():
        want = tup(pallas_fn(qs, ts, p))
    before = (fn.launches, fn.launches_affine)
    got = tup(fn(qs, ts, port(p), device="cpu"))
    assert (fn.launches, fn.launches_affine) == before  # plain version ran
    assert_equal(got, want)
    assert int(got[0].max()) > 0


def test_long_targets_equal_pallas_and_xla():
    """4 x (40 x 2560): the Pallas scores entry transposes such a shape
    (m > 2048 >= n) and its ends entry refuses it (VMEM); the port runs
    it as it is, and must equal both."""
    p = SCORINGS["blosum62_linear11"]
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, (4, 40), 24), codes(rng, (4, 2560), 24)
    with pltpu.force_tpu_interpret_mode():
        want = sw_batch_profile_pallas(qs, ts, p)
    assert_equal(tup(port_profile.sw_profile(qs, ts, port(p), device="cpu")),
                 (want,))
    assert_equal(port_profile.sw_profile_ends(qs, ts, port(p), device="cpu"),
                 sw_batch_diag_ends(qs, ts, p))
    with pytest.raises(NotImplementedError):
        sw_batch_profile_pallas_ends(qs, ts, p)


XLA = {
    "linear": (sw_batch_diag, sw_batch_diag_ends),
    "affine": (sw_affine_batch_diag, sw_affine_batch_diag_ends),
}


@pytest.mark.parametrize("which", ["scores", "ends"])
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_plain_with_internal_pads_equals_xla(scoring, which):
    """The plain versions (the kernel's reference) against the XLA tier,
    internal pads in queries and targets included."""
    p = SCORINGS[scoring]
    A = p.alphabet_size
    qs, ts = padded_inputs(p, B=24, n=37, m=45, pad_q=33, pad_t=41)
    rng = np.random.default_rng(10001)
    qs[rng.random(qs.shape) < 0.05] = A
    ts[rng.random(ts.shape) < 0.05] = A + 1
    ts[:3, 5] = A  # a query-side pad code inside a target
    scores_fn, ends_fn = XLA["linear" if p.is_linear else "affine"]
    if which == "scores":
        got = (port_profile.sw_profile_plain(qs, ts, port(p), device="cpu"),)
        want = (scores_fn(qs, ts, p),)
    else:
        got = port_profile.sw_profile_ends_plain(qs, ts, port(p), device="cpu")
        want = ends_fn(qs, ts, p)
    assert_equal(got, want)


@pytest.mark.parametrize("params", [
    scoring_from_numpy(np.where(np.eye(4, dtype=bool), 200, -1), 2, 2),
    scoring_from_numpy(np.where(np.eye(4, dtype=bool), 1, -128), 2, 2),
    scoring_from_numpy(np.eye(31, dtype=np.int32), 2, 2),
    scoring_from_numpy(DNA_MATRIX, 0, 0),
    scoring_from_numpy(DNA_MATRIX, 3, 0),
    scoring_from_numpy(DNA_MATRIX, 0, 1),
])
@pytest.mark.parametrize("which", list(WRAPPERS))
def test_guard_raises_outside_the_kernel(params, which):
    q = np.zeros((2, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        WRAPPERS[which][0](q, q, params, device="cpu")


def test_guard_passes_a_uniform_matrix():
    """As in JAX, a uniform matrix passes the profile guard (the dispatch,
    not the guard, sends it to the row-scan kernels), and the result
    equals the row-scan wrapper's."""
    p = scoring_from_numpy(dna_matrix(10, -30), 15, 15)
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, (16, 24), 4), codes(rng, (16, 30), 4)
    for got, want in (
        (port_profile.sw_profile(qs, ts, p, device="cpu"),
         port_batch.sw_batch(qs, ts, p, device="cpu")),
        (port_profile.sw_profile_ends(qs, ts, p, device="cpu"),
         port_batch.sw_batch_ends(qs, ts, p, device="cpu")),
    ):
        for g, w in zip(tup(got), tup(want)):
            assert torch.equal(g, w)


def test_profile_table_is_the_plain_tiers_table():
    cpu = torch.device("cpu")
    for p, stride in ((SCORINGS["dna_general_linear2"], 8),
                      (SCORINGS["blosum62_gotoh11_1"], 32)):
        t = port_profile.profile_table(port(p), cpu)
        assert t.dtype == torch.int32 and tuple(t.shape) == (stride, stride)
        np.testing.assert_array_equal(t.numpy(), _extended_table(port(p)))
        assert port_profile.profile_table(port(p), cpu) is t  # built once
        assert int(t[p.alphabet_size:].max()) == -(2**20)
        assert int(t[:, p.alphabet_size:].max()) == -(2**20)
