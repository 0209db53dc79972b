"""The port's kernel wrappers (at device="cpu") vs the Pallas kernels.

swtpu_torch.kernels.sw_batch / sw_affine run their plain PyTorch versions
on a CPU tensor; the JAX side runs the Pallas row-scan kernels in
interpret mode, as tests/test_pallas_kernels.py does. Same numpy inputs
(seed 10000), scores and endpoints equal, tolerance 0. The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.core.scoring import DNA_10_30_15, ScoringParams, dna_matrix
from swtpu.kernels.pallas.sw_affine import sw_affine_pallas, sw_affine_pallas_ends
from swtpu.kernels.pallas.sw_batch import (
    _uniform_match_mismatch,
    sw_batch_pallas,
    sw_batch_pallas_ends,
)
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import sw_affine as port_affine
from swtpu_torch.kernels import sw_batch as port_batch

TIE_RICH = ScoringParams.linear(dna_matrix(2, -1), 1)
AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
AFF_TIE = ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1)

# (port wrapper, Pallas entry, scoring on shape A, scoring on shape B)
CASES = {
    "sw_batch": (port_batch.sw_batch, sw_batch_pallas, DNA_10_30_15, TIE_RICH),
    "sw_batch_ends": (
        port_batch.sw_batch_ends, sw_batch_pallas_ends, DNA_10_30_15, TIE_RICH,
    ),
    "sw_affine": (port_affine.sw_affine, sw_affine_pallas, AFF, AFF_TIE),
    "sw_affine_ends": (
        port_affine.sw_affine_ends, sw_affine_pallas_ends, AFF, AFF_TIE,
    ),
}
# B=50 (not a multiple of the TPU's 1024-pair tile); shape B has a query
# pad tail from column 70 and a width that is not a multiple of 8
SHAPES = {"50x40x48": (40, 48, None), "50x90x128_padtail": (90, 128, 70)}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def tup(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kernel", list(CASES))
def test_wrapper_on_cpu_equals_pallas(kernel, shape):
    fn, pallas_fn, p_a, p_b = CASES[kernel]
    n, m, pad_from = SHAPES[shape]
    p = p_a if pad_from is None else p_b
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(50, n)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(50, m)).astype(np.uint8)
    if pad_from is not None:
        qs[:, pad_from:] = 4
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(x) for x in tup(pallas_fn(qs, ts, p))]
    before = fn.launches
    got = tup(fn(qs, ts, port(p), device="cpu"))
    assert fn.launches == before  # the CPU runs the plain version, no launch
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kernel", list(CASES))
def test_guard_rejects_general_matrix(kernel):
    fn = CASES[kernel][0]
    mat = np.array(
        [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]
    )
    gap_open = 2 if kernel.startswith("sw_batch") else 3
    p = scoring_from_numpy(mat, gap_open, 2)
    q = np.zeros((2, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="profile kernel"):
        fn(q, q, p, device="cpu")


@pytest.mark.parametrize("kernel", list(CASES))
def test_guard_rejects_nonpositive_gap(kernel):
    fn = CASES[kernel][0]
    p = scoring_from_numpy(dna_matrix(2, -1), 0, 0)
    q = np.zeros((2, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="gap"):
        fn(q, q, p, device="cpu")


@pytest.mark.parametrize("kernel", ["sw_batch", "sw_batch_ends"])
def test_linear_wrapper_rejects_affine(kernel):
    q = np.zeros((2, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="sw_affine"):
        CASES[kernel][0](q, q, port(AFF), device="cpu")


def test_uniform_match_mismatch_equals_jax():
    rng = np.random.default_rng(10000)
    for p in (DNA_10_30_15, TIE_RICH, AFF, ScoringParams.linear(
        rng.integers(-5, 5, size=(4, 4)), 2
    )):
        assert port_batch._uniform_match_mismatch(port(p)) == (
            _uniform_match_mismatch(p)
        )
