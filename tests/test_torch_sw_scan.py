"""The port's plain anti-diagonal tiers vs the JAX XLA tier, exactly.

swtpu_torch.kernels.sw_scan / affine_scan (PyTorch, CPU) against
swtpu.kernels.xla.sw_scan / affine_scan (JAX, CPU) on the same numpy
inputs (seed 10000), scores and endpoints, tolerance 0. Every port-side
scoring system is carried across with ``scoring_from_numpy``.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.core.scoring import DNA_10_30_15, DNA_111, ScoringParams, dna_matrix
from swtpu.kernels.xla.affine_scan import (
    sw_affine_batch_diag,
    sw_affine_batch_diag_ends,
)
from swtpu.kernels.xla.sw_scan import sw_batch_diag, sw_batch_diag_ends
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import affine_scan as port_affine
from swtpu_torch.kernels import sw_scan as port_scan

TIE_RICH = ScoringParams.linear(dna_matrix(2, -1), 1)
MISMATCH_NONNEG = ScoringParams.linear(dna_matrix(1, 1), 1)
AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
AFF_TIE = ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1)
AFF_EQ = ScoringParams(dna_matrix(10, -30), gap_open=15, gap_extend=15)

LINEAR = {
    "10_30_15": DNA_10_30_15,
    "111": DNA_111,
    "tie_rich": TIE_RICH,
    "mismatch_nonneg": MISMATCH_NONNEG,
}
AFFINE = {"10_30_40_15": AFF, "tie_rich": AFF_TIE, "open_eq_extend": AFF_EQ}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def inputs(B=48, n=70, m=96, pad_q=55, pad_t=80):
    """Random DNA with pad tails: queries from pad_q (code 4), half of the
    targets from pad_t (code 5), plus one pad inside a query."""
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(B, m)).astype(np.uint8)
    qs[:, pad_q:] = 4
    ts[: B // 2, pad_t:] = 5
    qs[0, n // 3] = 4
    return qs, ts


def as_np(xs):
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("name", list(LINEAR))
def test_plain_linear_scores_equal_xla(name):
    p = LINEAR[name]
    qs, ts = inputs()
    want = np.asarray(sw_batch_diag(qs, ts, p))
    got = port_scan.sw_batch_diag(qs, ts, port(p), device="cpu")
    assert got.dtype == torch.int32 and got.shape == (qs.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(LINEAR))
def test_plain_linear_ends_equal_xla(name):
    p = LINEAR[name]
    qs, ts = inputs(B=40, n=37, m=53, pad_q=30, pad_t=45)
    want = as_np(sw_batch_diag_ends(qs, ts, p))
    got = port_scan.sw_batch_diag_ends(qs, ts, port(p), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", list(AFFINE))
def test_plain_affine_scores_equal_xla(name):
    p = AFFINE[name]
    qs, ts = inputs()
    want = np.asarray(sw_affine_batch_diag(qs, ts, p))
    got = port_affine.sw_affine_batch_diag(qs, ts, port(p), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(AFFINE))
def test_plain_affine_ends_equal_xla(name):
    p = AFFINE[name]
    qs, ts = inputs(B=40, n=37, m=53, pad_q=30, pad_t=45)
    want = as_np(sw_affine_batch_diag_ends(qs, ts, p))
    got = port_affine.sw_affine_batch_diag_ends(qs, ts, port(p), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_plain_affine_open_eq_extend_equals_linear():
    qs, ts = inputs()
    lin = port_scan.sw_batch_diag_ends(qs, ts, port(DNA_10_30_15), device="cpu")
    aff = port_affine.sw_affine_batch_diag_ends(qs, ts, port(AFF_EQ), device="cpu")
    for a, b in zip(lin, aff):
        assert torch.equal(a, b)


def test_plain_score_zero_maps_to_origin():
    q = np.zeros((1, 16), np.uint8)
    t = np.full((1, 16), 1, np.uint8)
    sc, ei, ej = port_scan.sw_batch_diag_ends(q, t, port(DNA_10_30_15), device="cpu")
    assert (sc.item(), ei.item(), ej.item()) == (0, 0, 0)


def test_port_scoring_helpers_match_jax():
    from swtpu.kernels.xla.sw_scan import _extended_table, pad_codes

    for p in list(LINEAR.values()) + list(AFFINE.values()):
        q = port(p)
        assert q.is_linear == p.is_linear and q.alphabet_size == p.alphabet_size
        np.testing.assert_array_equal(
            port_scan._extended_table(q), _extended_table(p)
        )
        assert port_scan.pad_codes(q) == pad_codes(p)
    assert (port_scan.Q_PAD, port_scan.T_PAD) == (4, 5)
