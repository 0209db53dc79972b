"""The port's Karlin-Altschul statistics (``swtpu_torch/core/stats.py``)
against the JAX package's (``swtpu/core/stats.py``): the cases of
``tests/test_stats.py``, each value bit-equal to JAX's (both compute the
same numpy expressions), and ``calibrate_stats`` on ``device="cpu"``
(the port's plain tier) giving the same lambda and K as JAX's XLA tier
at m = 64, 512 pairs. Seed 10000, tolerance 0."""

import dataclasses
import math

import numpy as np
import pytest

from swtpu.core import stats as jst
from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu_torch.core import stats as pst
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import ScoringParams, dna_matrix


def _jp(p):
    return JaxScoring(p.matrix, p.gap_open, p.gap_extend)


def test_lambda_closed_form():
    lam = pst.karlin_lambda(dna_matrix(1, -1), pst.DNA_UNIFORM_FREQS)
    assert abs(lam - math.log(3.0)) < 1e-8
    assert lam == jst.karlin_lambda(dna_matrix(1, -1), jst.DNA_UNIFORM_FREQS)


def test_lambda_and_H_blosum62_equal_jax():
    lam = pst.karlin_lambda(BLOSUM62, pst.ROBINSON_FREQS)
    assert lam == jst.karlin_lambda(BLOSUM62, jst.ROBINSON_FREQS)
    assert abs(lam - 0.3176) < 5e-4
    H = pst.karlin_H(BLOSUM62, pst.ROBINSON_FREQS, lam=lam)
    assert H == jst.karlin_H(BLOSUM62, jst.ROBINSON_FREQS, lam=lam)
    assert abs(H - 0.4012) < 5e-4
    for a in ("dna", "protein"):
        assert (pst.background_freqs(a) == jst.background_freqs(a)).all()


@pytest.mark.parametrize("mod", [pst, jst])
def test_lambda_rejects_non_negative_expectation(mod):
    with pytest.raises(ValueError, match="expected score"):
        mod.karlin_lambda(dna_matrix(2, 1), mod.DNA_UNIFORM_FREQS)


def test_ungapped_stats_equal_jax():
    got = pst.ungapped_stats(BLOSUM62, "protein")
    assert got.source == "ungapped-exact" and got.K == 0.134
    assert (got.lam, got.K, got.H) == tuple(
        getattr(jst.ungapped_stats(BLOSUM62, "protein"), f) for f in ("lam", "K", "H"))
    with pytest.raises(ValueError, match="calibrate_stats"):
        pst.ungapped_stats(dna_matrix(1, -1), "dna")


@pytest.mark.parametrize("params,alphabet", [
    (ScoringParams(BLOSUM62, gap_open=11, gap_extend=1), "protein"),
    (ScoringParams.linear(BLOSUM62, 11), "protein"),
    (ScoringParams.linear(dna_matrix(1, -1), 1), "dna"),
    (ScoringParams(BLOSUM62, gap_open=5, gap_extend=2), "protein"),
])
def test_preset_lookup_equals_jax(params, alphabet):
    got = pst.preset_stats(params, alphabet)
    want = jst.preset_stats(_jp(params), alphabet)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.lam, got.K, got.H, got.source) == (want.lam, want.K, want.H,
                                                        want.source) == (0.267, 0.041,
                                                                         0.14, "preset")
    for mod, p in ((pst, params), (jst, _jp(params))):
        if want is None:
            with pytest.raises(ValueError, match="no tabulated"):
                mod.resolve_stats(p, alphabet, mode="preset")
        else:
            assert dataclasses.astuple(mod.resolve_stats(p, alphabet, mode="auto")) == \
                dataclasses.astuple(want)
    assert pst.resolve_stats(params, alphabet, mode="none") is None


@pytest.mark.parametrize("seed,mu0,beta0,size", [(10000, 42.0, 5.5, 40000), (3, 10.0, 2.0, 5000)])
def test_gumbel_fit_equals_jax(seed, mu0, beta0, size):
    x = np.random.default_rng(seed).gumbel(mu0, beta0, size=size)
    mu, beta = pst.gumbel_fit_ml(x)
    assert (mu, beta) == jst.gumbel_fit_ml(x)
    assert abs(mu - mu0) < 0.15 and abs(beta - beta0) < 0.15
    mu2, beta2 = pst.gumbel_fit_ml(x + 100.0)  # shift-equivariant
    assert abs((mu2 - mu) - 100.0) < 1e-6 and abs(beta2 - beta) < 1e-8
    with pytest.raises(ValueError, match="16 samples"):
        pst.gumbel_fit_ml(x[:8])


@pytest.mark.parametrize("H", [None, 0.14])
def test_bitscore_evalue_equal_jax(H):
    pk, jk = pst.KAStats(0.267, 0.041, H), jst.KAStats(0.267, 0.041, H)
    S = np.array([0, 17, 87, 300])
    assert pst.bit_score(S, pk).tobytes() == jst.bit_score(S, jk).tobytes()
    for m, n, N in ((128, 300, 1000), (64, 64, 1), (1, 1, 5)):
        got = pst.e_value(S, m, n, pk, db_seqs=N)
        assert got.tobytes() == jst.e_value(S, m, n, jk, db_seqs=N).tobytes()
        assert (pst.e_value(S, m, n, pk, effective=False).tobytes()
                == jst.e_value(S, m, n, jk, effective=False).tobytes())
    if H is None:  # E == m n N 2^-bits, the defining identity
        bits = float(pst.bit_score(87, pk))
        ev = float(pst.e_value(87, 128, 300, pk, db_seqs=1000))
        assert abs(ev - 128 * 300 * 1000 * 2.0 ** (-bits)) < 1e-12 * ev


@pytest.mark.parametrize("m,n", [(128, 300), (1024, 10**6), (1, 1), (2, 50)])
def test_length_adjustment_equals_jax(m, n):
    st, jt = pst.KAStats(0.267, 0.041, 0.14), jst.KAStats(0.267, 0.041, 0.14)
    assert pst.length_adjustment(st, m, n) == jst.length_adjustment(jt, m, n)
    assert pst.length_adjustment(pst.KAStats(1.0, 0.1, None), m, n) == 0


@pytest.mark.parametrize("params,kw", [
    (ScoringParams.linear(dna_matrix(1, -1), 1), dict(m=64, pairs=512, seed=10000)),
    (ScoringParams(dna_matrix(1, -1), gap_open=2, gap_extend=1),
     dict(m=24, n=64, pairs=256, seed=1)),
])
def test_calibrate_equals_jax(params, kw):
    got = pst.calibrate_stats(params, "dna", device="cpu", **kw)
    want = jst.calibrate_stats(_jp(params), "dna", **kw)
    assert (got.lam, got.K, got.H, got.source) == (want.lam, want.K, want.H, want.source)
    assert got.source == "calibrated" and got.H is None
    assert 0.2 < got.lam < math.log(3.0) + 0.5 and 1e-6 < got.K < 10.0
    # resolve_stats calibrates at the caller's geometry on the device given
    again = pst.resolve_stats(params, "dna", mode="auto", calibrate_pairs=kw["pairs"],
                              seed=kw["seed"], m=kw["m"], n=kw.get("n"), device="cpu")
    assert again == got
