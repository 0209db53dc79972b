"""The wavefront and column-scan schedules on the CPU against the JAX
package (seed 10000, tolerance 0).

- ``sw_wavefront`` (the plain version of the CUDA wavefront kernel on
  the CPU) equals one interpret-mode ``sw_wavefront_pallas`` call (8 x
  100 x 150, DNA (1,-1,1)) and the oracle on pads, n < 128, n = 128 and
  protein; n > 128 goes through the strip tile; affine raises;
- ``sw_batch_colscan`` equals JAX's, linear and affine, and refuses
  affine with gap_open < gap_extend as JAX does; both schedules are
  ``VARIANTS`` members and ``align --engine`` runs them on the CPU.
"""

import numpy as np
import pytest
import torch

from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu_torch import cli
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_10_30_15, DNA_111, ScoringParams, dna_matrix
from swtpu_torch.kernels import colscan, sw_wavefront
from swtpu_torch.ops import variants
from swtpu_torch.oracle.sw import sw_score_batch

SEED = 10000


def _jp(p):
    return JaxScoring(p.matrix, p.gap_open, p.gap_extend)


def _codes(rng, B, n, m, letters=4):
    return (rng.integers(0, letters, (B, n)).astype(np.uint8),
            rng.integers(0, letters, (B, m)).astype(np.uint8))


def test_wavefront_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    from swtpu.kernels.pallas.sw_wavefront import sw_wavefront_pallas

    qs, ts = _codes(np.random.default_rng(SEED), 8, 100, 150)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(sw_wavefront_pallas(qs, ts, _jp(DNA_111)))
    got = sw_wavefront.sw_wavefront(qs, ts, DNA_111, device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, sw_score_batch(qs, ts, DNA_111))


@pytest.mark.parametrize("B,n,m,name", [
    (16, 128, 128, "dna_10_30_15"), (12, 60, 128, "dna_111"), (9, 7, 1, "dna_111"),
    (10, 128, 40, "blosum"), (6, 33, 300, "g4"),
])
def test_wavefront_matches_oracle_on_pads(B, n, m, name):
    p = {"dna_10_30_15": DNA_10_30_15, "dna_111": DNA_111,
         "blosum": ScoringParams.linear(BLOSUM62, 11),
         "g4": ScoringParams.linear(np.arange(16).reshape(4, 4) % 5 - 2, 2)}[name]
    rng = np.random.default_rng(SEED + n)
    qs, ts = _codes(rng, B, n, m, 20 if p.alphabet_size > 4 else 4)
    A = p.alphabet_size
    # tail pads of each length, and in-length pads on both sides
    for b in range(B):
        qs[b, int(rng.integers(1, n + 1)):] = A
        ts[b, int(rng.integers(1, m + 1)):] = A + 1
    qs[rng.random(qs.shape) < 0.05] = A
    # the oracle on the matrix extended by the two pad codes at -2^20
    ext = np.full((A + 2, A + 2), -(2**20))
    ext[:A, :A] = p.matrix
    want = sw_score_batch(qs, ts, ScoringParams.linear(ext, p.gap))
    got = sw_wavefront.sw_wavefront(qs, ts, p, device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(sw_wavefront.sw_wavefront_plain(qs, ts, p, "cpu").numpy(),
                          want)


def test_wavefront_long_queries_go_to_the_strip_tile(monkeypatch):
    from swtpu_torch.kernels import longpair_strip

    calls = []
    strip = longpair_strip.strip_tile
    monkeypatch.setattr(longpair_strip, "strip_tile",
                        lambda *a, **k: calls.append(1) or strip(*a, **k))
    qs, ts = _codes(np.random.default_rng(SEED), 3, 200, 90)
    got = sw_wavefront.sw_wavefront(qs, ts, DNA_111, device="cpu")
    assert len(calls) == 3
    assert np.array_equal(got.numpy(), sw_score_batch(qs, ts, DNA_111))


def test_wavefront_refuses_affine():
    q = np.zeros((2, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="affine wavefront"):
        sw_wavefront.sw_wavefront(q, q, ScoringParams(dna_matrix(1, -1), 3, 1),
                                  device="cpu")


@pytest.mark.parametrize("p", [
    DNA_10_30_15,
    ScoringParams.linear(BLOSUM62, 11),
    ScoringParams(dna_matrix(2, -3), 5, 2),
    ScoringParams(BLOSUM62, 11, 1),
])
def test_colscan_matches_jax(p):
    from swtpu.kernels.xla.colscan import sw_batch_colscan

    rng = np.random.default_rng(SEED)
    letters = 20 if p.alphabet_size > 4 else 4
    qs, ts = _codes(rng, 8, 40, 70, letters)
    qs[:, 33:] = p.alphabet_size
    ts[rng.random(ts.shape) < 0.05] = p.alphabet_size + 1
    want = np.asarray(sw_batch_colscan(qs, ts, _jp(p)))
    got = colscan.sw_batch_colscan(qs, ts, p, device="cpu")
    assert np.array_equal(got.numpy(), want)


def test_colscan_refusals(monkeypatch):
    from swtpu.kernels.xla.colscan import sw_batch_colscan

    q = np.zeros((2, 8), np.uint8)
    p = ScoringParams(dna_matrix(1, -1), 1, 2)
    with pytest.raises(NotImplementedError, match="gap_open >= gap_extend"):
        sw_batch_colscan(q, q, _jp(p))
    with pytest.raises(NotImplementedError, match="gap_open >= gap_extend"):
        colscan.sw_batch_colscan(q, q, p, device="cpu")
    # the plain tier has no kernel: a CUDA device raises before anything runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="CPU only"):
        colscan.sw_batch_colscan(q, q, DNA_111, device="cuda")


def test_variants_hold_jax_names_in_order():
    from swtpu.ops.variants import VARIANTS as JAX_VARIANTS

    assert list(variants.VARIANTS) == list(JAX_VARIANTS)
    for name in ("wavefront", "colscan"):
        assert variants.variant_supported(name, DNA_111, 128)
        assert not variants.variant_supported(
            name, ScoringParams(dna_matrix(1, -1), 3, 1), 128)


@pytest.mark.parametrize("engine", ["wavefront", "colscan"])
def test_cpu_engine_option_runs_its_own_engine(engine, monkeypatch, capsys):
    from swtpu.cli import main as jax_cli

    fn = {"wavefront": (sw_wavefront, "sw_wavefront"),
          "colscan": (colscan, "sw_batch_colscan")}[engine]
    calls = []
    real = getattr(fn[0], fn[1])
    monkeypatch.setattr(variants, fn[1], lambda *a: calls.append(1) or real(*a))
    argv = ["align", "--random", "6x90x120", "--scoring", "2,-1", "--gap", "1",
            "--engine", engine]
    cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out
    assert calls == [1]
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():  # JAX's wavefront is a Pallas kernel
        jax_cli(argv)
    assert capsys.readouterr().out == ours and len(ours.splitlines()) == 6
