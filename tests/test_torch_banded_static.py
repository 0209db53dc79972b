"""Fixed-band (|i - j| <= W) local alignment: port vs JAX.

The same numpy inputs (seed 10000) go through the JAX package and the
port, tolerance 0:

- the port's oracle copy (``swtpu_torch.oracle.banded_static``) against
  ``swtpu.oracle.banded_static``, scores and paths, linear, affine,
  BLOSUM62 and a non-uniform 4x4 matrix, W in {4, 8, 12, 20, 32};
- the plain tier (``kernels.sw_banded.sw_banded_plain``) against the
  oracle on the shape classes of the Pallas kernel's own tests (mixed
  related and random pairs, unequal lengths both ways, W >= max(n, m)
  equal to full Smith-Waterman, the left band edge crossing every row
  group, profile scoring, n % 8 != 0, per-pair lengths), and on scorings
  the kernel refuses (mismatch >= 0, gap 0);
- the kernel wrappers at ``device="cpu"`` and the kernel's CPU mirror
  (``banded_skew_mirror``) against one Pallas interpret call each of
  ``sw_banded_static_pallas`` and ``sw_banded_profile_pallas`` on
  pad-free codes;
- ``banded_static_align_batch(device="cpu")`` and ``banded --fixed``
  against JAX's.

The CUDA kernel itself is held against the plain tier on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import contextlib
import io

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.batch import banded_static_align_batch as jax_align
from swtpu.cli import main as jax_cli
from swtpu.core.encode import mutate
from swtpu.core.protein import BLOSUM62
from swtpu.core.scoring import ScoringParams, dna_matrix
from swtpu.kernels.pallas.sw_banded import (
    sw_banded_profile_pallas,
    sw_banded_static_pallas,
)
from swtpu.oracle import banded_static as jax_oracle
from swtpu.oracle.sw import sw_score_batch
from swtpu_torch.batch import banded_static_align_batch
from swtpu_torch.cli import main as port_cli
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import sw_banded
from swtpu_torch.oracle import banded_static as oracle

GENERAL = dna_matrix(5, -4)
GENERAL[0, 1] = GENERAL[1, 0] = -2
SCORINGS = {
    "111": ScoringParams.linear(dna_matrix(1, -1), 1),
    "10_30_15": ScoringParams.linear(dna_matrix(10, -30), 15),
    "affine_10_30_40_15": ScoringParams(dna_matrix(10, -30), 40, 15),
    "affine_1_1_3_1": ScoringParams(dna_matrix(1, -1), 3, 1),
    "blosum62_linear11": ScoringParams.linear(BLOSUM62, 11),
    "blosum62_gotoh11_1": ScoringParams(BLOSUM62, 11, 1),
    "dna_general_linear3": ScoringParams.linear(GENERAL, 3),
    "dna_general_gotoh3_1": ScoringParams(GENERAL, 3, 1),
}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def codes(rng, scoring, B, n, m=None, related=0):
    """B pairs of n x m codes for a scoring's alphabet; the first
    ``related`` targets mutate their query (about 70% identity)."""
    A = 4 if SCORINGS[scoring].alphabet_size == 4 else 20
    m = n if m is None else m
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, A, size=(B, m)).astype(np.uint8)
    for b in range(related):
        ts[b] = mutate(rng, qs[b], out_len=m) % A
    return qs, ts


def oracle_scores(qs, ts, p, W, lens_q=None, lens_t=None):
    if lens_q is None:
        return jax_oracle.sw_banded_static_score_batch(qs, ts, p, W)
    return np.array([jax_oracle.sw_banded_static_score(
        qs[b, : lens_q[b]], ts[b, : lens_t[b]], p, W) for b in range(len(qs))])


def plain(qs, ts, p, W, **kw):
    got = sw_banded.sw_banded_plain(qs, ts, port(p), W, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy()


# -- the oracle copy ----------------------------------------------------


@pytest.mark.parametrize("W", [4, 8, 12, 20, 32])
@pytest.mark.parametrize("scoring", ["111", "affine_1_1_3_1", "blosum62_gotoh11_1",
                                     "dna_general_linear3"])
def test_oracle_copy_equals_jax(scoring, W):
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, scoring, 4, 30, 36, related=2)
    p = SCORINGS[scoring]
    for q, t in zip(qs, ts):
        assert oracle.sw_banded_static_score(q, t, port(p), W) == (
            jax_oracle.sw_banded_static_score(q, t, p, W))
        assert oracle.sw_banded_static_traceback(q, t, port(p), W) == (
            jax_oracle.sw_banded_static_traceback(q, t, p, W))
    np.testing.assert_array_equal(
        oracle.sw_banded_static_score_batch(qs, ts, port(p), W),
        jax_oracle.sw_banded_static_score_batch(qs, ts, p, W))


# -- the plain tier against the oracle ----------------------------------


@pytest.mark.parametrize("scoring,W", [
    ("111", 8), ("10_30_15", 8), ("111", 20), ("affine_10_30_40_15", 8),
    ("affine_1_1_3_1", 20), ("blosum62_linear11", 8), ("blosum62_gotoh11_1", 8),
    ("dna_general_linear3", 12), ("dna_general_gotoh3_1", 4),
])
def test_plain_equals_oracle_related_and_random(scoring, W):
    """The Pallas tests' mixed set: half related, half random pairs."""
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, scoring, 6, 48, related=3)
    p = SCORINGS[scoring]
    np.testing.assert_array_equal(plain(qs, ts, p, W), oracle_scores(qs, ts, p, W))


@pytest.mark.parametrize("n,m,W", [(40, 64, 12), (64, 40, 12), (37, 45, 8),
                                   (45, 37, 0), (21, 13, 1), (9, 30, 2)])
@pytest.mark.parametrize("scoring", ["111", "affine_1_1_3_1", "blosum62_gotoh11_1"])
def test_plain_equals_oracle_ragged(scoring, n, m, W):
    """Unequal lengths both ways, n % 8 != 0, W from 0."""
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, scoring, 5, n, m, related=2)
    p = SCORINGS[scoring]
    np.testing.assert_array_equal(plain(qs, ts, p, W), oracle_scores(qs, ts, p, W))


def test_plain_wide_band_equals_full_sw():
    """W >= max(n, m): the corridor is the whole matrix."""
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, "111", 4, 24)
    p = SCORINGS["111"]
    for W in (24, 100):
        np.testing.assert_array_equal(plain(qs, ts, p, W), sw_score_batch(qs, ts, p))


@pytest.mark.parametrize("scoring", ["111", "affine_1_1_3_1", "blosum62_linear11"])
def test_plain_left_edge_crossing(scoring):
    """t = q[W:] puts the optimal path on the left band edge j = i - W,
    crossing every row-group boundary (the Pallas kernel's din[0] bug)."""
    rng = np.random.default_rng(10000)
    W = 16
    qq, _ = codes(rng, scoring, 4, 64)
    tt = qq[:, W:].copy()
    p = SCORINGS[scoring]
    want = oracle_scores(qq, tt, p, W)
    assert want.min() > 20
    np.testing.assert_array_equal(plain(qq, tt, p, W), want)


@pytest.mark.parametrize("scoring", ["affine_1_1_3_1", "blosum62_gotoh11_1"])
def test_plain_per_pair_lengths(scoring):
    """lens_q / lens_t overwrite the tails with pads (matrix.min()), which
    only lose: the scores of the unpadded pairs."""
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, scoring, 6, 45, 50, related=3)
    lq, lt = rng.integers(0, 46, 6), rng.integers(0, 51, 6)
    lq[0], lt[1] = 0, 0
    p = SCORINGS[scoring]
    np.testing.assert_array_equal(
        plain(qs, ts, p, 8, lens_q=lq, lens_t=lt),
        oracle_scores(qs, ts, p, 8, lq, lt))


def test_plain_takes_scorings_the_kernel_refuses():
    """mismatch >= 0 or gap 0: no kernel, but the plain tier is exact."""
    rng = np.random.default_rng(10000)
    for p in (ScoringParams.linear(dna_matrix(1, 1), 1),
              ScoringParams.linear(dna_matrix(2, -1), 0),
              ScoringParams(dna_matrix(2, -1), 2, 0)):
        qs, ts = codes(rng, "111", 4, 30, 34, related=2)
        np.testing.assert_array_equal(plain(qs, ts, p, 6), oracle_scores(qs, ts, p, 6))
        for fn in (sw_banded.sw_banded_static, sw_banded.sw_banded_profile):
            if fn is sw_banded.sw_banded_profile and p.gap_extend > 0:
                continue
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                fn(qs, ts, port(p), 6, device="cpu")


def test_plain_pads_score_matrix_min():
    """An in-length pad (code >= the alphabet) scores matrix.min(), the
    mapper's pad-extended oracle (swtpu/models/mapper.py:351-366)."""
    rng = np.random.default_rng(10000)
    for scoring in ("affine_1_1_3_1", "blosum62_gotoh11_1"):
        p = SCORINGS[scoring]
        A = p.alphabet_size
        qs, ts = codes(rng, scoring, 4, 30, 30, related=4)
        qs[:, 7], ts[:, 11] = A, A + 1
        ext = np.full((A + 2, A + 2), int(p.matrix.min()), np.int32)
        ext[:A, :A] = p.matrix
        pe = ScoringParams(ext, p.gap_open, p.gap_extend)
        np.testing.assert_array_equal(plain(qs, ts, p, 8), oracle_scores(qs, ts, pe, 8))


# -- the wrappers against the Pallas kernels (interpret mode) ----------


def test_static_wrapper_equals_pallas():
    rng = np.random.default_rng(10000)
    p = SCORINGS["affine_1_1_3_1"]
    qs, ts = codes(rng, "affine_1_1_3_1", 6, 48, related=3)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(sw_banded_static_pallas(qs, ts, p, bandwidth=8))
    got = sw_banded.sw_banded_static(qs, ts, port(p), 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracle_scores(qs, ts, p, 8))
    # the kernel's skewed tile, replayed on the CPU
    np.testing.assert_array_equal(
        sw_banded.banded_skew_mirror(qs, ts, port(p), 8).numpy(), want)


def test_profile_wrapper_equals_pallas():
    rng = np.random.default_rng(10000)
    p = SCORINGS["blosum62_gotoh11_1"]
    qs, ts = codes(rng, "blosum62_gotoh11_1", 4, 48, related=2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(sw_banded_profile_pallas(qs, ts, p, bandwidth=8))
    got = sw_banded.sw_banded_profile(qs, ts, port(p), 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sw_banded.banded_skew_mirror(qs, ts, port(p), 8, profile=True).numpy(), want)


# -- alignment and CLI ---------------------------------------------------


@pytest.mark.parametrize("scoring,W", [("111", 8), ("affine_10_30_40_15", 12),
                                       ("blosum62_gotoh11_1", 8),
                                       ("dna_general_linear3", 20)])
def test_align_batch_equals_jax(scoring, W):
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, scoring, 6, 40, 44, related=4)
    p = SCORINGS[scoring]
    got = banded_static_align_batch(qs, ts, port(p), W, device="cpu")
    assert got == jax_align(qs, ts, p, W)
    assert any(len(path) > 5 for _, path in got)


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["banded", "--fixed", "--random", "6x50x50", "--bandwidth", "8"],
    ["banded", "--fixed", "--random", "4x40x40", "--gap-open", "3", "--gap-extend",
     "1", "--traceback", "--cigar"],
    ["banded", "--fixed", "--random", "4x40x40", "--bandwidth", "12", "--sam"],
    ["banded", "--fixed", "--alphabet", "protein", "--random", "4x40x40",
     "--gap-open", "11", "--gap-extend", "1", "--cigar"],
])
def test_cli_fixed_equals_jax(argv):
    out = _run(port_cli, argv + ["--device", "cpu"])
    assert out == _run(jax_cli, argv) and len(out.splitlines()) >= 4
