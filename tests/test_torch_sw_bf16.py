"""The bf16 reduced-precision tier: port (device="cpu") vs JAX.

``swtpu_torch.kernels.sw_bf16`` runs its plain version on the CPU, the
anti-diagonal tier in ``torch.bfloat16``; the JAX side runs the Pallas
kernel ``sw_batch_bf16_pallas`` in interpret mode, once (interpret mode pads
every batch to a 2048-pair tile and is slow, so every case of one
scoring is one batch). Inside the exact range the port equals the
oracle (which is what tests/test_pallas_kernels.py holds JAX to); with ``allow_overflow`` the
two sides are equal wherever either is below 255, and agree on which
pairs reach 255; the port's promotion entry points re-run exactly the
pairs that JAX's tier puts at 255 or more. Pads follow the TPU tier: equal codes match, pad codes
included, and the wrapper pads n to a multiple of 8 with 4 and m to a
multiple of 16 with 5. Seed 10000, tolerance 0.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.core.scoring import ScoringParams, dna_matrix
from swtpu.kernels.pallas import sw_bf16 as jax_bf16
from swtpu.kernels.xla import sw_batch_diag
from swtpu_torch.batch import promote, sw_scores_promoted
from swtpu_torch.core.encode import mutate
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import sw_bf16 as port_bf16
from swtpu_torch.oracle import sw_score_batch


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def lin(match, mismatch, gap):
    return ScoringParams.linear(dna_matrix(match, mismatch), gap)


P7 = lin(7, -1, 1)
SCORINGS = {
    "1_-1_1": lin(1, -1, 1),
    "3_-1_1": lin(3, -1, 1),
    "10_-30_15": lin(10, -30, 15),
    "7_-1_1": P7,
    "2_-1_1": lin(2, -1, 1),
    "mismatch_0": lin(1, 0, 1),
    "mismatch_pos": lin(1, 1, 1),
    "gap_0": lin(1, -1, 0),
    "affine": ScoringParams(dna_matrix(10, -30), 40, 15),
    "general": ScoringParams.linear(np.arange(16).reshape(4, 4) - 8, 2),
}
NS = [0, 1, 7, 8, 30, 32, 36, 37, 85, 86, 88, 128, 129, 200, 256, 257]


@pytest.mark.parametrize("name", list(SCORINGS))
def test_tier_predicate_equals_jax(name):
    p = SCORINGS[name]
    for n in NS:
        assert port_bf16.bf16_tier_supported(port(p), n) == (
            jax_bf16.bf16_tier_supported(p, n)
        ), n
    assert port_bf16.MAX_EXACT == jax_bf16.MAX_EXACT


def test_guard_is_evaluated_on_padded_n():
    """(3, -1, 1) at n = 85: 85 * 3 fits, but n pads to 88 and 88 * 3 does
    not, so the wrapper refuses, as JAX's does; at n = 80 it runs."""
    p = port(SCORINGS["3_-1_1"])
    assert port_bf16.bf16_tier_supported(p, 85)
    assert not port_bf16.bf16_tier_supported(p, 88)
    q85 = np.zeros((2, 85), np.uint8)
    with pytest.raises(NotImplementedError, match="n\\*match/gcd"):
        port_bf16.sw_bf16(q85, q85, p, device="cpu")
    with pytest.raises(NotImplementedError):
        jax_bf16.sw_batch_bf16_pallas(q85, q85, SCORINGS["3_-1_1"])
    # allow_overflow admits it
    out = port_bf16.sw_bf16(q85, q85, p, allow_overflow=True, device="cpu")
    assert out.tolist() == [255, 255]
    q80 = np.zeros((2, 80), np.uint8)
    assert port_bf16.sw_bf16(q80, q80, p, device="cpu").tolist() == [240, 240]


@pytest.mark.parametrize("name", ["mismatch_0", "mismatch_pos", "gap_0",
                                  "affine", "general"])
def test_guard_rejects_other_scoring_even_with_overflow(name):
    q = np.zeros((2, 8), np.uint8)
    before = port_bf16.sw_bf16.launches
    for ov in (False, True):
        with pytest.raises(NotImplementedError):
            port_bf16.sw_bf16(q, q, port(SCORINGS[name]), allow_overflow=ov,
                              device="cpu")
    assert port_bf16.sw_bf16.launches == before


# (scoring, B, n, m): every case inside the exact range
ORACLE_CASES = {
    "10_-30_15_64x128x128": ("10_-30_15", 64, 128, 128),
    "1_-1_1_32x200x240": ("1_-1_1", 32, 200, 240),
    "2_-1_1_40x90x200": ("2_-1_1", 40, 90, 200),
    "7_-1_1_33x30x17": ("7_-1_1", 33, 30, 17),
    "1_-1_1_33x7x1": ("1_-1_1", 33, 7, 1),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_cpu_equals_oracle_inside_the_predicate(case):
    name, B, n, m = ORACLE_CASES[case]
    p = port(SCORINGS[name])
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(B, m)).astype(np.uint8)
    for b in range(B // 2):  # related halves reach high scores
        k = min(n, m)
        ts[b, :k] = mutate(rng, qs[b, :k], 0.05, 0.02, 0.02)
    before = port_bf16.sw_bf16.launches
    got = port_bf16.sw_bf16(qs, ts, p, device="cpu")
    assert port_bf16.sw_bf16.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), sw_score_batch(qs, ts, p))


def test_constants_round_as_the_tpu_formula():
    """s = match - (match - mismatch) * min(d * d, 1) in bf16, for a
    mismatch far outside the exact range (1001 rounds to 1000)."""
    for match, mismatch in ((2, -6), (7, -1), (1, -1000), (300, -7)):
        s_eq, s_ne, _ = port_bf16.bf16_constants(match, mismatch, 1)
        bf = jnp.bfloat16
        d = jnp.array([0, 1], bf)
        want = bf(match) - bf(match - mismatch) * jnp.minimum(d * d, bf(1))
        assert [float(s_eq), float(s_ne)] == [float(x) for x in want]


def _overflow_batch():
    """One batch for the one interpret call, under (7, -1, 1): n = 62, not a
    multiple of 8 (the wrapper pads it to 64 with code 4), m = 64.

    - rows 0-7: related 62-mers, above the bound;
    - rows 8-15: random pairs;
    - rows 16-19, pad case 1: identical 32-mers with N (code 4) at
      positions 10-13 of query and target, which match in the bf16 tier;
    - rows 20-23, pad case 2: a 30-mer against a target that repeats it
      and then has NN, whose two N meet two query pad rows (code 4) on
      the diagonal.
    """
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(24, 62)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(24, 64)).astype(np.uint8)
    for b in range(8):
        ts[b, :62] = mutate(rng, qs[b], out_len=62)
    qs[16:20, 10:14] = 4
    ts[16:20, :32] = qs[16:20, :32]
    qs[16:20, 32:] = 4
    ts[16:20, 32:] = 5
    qs[20:, 30:] = 4
    ts[20:, :30] = qs[20:, :30]
    ts[20:, 30:32] = 4
    ts[20:, 32:] = 5
    return qs, ts


def test_overflow_equals_pallas_interpret_below_the_bound():
    qs, ts = _overflow_batch()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(
            jax_bf16.sw_batch_bf16_pallas(qs, ts, P7, allow_overflow=True)
        )
    got = port_bf16.sw_bf16(qs, ts, port(P7), allow_overflow=True,
                            device="cpu").numpy()
    low = (got < 255) | (want < 255)
    np.testing.assert_array_equal(got[low], want[low])
    np.testing.assert_array_equal(got >= 255, want >= 255)
    # the kernel's skewed tile, replayed on the CPU: the plain tier bit for
    # bit, above the bound too (an even batch of 24: no pad pair)
    mirror = port_bf16.bf16_skew_mirror(qs, ts, port(P7), allow_overflow=True).numpy()
    np.testing.assert_array_equal(mirror, got)
    np.testing.assert_array_equal(mirror[low], want[low])
    assert (got[:8] >= 255).all() and (got[8:16] < 255).any()
    for entry in (sw_scores_promoted, promote.sw_scores_promoted_device):
        _, promoted = entry(qs, ts, port(P7), device="cpu")
        np.testing.assert_array_equal(promoted, want >= 255)
    # the pad cases: the bf16 tier matches pads, the int32 tiers do not
    xla = np.asarray(sw_batch_diag(qs, ts, P7))
    assert (got[16:] == 32 * 7).all()  # 28 + 4 N, or 30 + 2 N on pad rows
    # the XLA tier gaps around the four N (70 - 8 + 126), or stops at 30
    assert (xla[16:20] == 188).all() and (xla[20:] == 30 * 7).all()
