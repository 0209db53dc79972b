"""Overflow promotion: port (device="cpu") vs the JAX package's oracle.

``swtpu_torch.batch.promote`` runs the bf16 tier (its plain version on the
CPU) and re-runs at int32 the pairs whose bf16 score reached 255 * g. On
the data of the JAX package's own promotion tests (seed 10000, 24 pairs
of 64-mers under (7, -1, 1), half related so that they cross the bf16
bound, half random) both entry points must equal ``swtpu.oracle``, which
is what those tests hold JAX's promotion to, with a mask that is neither
all nor none and every pair left unpromoted below 255. ``cap_frac=1/2048``
leaves one re-run slot on the device, so the host remainder path must
restore the rest. The mask against JAX's own bf16 tier is checked in
test_torch_sw_bf16.py, beside its one Pallas interpret call. Tolerance 0.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.core import mutate, random_dna
from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu.core.scoring import dna_matrix as jax_dna_matrix
from swtpu.oracle import sw_score_batch as jax_oracle
from swtpu_torch.batch import promote
from swtpu_torch.batch import sw_scores_promoted
from swtpu_torch.core.scoring import DNA_111, ScoringParams, dna_matrix
from swtpu_torch.kernels import sw_bf16
from swtpu_torch.oracle import sw_score_batch

P7 = ScoringParams.linear(dna_matrix(7, -1), 1)
JAX_P7 = JaxScoring.linear(jax_dna_matrix(7, -1), gap=1)
JAX_111 = JaxScoring.linear(jax_dna_matrix(1, -1), gap=1)


def jax_test_data():
    """The inputs of tests/test_batch_features.py::test_overflow_promotion."""
    rng = np.random.default_rng(10000)
    B, n = 24, 64
    qs = random_dna(rng, (B, n))
    ts = np.empty_like(qs)
    ts[: B // 2] = np.stack([mutate(rng, qs[b], out_len=n) for b in range(B // 2)])
    ts[B // 2:] = random_dna(rng, (B - B // 2, n))
    return qs, ts


ENTRIES = {
    "promoted": lambda q, t, p: sw_scores_promoted(q, t, p, device="cpu"),
    "device": lambda q, t, p: promote.sw_scores_promoted_device(
        q, t, p, device="cpu"),
    "device_cap_1_2048": lambda q, t, p: promote.sw_scores_promoted_device(
        q, t, p, cap_frac=1 / 2048, device="cpu"),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_promotion_equals_oracle(entry):
    qs, ts = jax_test_data()
    scores, promoted = ENTRIES[entry](qs, ts, P7)
    assert scores.dtype == np.int64 and promoted.dtype == bool
    np.testing.assert_array_equal(scores, jax_oracle(qs, ts, JAX_P7))
    assert promoted.any() and not promoted.all()
    assert (scores[~promoted] < 255).all()
    # the mask is the bf16 tier's own verdict
    low = sw_bf16.sw_bf16(qs, ts, P7, allow_overflow=True, device="cpu").numpy()
    np.testing.assert_array_equal(promoted, low >= 255)
    assert int(promoted.sum()) > 1  # so cap 1 leaves a host remainder


def test_custom_int32_engine_sees_only_promoted_pairs():
    qs, ts = jax_test_data()
    seen = []

    def engine(q, t):
        seen.append(q.shape[0])
        return torch.from_numpy(sw_score_batch(q.numpy(), t.numpy(), P7))

    scores, promoted = sw_scores_promoted(qs, ts, P7, engine_int32=engine,
                                          device="cpu")
    assert seen == [int(promoted.sum())]
    np.testing.assert_array_equal(scores, jax_oracle(qs, ts, JAX_P7))


@pytest.mark.parametrize("n", [64, 61])
def test_split_keeps_bf16_scores_past_the_cap(n):
    """The device half alone: the first ``cap`` promoted pairs (in index
    order) are re-run, later ones keep their bf16 score, and the count
    covers them all. It takes the codes as they are: at n = 61 the bf16
    tier pads the rows itself."""
    qs, ts = jax_test_data()
    qs = np.ascontiguousarray(qs[:, :n])
    q, t = torch.from_numpy(qs), torch.from_numpy(ts)
    low = sw_bf16.sw_bf16(q, t, P7, allow_overflow=True, device="cpu")
    want = torch.from_numpy(jax_oracle(qs, ts, JAX_P7).astype(np.int32))
    for cap in (1, 3, 24):
        scores, promoted, nprom = promote.promoted_split(q, t, P7, cap)
        idx = torch.nonzero(promoted).flatten()
        assert int(nprom) == len(idx)
        fixed, kept = idx[:cap], idx[cap:]
        assert torch.equal(scores[fixed], want[fixed])
        assert torch.equal(scores[kept], low[kept])
        assert torch.equal(scores[~promoted], low[~promoted])


def test_no_promotion_when_scores_stay_low():
    rng = np.random.default_rng(10000)
    qs = random_dna(rng, (9, 40))
    ts = random_dna(rng, (9, 40))
    for fn in (sw_scores_promoted, promote.sw_scores_promoted_device):
        scores, promoted = fn(qs, ts, DNA_111, device="cpu")
        assert not promoted.any()
        np.testing.assert_array_equal(scores, jax_oracle(qs, ts, JAX_111))


@pytest.mark.parametrize("params", [
    ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15),
    ScoringParams.linear(dna_matrix(1, 0), 1),
    ScoringParams.linear(dna_matrix(1, -1), 0),
    ScoringParams.linear(np.arange(16).reshape(4, 4) - 8, 2),
])
def test_promotion_rejects_other_scoring(params):
    q = np.zeros((2, 8), np.uint8)
    for fn in (sw_scores_promoted, promote.sw_scores_promoted_device):
        with pytest.raises(NotImplementedError, match="promotion tier"):
            fn(q, q, params, device="cpu")
