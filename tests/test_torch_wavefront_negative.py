"""The wavefront schedule under a negative gap on the CPU against the JAX
package (seed 10000, tolerance 0).

Under a negative gap H climbs by |gap| a step along every gap chain, into
the phantom rows past n and the padded columns past m, so the TPU kernel's
score (every position and every one of its ceil((n + m - 1) / 32) x 32
steps) sits above the oracle's. The port's plain version repeats that
schedule, and the CUDA kernel runs it as one pair a stream with no
separator, replayed here by ``wavefront_stream_mirror``:

- the plain version and the mirror equal one interpret-mode
  ``sw_wavefront_pallas`` call (8 x 64 x 96, DNA (1,-1), gap -1);
- the mirror equals the plain version at gap -1 and -3 on n = 7, 100 and
  128, DNA and protein, pads inside, ragged m;
- the stream rule, the launch's guard and the table's column 0 for such a
  gap; ``align --engine wavefront --gap -1`` (seed 10000, 8 x 128 x 128)
  prints 256 for each pair, above JAX's XLA tier's 255.
"""

import json

import numpy as np
import pytest
import torch

from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu_torch import cli
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import ScoringParams, dna_matrix
from swtpu_torch.kernels import sw_wavefront as kwf
from swtpu_torch.oracle.sw import sw_score_batch

SEED = 10000
GAP_1 = ScoringParams.linear(dna_matrix(1, -1), -1)


def _codes(rng, B, n, m, A, pads=True):
    qs = rng.integers(0, A, (B, n)).astype(np.uint8)
    ts = rng.integers(0, A, (B, m)).astype(np.uint8)
    if pads:  # the pad codes inside both sequences
        qs[rng.random(qs.shape) < 0.05] = A
        ts[rng.random(ts.shape) < 0.05] = A + 1
    return qs, ts


def test_plain_and_mirror_match_pallas_interpret_under_a_negative_gap():
    from jax.experimental.pallas import tpu as pltpu

    from swtpu.kernels.pallas.sw_wavefront import sw_wavefront_pallas

    qs, ts = _codes(np.random.default_rng(SEED), 8, 64, 96, 4, pads=False)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(sw_wavefront_pallas(
            qs, ts, JaxScoring(GAP_1.matrix, GAP_1.gap_open, GAP_1.gap_extend)))
    assert np.array_equal(kwf.sw_wavefront(qs, ts, GAP_1, device="cpu").numpy(), want)
    assert np.array_equal(kwf.wavefront_stream_mirror(qs, ts, GAP_1, 1, "cpu").numpy(),
                          want)
    # the TPU schedule's score: above the oracle's on every pair
    assert (want > sw_score_batch(qs, ts, GAP_1)).all()


@pytest.mark.parametrize("gap", [-1, -3])
@pytest.mark.parametrize("B,n,m,protein", [
    (5, 7, 40, False), (4, 100, 130, False), (3, 128, 128, False), (4, 128, 3, False),
    (3, 60, 50, True),
])
def test_mirror_equals_the_plain_version(gap, B, n, m, protein):
    p = ScoringParams.linear(BLOSUM62 if protein else dna_matrix(2, -3), gap)
    qs, ts = _codes(np.random.default_rng(SEED + n + m), B, n, m, p.alphabet_size)
    plain = kwf.sw_wavefront_plain(qs, ts, p, "cpu")
    assert torch.equal(kwf.wavefront_stream_mirror(qs, ts, p, 1, "cpu"), plain)


def test_empty_shapes_under_a_negative_gap():
    """No step (n + m - 1 <= 0) gives 0, as the plain version does."""
    for B, n, m in ((0, 128, 128), (3, 0, 0), (3, 1, 0), (2, 0, 5)):
        qs, ts = np.zeros((B, n), np.uint8), np.zeros((B, m), np.uint8)
        plain = kwf.sw_wavefront_plain(qs, ts, GAP_1, "cpu")
        assert torch.equal(kwf.wavefront_stream_mirror(qs, ts, GAP_1, 1, "cpu"), plain)
        assert plain.shape == (B,)


def test_one_pair_a_stream_under_a_negative_gap():
    """The rule, the mirror and the launch all hold a negative gap to one
    pair a stream; a gap >= 0 keeps the rule's choice."""
    kwf.wavefront_stream.cache_clear()
    assert kwf.wavefront_stream(8192, 128, 128, 132, 4, None, -1) == 1
    assert kwf.wavefront_stream(8192, 128, 128, 132, 4, None, 0) > 1
    q = torch.zeros((4, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one pair a stream"):
        kwf.wavefront_stream_mirror(q, q, GAP_1, 2, "cpu")
    with pytest.raises(ValueError, match="one pair a stream"):
        kwf.wavefront_launch_t(q, q, kwf.wavefront_table(GAP_1, "cpu"), GAP_1, pairs=4)


def test_table_scores_every_column_outside_the_target_as_the_pad():
    """Column 0 (the separator) holds the pad's -2^20 + gap under a
    negative gap, the separator's -2^30 otherwise."""
    neg = kwf._stream_table(GAP_1)
    assert (neg[:, 0] == kwf.NEG - 1).all() and (neg[:, -1] == kwf.NEG - 1).all()
    assert (kwf._stream_table(ScoringParams.linear(dna_matrix(1, -1), 2))[:, 0]
            == kwf.NEG_SEP).all()
    assert kwf.wavefront_refusal(GAP_1) is None
    assert "linear gap only" in kwf.wavefront_refusal(ScoringParams(dna_matrix(1, -1), 3, 1))


def test_c4_input_prints_the_tpu_schedules_score(capsys):
    """``align --random 8x128x128 --engine wavefront --gap -1`` (seed
    10000, (1,-1)): 256 a pair, what JAX's Pallas kernel prints, where
    JAX's XLA tier (``align`` without an engine) prints 255."""
    argv = ["align", "--random", "8x128x128", "--engine", "wavefront", "--gap", "-1",
            "--device", "cpu"]
    cli.main(argv)
    scores = [json.loads(x)["score"] for x in capsys.readouterr().out.splitlines()]
    assert scores == [256] * 8
    cli.main(argv[:3] + argv[5:])  # best_engine: the XLA tier's recurrence
    assert [json.loads(x)["score"] for x in capsys.readouterr().out.splitlines()] == (
        [255] * 8)
