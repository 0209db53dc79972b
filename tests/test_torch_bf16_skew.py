"""The bf16 kernel's skewed tile, replayed on the CPU: port vs JAX.

``sw_bf16.bf16_skew_mirror`` follows ``csrc/sw_bf16.cu`` step for step
(two pairs a thread and, for an odd batch, the last thread's own pad
pair; sweeps of 16 rows as a skewed tile; the TPU wrapper's pad rows and
columns made in the kernel, rows past n_pad with a code no target byte
equals; each row's H and G = round(H - gap), the cell as a signed 16-bit
three-way max; the score as an indicator times a step plus a base; the
row buffer between sweeps). The same numpy inputs (seed 10000) go
through it, the plain tier and JAX, tolerance 0:

- inside the exact range, the JAX package's oracle on codes 0-3 (odd
  batches, n not a multiple of 8 or 16, m below 16, n below a sweep);
- above it, under (7, -1, 1) and (1, -1, 1) at n = 62 and 128, the plain
  tier bit for bit (drift included) and the oracle wherever either is
  below 255 (JAX's Pallas kernel in interpret mode is held to the mirror
  in tests/test_torch_sw_bf16.py, inside its one interpret call);
- pads: equal codes match, pad rows (4) against a target N, as the TPU
  tier does.

And on a pretend card, ``sw_bf16`` hands the launch the caller's [B, n]
/ [B, m] codes, untransposed and, for an odd batch, not copied. The
kernel itself is held against the plain tier on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.core.encode import mutate
from swtpu.core.scoring import ScoringParams, dna_matrix
from swtpu.oracle.sw import sw_score_batch
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import semiglobal_batch as sb
from swtpu_torch.kernels import sw_bf16
from swtpu_torch.utils import device as port_device


def lin(match, mismatch, gap):
    return ScoringParams.linear(dna_matrix(match, mismatch), gap)


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


SCORINGS = {"10_-30_15": lin(10, -30, 15), "2_-1_1": lin(2, -1, 1),
            "1_-1_1": lin(1, -1, 1)}
R = sw_bf16.SWEEP
# (B, n, m): odd batches, n not a multiple of 8 or 16 (phantom rows in the
# last sweep), m below 16, n below one sweep
SHAPES = {
    "odd_batch": (7, 2 * R, 40),
    "n_ragged": (6, 2 * R + 5, 20),
    "m_below_16": (5, 40, 9),
    "n_below_rows": (5, 7, 33),
    "one_by_one": (3, 1, 1),
}


def pairs(rng, B, n, m, A=4):
    """B pairs, the first half related (about 90% identity)."""
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, A, size=(B, m)).astype(np.uint8)
    for b in range(B // 2):
        ts[b] = mutate(rng, qs[b], p_mismatch=0.1, out_len=m)
    return qs, ts


def mirror_and_plain(qs, ts, p, **kw):
    got = sw_bf16.bf16_skew_mirror(qs, ts, port(p), **kw)
    want = sw_bf16.sw_bf16_plain(qs, ts, port(p), device="cpu", **kw)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    return got.numpy(), want.numpy()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_mirror_equals_plain_and_oracle(scoring, shape):
    B, n, m = SHAPES[shape]
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m)
    p = SCORINGS[scoring]
    got, want = mirror_and_plain(qs, ts, p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sw_score_batch(qs, ts, p))


@pytest.mark.parametrize("n", [62, 128])
@pytest.mark.parametrize("scoring", ["7_-1_1", "1_-1_1"])
def test_mirror_above_the_bound(scoring, n):
    """allow_overflow: the rounded values drift above 256, and the mirror
    drifts exactly as the plain tier does; below 255 both are exact."""
    p = lin(7, -1, 1) if scoring == "7_-1_1" else lin(1, -1, 1)
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, 9, n, n + 3)
    qs[0], ts[0, :n] = qs[1], qs[1]  # identical: 7n reaches past the bound
    got, want = mirror_and_plain(qs, ts, p, allow_overflow=True)
    np.testing.assert_array_equal(got, want)
    exact = sw_score_batch(qs, ts, p)
    low = (got < 255) | (exact < 255)
    np.testing.assert_array_equal(got[low], exact[low])
    np.testing.assert_array_equal(got >= 255, exact >= 255)
    if scoring == "7_-1_1":
        assert (got != exact).any()  # it drifted


def test_mirror_pads_match():
    """Equal codes match, pads included: N (4) on both sides, and a
    target NN against the query's pad rows (n = 30 pads to 32 rows of 4)."""
    rng = np.random.default_rng(10000)
    pq = rng.integers(0, 4, size=(5, 32)).astype(np.uint8)
    pq[:, 10:14] = 4
    q30 = rng.integers(0, 4, size=(5, 30)).astype(np.uint8)
    t32 = np.concatenate([q30, np.full((5, 2), 4, np.uint8)], axis=1)
    for qs, ts in ((pq, pq), (q30, t32)):
        got, want = mirror_and_plain(qs, ts, lin(1, -1, 1))
        np.testing.assert_array_equal(got, want)
        assert (got == 32).all()


# -- the wrapper hands the launch [B, L] codes ---------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Pretend a card exists for sw_bf16: the codes stay on the CPU, and
    the launch is a recorder that returns the plain tier's result,
    computed apart; the plain tier as the wrapper sees it fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    cpu = torch.device("cpu")
    plain = sw_bf16.sw_bf16_plain

    def as_codes(x, device):
        assert device.type == "cuda"
        return port_device.as_codes(x, cpu)

    def launch(q, t, params, allow_overflow=False):
        calls.append((q, t))
        return plain(q, t, params, allow_overflow, device="cpu")

    monkeypatch.setattr(sb, "as_codes", as_codes)
    monkeypatch.setattr(sw_bf16, "bf16_launch_t", launch)
    monkeypatch.setattr(sw_bf16, "sw_bf16_plain",
                        lambda *a, **k: pytest.fail("plain tier ran on CUDA"))
    return calls


@pytest.mark.parametrize("B", [6, 7])
@pytest.mark.parametrize("layout", ["numpy", "torch"])
def test_wrapper_hands_the_launch_untransposed_codes(fake_card, layout, B):
    n, m = 2 * R + 3, 40
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m)
    q_in, t_in = ((qs, ts) if layout == "numpy"
                  else (torch.from_numpy(qs), torch.from_numpy(ts)))
    p = SCORINGS["2_-1_1"]
    before = sw_bf16.sw_bf16.launches
    got = sw_bf16.sw_bf16(q_in, t_in, port(p))
    assert sw_bf16.sw_bf16.launches == before + 1
    (q, t), = fake_card
    for x, h, given in ((q, qs, q_in), (t, ts, t_in)):
        assert x.dtype == torch.uint8 and x.is_contiguous()
        assert tuple(x.shape) == h.shape  # [B, n] / [B, m], odd B kept, not [n, B]
        np.testing.assert_array_equal(x.numpy(), h)
        if layout == "torch":  # the caller's tensor itself: no copy
            assert x.data_ptr() == given.data_ptr()
    np.testing.assert_array_equal(got.numpy(), sw_score_batch(qs, ts, p))
