"""CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: each test decides inside the ``card`` fixture whether a
card is present and skips with a reason when it is not, so every pytest
worker collects the same tests. This file imports no JAX, so it also runs
on a machine without it (the repo's conftest imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Integer outputs must be exactly equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

from swtpu_torch.core.scoring import DNA_10_30_15, ScoringParams, dna_matrix
from swtpu_torch.kernels import sw_affine, sw_batch
from swtpu_torch.oracle import sw_affine_traceback, sw_score_batch, sw_traceback

pytestmark = pytest.mark.cuda

AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
SCORINGS = {
    "10_30_15": DNA_10_30_15,
    "tie_rich": ScoringParams.linear(dna_matrix(2, -1), 1),
    "mismatch_nonneg": ScoringParams.linear(dna_matrix(1, 1), 1),
    "affine_10_30_40_15": AFF,
    "affine_tie_rich": ScoringParams(dna_matrix(2, -1), 3, 1),
}
PAIRS = {
    "sw_batch": (sw_batch.sw_batch, sw_batch.sw_batch_plain),
    "sw_batch_ends": (sw_batch.sw_batch_ends, sw_batch.sw_batch_ends_plain),
    "sw_affine": (sw_affine.sw_affine, sw_affine.sw_affine_plain),
    "sw_affine_ends": (sw_affine.sw_affine_ends, sw_affine.sw_affine_ends_plain),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def codes(rng, B, L, device):
    return torch.from_numpy(rng.integers(0, 4, size=(B, L)).astype(np.uint8)).to(device)


def tup(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("shape", ["1000x90x200_padtail", "4096x128x128", "33x7x1"])
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_kernels_equal_plain_on_card(card, scoring, shape):
    p = SCORINGS[scoring]
    B, n, m = (int(x) for x in shape.split("_")[0].split("x"))
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, B, n, card), codes(rng, B, m, card)
    if shape.endswith("padtail"):
        qs[:, 70:] = 4
        ts[: B // 2, 180:] = 5
    names = ["sw_affine", "sw_affine_ends"]
    if p.is_linear:
        names = ["sw_batch", "sw_batch_ends"] + names
    for name in names:
        kern, plain = PAIRS[name]
        before = kern.launches
        got = tup(kern(qs, ts, p))
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for g, w in zip(got, tup(plain(qs, ts, p))):
            assert g.device.type == "cuda" and g.dtype == torch.int32
            assert torch.equal(g, w), name


def test_kernels_equal_oracle_on_card(card):
    rng = np.random.default_rng(10000)
    qh = rng.integers(0, 4, size=(32, 64)).astype(np.uint8)
    th = rng.integers(0, 4, size=(32, 80)).astype(np.uint8)
    qd, td = torch.from_numpy(qh).to(card), torch.from_numpy(th).to(card)
    want = sw_score_batch(qh, th, DNA_10_30_15)
    assert np.array_equal(sw_batch.sw_batch(qd, td, DNA_10_30_15).cpu().numpy(), want)
    for p, walker, fn in (
        (DNA_10_30_15, sw_traceback, sw_batch.sw_batch_ends),
        (AFF, sw_affine_traceback, sw_affine.sw_affine_ends),
    ):
        sc, ei, ej = (x.cpu().numpy() for x in fn(qd, td, p))
        for b in range(32):
            s0, path = walker(qh[b], th[b], p)
            assert s0 == sc[b]
            assert (ei[b], ej[b]) == (path[-1] if s0 else (0, 0))


@pytest.mark.parametrize("name", list(PAIRS))
def test_bare_launch_equals_wrapper_on_card(card, name):
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, 300, 50, card), codes(rng, 300, 70, card)
    affine, ends = "affine" in name, name.endswith("_ends")
    p = AFF if affine else DNA_10_30_15
    got = sw_batch.rowscan_launch_t(
        qs.t().contiguous(), ts.t().contiguous(), p,
        *sw_batch._uniform_match_mismatch(p), affine, ends,
    )
    for g, w in zip(tup(got), tup(PAIRS[name][0](qs, ts, p))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="contiguous uint8"):
        sw_batch.rowscan_launch_t(qs.t(), ts.t(), p, 10, -30, affine, ends)


def test_guards_raise_on_card(card):
    q = torch.zeros((2, 8), dtype=torch.uint8, device=card)
    general = ScoringParams.linear(np.arange(16).reshape(4, 4) - 8, 2)
    for kern, _ in PAIRS.values():
        with pytest.raises(NotImplementedError):
            kern(q, q, general)
