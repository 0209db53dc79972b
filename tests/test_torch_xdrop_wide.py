"""The per-round X-drop band past W = 128 on the CPU: the plain tier
against JAX's XLA forward, and a plain mirror of the wide kernel's
schedule against the plain tier.

The wide kernel (``csrc/sw_xdrop.cu::xdrop_wide_kernel``, a CTA a pair,
a warp each 128 band cells in registers on the warp kernel's round body)
runs only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version. Here, tolerance 0, every field below each pair's n_rounds:

- the port's plain tier (``banded_scan.banded_xdrop_batch``, through
  ``banded_batch_plain``) against JAX's XLA ``banded_xdrop_batch``, the
  forward JAX's TPU dispatch runs past its Pallas kernel's widths, at W =
  129, 160 and 256 (linear with per-pair lengths, Gotoh with the 8-bit
  history, BLOSUM62 11/1 with per-pair lengths);
- ``xdrop_wide_mirror`` (the CTA's schedule replayed in numpy: warps of
  128 cells, 4 a lane, each with its own code windows; the warps' round
  maxima and uncut edge cells through slot sets by round parity, one
  barrier a round; the direction from the slots' band ends; the cut
  applied late, across warp edges too; phantom cells past W capped at 0)
  against the plain tier at W from 129 to 1024 (one, two, three and eight
  warps, W a multiple of 128 and not), and at W <= 128, where the kernel
  can run too;
- ``xdrop_round_mirror`` (the warp kernel's schedule) at W = 129-256, the
  wide band's one-warp form (5-8 cells a lane), against the plain tier;
- the dispatch as a pure function: which kernel the card takes for each
  W (``banded_form``: the warp kernel to 128, the wide band's one-warp
  form to 256, its CTA to 1024), and the refusal past 1024, which names
  its ROADMAP.md item.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

from swtpu.core.protein import BLOSUM62
from swtpu.kernels.xla import banded_scan as jax_scan
from swtpu_torch.core.encode import mutate
from swtpu_torch.kernels import banded_batch

B, L = 4, 200


def sets(seed=10000):
    """DNA: related pairs, the last random, N inside one, per-pair lengths
    (one query of 5); protein: ~70% identity."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    ts = np.stack([mutate(rng, q, out_len=L) for q in qs])
    ts[-1] = rng.integers(0, 4, L)
    qs[1, 10:13] = 4
    lq, lt = rng.integers(L // 2, L + 1, B), rng.integers(L // 2, L + 1, B)
    lq[0] = 5
    pq = rng.integers(0, 24, (B, L)).astype(np.uint8)
    pt = pq.copy()
    pt[:, ::3] = rng.integers(0, 24, pt[:, ::3].shape)
    return (qs, ts), (pq, pt), dict(lens_q=lq, lens_t=lt)


MODES = {
    "linear_lens": ("dna", dict(lens=True)),
    "gotoh_8bit": ("dna", dict(gap_open=3, gap_extend=1, compress_history=True)),
    "blosum62_gotoh_lens": ("protein", dict(matrix=BLOSUM62, gap_open=11, gap_extend=1,
                                            x_threshold=120, lens=True)),
    "harsh_x20": ("dna", dict(mismatch=3, gap=2, x_threshold=20)),
}


def mode_inputs(mode):
    kind, kw = MODES[mode]
    kw = dict(kw)
    dna, protein, lens = sets()
    qs, ts = dna if kind == "dna" else protein
    if kw.pop("lens", False):
        kw.update(lens)
    return qs, ts, kw


def fields(res):
    """Every field, the per-round ones zeroed at and past n_rounds."""
    nr = np.asarray(res.n_rounds)
    out = [np.asarray(res.score), np.asarray(res.max_round), nr]
    if res.pos_y is not None:
        live = np.arange(res.pos_y.shape[0])[:, None] < nr[None]
        out.append(np.where(live[..., None], np.asarray(res.band_history), 0))
        out += [np.where(live, np.asarray(x), 0) for x in (res.pos_y, res.offsets)
                if x is not None]
    return out


def assert_fields_equal(got, want):
    g, w = fields(got), fields(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode, W", [("linear_lens", 129), ("gotoh_8bit", 160),
                                     ("blosum62_gotoh_lens", 256)])
def test_plain_equals_xla_past_128(mode, W):
    qs, ts, kw = mode_inputs(mode)
    want = jax_scan.banded_xdrop_batch(qs, ts, bandwidth=W, **kw)
    got = banded_batch.banded_batch_plain(qs, ts, bandwidth=W, device="cpu", **kw)
    assert_fields_equal(got.numpy(), want)


WIDE_WIDTHS = (129, 160, 255, 256, 257, 384, 512, 1000, 1024)


@pytest.mark.parametrize("mode, W", [
    (mode, W) for mode in ("linear_lens", "gotoh_8bit", "blosum62_gotoh_lens")
    for W in WIDE_WIDTHS
] + [
    ("linear_lens", 200), ("harsh_x20", 300), ("harsh_x20", 1024),
    ("linear_lens", 33), ("gotoh_8bit", 96), ("blosum62_gotoh_lens", 128),
])
def test_wide_mirror_equals_plain(mode, W):
    qs, ts, kw = mode_inputs(mode)
    got = banded_batch.xdrop_wide_mirror(qs, ts, bandwidth=W, **kw)
    want = banded_batch.banded_batch_plain(qs, ts, bandwidth=W, device="cpu", **kw)
    assert_fields_equal(got, want)


@pytest.mark.parametrize("W", [129, 160, 192, 224, 255, 256])
@pytest.mark.parametrize("mode", ["linear_lens", "gotoh_8bit", "blosum62_gotoh_lens"])
def test_wide_warp_mirror_equals_plain(mode, W):
    """The wide band's one-warp form (W = 129-256, 5-8 cells a lane):
    ``xdrop_round_mirror``, the warp kernel's schedule at that CPL."""
    qs, ts, kw = mode_inputs(mode)
    got = banded_batch.xdrop_round_mirror(qs, ts, bandwidth=W, **kw)
    want = banded_batch.banded_batch_plain(qs, ts, bandwidth=W, device="cpu", **kw)
    assert_fields_equal(got, want)


def test_wide_mirror_scores_only_and_linear_rule():
    """Scores only, and gap_open == gap_extend taken as linear."""
    qs, ts, kw = mode_inputs("linear_lens")
    got = banded_batch.xdrop_wide_mirror(qs, ts, bandwidth=160, with_history=False, **kw)
    assert got.band_history is None and got.pos_y is None
    assert_fields_equal(got, banded_batch.banded_batch_plain(
        qs, ts, bandwidth=160, with_history=False, device="cpu", **kw))
    got = banded_batch.xdrop_wide_mirror(qs, ts, bandwidth=160, gap=9, gap_open=2,
                                         gap_extend=2)
    assert_fields_equal(got, banded_batch.banded_batch_plain(
        qs, ts, bandwidth=160, gap=2, device="cpu"))


def test_banded_form_by_width():
    assert [banded_batch.banded_form(W) for W in (1, 32, 96, 128)] == ["round"] * 4
    assert [banded_batch.banded_form(W) for W in (129, 160, 255, 256)] == [
        "wide_warp"] * 4
    assert [banded_batch.banded_form(W) for W in (257, 384, 512, 1000, 1024)] == [
        "wide"] * 5
    assert [banded_batch.banded_form(W) for W in (0, -3, 1025, 4096)] == [None] * 4
    assert banded_batch.width_refusal(1024) is None
    for W in (0, 1025):
        assert "ROADMAP.md queue A item 18" in banded_batch.width_refusal(W)
    # a warp holds at most 256 cells: its mirror refuses the CTA's widths
    with pytest.raises(NotImplementedError, match="wide kernel"):
        banded_batch.xdrop_round_mirror(*mode_inputs("linear_lens")[:2], bandwidth=257)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        banded_batch.xdrop_wide_mirror(*mode_inputs("linear_lens")[:2], bandwidth=1025)


def test_cpu_runs_the_plain_tier_past_every_kernel():
    """On the CPU the wrapper runs the plain tier at any width, counting no
    launch; past 1024 too, where the card raises."""
    qs, ts, _ = mode_inputs("linear_lens")
    counts = (banded_batch.banded_batch.launches, banded_batch.banded_batch.launches_wide)
    got = banded_batch.banded_batch(qs[:2, :40], ts[:2, :40], bandwidth=1100, device="cpu")
    want = banded_batch.banded_batch_plain(qs[:2, :40], ts[:2, :40], bandwidth=1100,
                                           device="cpu")
    assert_fields_equal(got, want)
    assert counts == (banded_batch.banded_batch.launches,
                      banded_batch.banded_batch.launches_wide)
