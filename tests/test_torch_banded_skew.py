"""The fixed-band kernel's skewed tile, replayed on the CPU: port vs JAX.

``sw_banded.banded_skew_mirror`` follows ``csrc/sw_banded.cu`` step for
step (sweeps of ROWS rows in band coordinates, row r two steps behind
row r - 1; the compile-time schedule for sweeps of K >= 30 offsets, with
its row ranges, the diagonal a starting row takes and the dead values a
finished row hands down; the masked groups of narrower sweeps; cells
outside the matrix at a score <= 0; the G = H - go cells; the hand-off
between sweeps with its dead slots; per-pair rows, columns and band). The
same numpy inputs (seed 10000) go through it, the plain tier and the
JAX package's oracle, tolerance 0, for all four forms (uniform and
profile, linear and Gotoh):

- W in {0, 1, 7, 32, >= max(n, m)} on n below ROWS, n and m not
  multiples of 16, m below 16, a tall matrix, one cell; odd batches;
  pads inside the sequences (4 / 5, protein 24 / 25) at matrix.min();
- per-pair lengths down to 0, and a matrix whose pads score above 0
  (each pair then runs the full width with pads past its lengths);
- the optimal path on the left band edge across sweeps;
- JAX's Pallas kernels in interpret mode, in
  tests/test_torch_banded_static.py, inside their one interpret call each.

And on a pretend card, the wrappers hand the launch the caller's [B, n] /
[B, m] codes, untransposed and not overwritten, with the lengths beside
them. The kernel itself is held against the plain tier on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.core.encode import mutate
from swtpu.core.protein import BLOSUM62
from swtpu.core.scoring import ScoringParams, dna_matrix
from swtpu.oracle import banded_static as jax_oracle
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import semiglobal_batch as sb
from swtpu_torch.kernels import sw_banded
from swtpu_torch.utils import device as port_device

FORMS = {
    "uniform_linear": (ScoringParams.linear(dna_matrix(1, -1), 1), False),
    "uniform_gotoh": (ScoringParams(dna_matrix(2, -3), 5, 2), False),
    "profile_linear": (ScoringParams.linear(BLOSUM62, 11), True),
    "profile_gotoh": (ScoringParams(BLOSUM62, 11, 1), True),
}
R = sw_banded.ROWS
# (B, n, m): n below ROWS, n and m ragged past two sweeps, m below ROWS, a
# tall matrix whose last rows leave the band, one cell
SHAPES = {
    "n_below_rows": (5, R - 5, 40),
    "ragged": (4, 2 * R + 5, 2 * R + 11),
    "m_below_rows": (5, 2 * R + 8, R - 5),
    "tall": (3, 70, 24),
    "one_cell": (3, 1, 1),
}
WIDTHS = [0, 1, 7, 32, 100]


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def letters(p):
    return 4 if p.alphabet_size == 4 else 20


def pairs(rng, p, B, n, m, pads=0.03):
    """B pairs, the first half related (about 85% identity), with a share
    ``pads`` of the codes set to the pads (alphabet, alphabet + 1)."""
    A = letters(p)
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, A, size=(B, m)).astype(np.uint8)
    for b in range(B // 2):
        ts[b] = mutate(rng, qs[b], p_mismatch=0.15, out_len=m) % A
    qs[rng.random(qs.shape) < pads] = p.alphabet_size
    ts[rng.random(ts.shape) < pads] = p.alphabet_size + 1
    return qs, ts


def oracle(qs, ts, p, W, lens_q=None, lens_t=None):
    """JAX's oracle with pads scoring matrix.min() (its extended matrix),
    on each pair cut to its lengths."""
    A = p.alphabet_size
    ext = np.full((A + 2, A + 2), int(p.matrix.min()), np.int32)
    ext[:A, :A] = p.matrix
    pe = ScoringParams(ext, p.gap_open, p.gap_extend)
    lq = [qs.shape[1]] * len(qs) if lens_q is None else lens_q
    lt = [ts.shape[1]] * len(ts) if lens_t is None else lens_t
    return np.array([jax_oracle.sw_banded_static_score(q[:a], t[:c], pe, W)
                     for q, t, a, c in zip(qs, ts, lq, lt)])


def three_way(qs, ts, form, W, **lens):
    p, profile = FORMS[form]
    got = sw_banded.banded_skew_mirror(qs, ts, port(p), W, profile=profile, **lens)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = sw_banded.sw_banded_plain(qs, ts, port(p), W, device="cpu", **lens)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), oracle(qs, ts, p, W, **lens))
    return got.numpy()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("form", list(FORMS))
def test_mirror_equals_plain_and_oracle(form, shape):
    B, n, m = SHAPES[shape]
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, FORMS[form][0], B, n, m)
    for W in WIDTHS:
        three_way(qs, ts, form, W)


@pytest.mark.parametrize("form", list(FORMS))
def test_mirror_per_pair_lengths(form):
    """Lengths down to 0 (the empty pair, full pairs, the rest random)."""
    B, n, m = 6, 2 * R + 5, 2 * R + 11
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, FORMS[form][0], B, n, m)
    lq, lt = rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)
    lq[:3], lt[:3] = (0, n, 0), (m, 0, 0)
    for W in (7, 32):
        three_way(qs, ts, form, W, lens_q=lq, lens_t=lt)


def test_mirror_pads_above_zero():
    """A matrix whose smallest entry is positive: pads past a pair's
    length can win, so each pair runs the whole n x m (no trimming)."""
    p = ScoringParams(np.arange(16).reshape(4, 4) % 5 + 1, 2, 1)
    rng = np.random.default_rng(10000)
    B, n, m = 4, 2 * R + 5, 40
    qs, ts = pairs(rng, p, B, n, m)
    lq, lt = rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)
    for W in (7, 32):
        for lens in ({}, dict(lens_q=lq, lens_t=lt)):
            got = sw_banded.banded_skew_mirror(qs, ts, port(p), W, profile=True, **lens)
            want = sw_banded.sw_banded_plain(qs, ts, port(p), W, device="cpu", **lens)
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(got.min()) > 0


@pytest.mark.parametrize("form", list(FORMS))
def test_mirror_left_edge_across_sweeps(form):
    """t = q[W:] puts the optimal path on the left band edge j = i - W,
    whose diagonal crosses from sweep to sweep through the hand-off."""
    W = 16
    p = FORMS[form][0]
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, letters(p), size=(3, 4 * R)).astype(np.uint8)
    ts = qs[:, W:].copy()
    got = three_way(qs, ts, form, W)
    assert got.min() > 20


# -- the wrappers hand the launch [B, L] codes ---------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Pretend a card exists for the fixed-band wrappers: codes, lengths
    and table stay on the CPU, and the launch is a recorder that returns
    the plain tier's result, computed apart; the plain tier as the
    wrappers see it fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    cpu = torch.device("cpu")
    plain = sw_banded.sw_banded_plain
    lens_tensor = sb.lens_tensor

    def as_codes(x, device):
        assert device.type == "cuda"
        return port_device.as_codes(x, cpu)

    def lens(x, B, device):
        assert device.type == "cuda"
        return lens_tensor(x, B, cpu)

    def table(matrix, device):
        assert device.type == "cuda"
        return torch.zeros((8, 8), dtype=torch.int32)

    def launch(q, t, params, bandwidth, table=None, lens_q=None, lens_t=None):
        calls.append((q, t, table is not None, lens_q, lens_t))
        return plain(q, t, params, bandwidth, lens_q, lens_t, device="cpu")

    monkeypatch.setattr(sb, "as_codes", as_codes)
    monkeypatch.setattr(sw_banded, "lens_tensor", lens)
    monkeypatch.setattr(sw_banded, "banded_table", table)
    monkeypatch.setattr(sw_banded, "banded_launch_t", launch)
    monkeypatch.setattr(sw_banded, "sw_banded_plain",
                        lambda *a, **k: pytest.fail("plain tier ran on CUDA"))
    return calls


@pytest.mark.parametrize("layout", ["numpy", "torch"])
@pytest.mark.parametrize("form", list(FORMS))
def test_wrappers_hand_the_launch_untransposed_codes(fake_card, form, layout):
    p, profile = FORMS[form]
    B, n, m = 5, 2 * R + 3, 2 * R + 7
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, p, B, n, m)
    lq, lt = rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)
    q_in, t_in = ((qs, ts) if layout == "numpy"
                  else (torch.from_numpy(qs), torch.from_numpy(ts)))
    wrapper = sw_banded.sw_banded_profile if profile else sw_banded.sw_banded_static
    before = (wrapper.launches, wrapper.launches_affine)
    got = wrapper(q_in, t_in, port(p), 12, lens_q=lq, lens_t=lt)
    assert (wrapper.launches, wrapper.launches_affine) == (
        before[0] + 1, before[1] + (not p.is_linear))
    (q, t, with_table, lens_q, lens_t), = fake_card
    assert with_table == profile
    for x, h, given in ((q, qs, q_in), (t, ts, t_in)):
        assert x.dtype == torch.uint8 and x.is_contiguous()
        assert tuple(x.shape) == h.shape  # [B, n] / [B, m], not [n, B]
        np.testing.assert_array_equal(x.numpy(), h)  # no pads written over it
        if layout == "torch":
            assert x.data_ptr() == given.data_ptr()
    for x, h in ((lens_q, lq), (lens_t, lt)):
        assert x.dtype == torch.int32 and x.shape == (B,)
        np.testing.assert_array_equal(x.numpy(), h)
    np.testing.assert_array_equal(got.numpy(), oracle(qs, ts, p, 12, lq, lt))
