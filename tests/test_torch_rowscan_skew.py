"""The local row-scan's skewed tile, replayed on the CPU: port vs JAX.

``sw_batch.rowscan_skew_mirror`` (uniform scoring, csrc/sw_rowscan.cu) and
``sw_profile.profile_skew_mirror`` (the profile kernel's thread form,
csrc/sw_profile.cu) follow csrc/sw_local_tile.cuh step for step: sweeps of
ROWS rows, row r at column s - r, the opening and closing steps or, for
targets under ROWS, groups of GROUP masked at the edges, the scratch
handed from sweep to sweep, the pad rules (the min cap, the WIDE select,
the lane table), the score's pair-of-rows best, the packed key and the
select tracker and their fold. The same numpy inputs (seed 10000) go
through them and through JAX, tolerance 0:

- JAX's XLA tier (``sw_batch_diag`` / ``_ends``, ``sw_affine_batch_diag``
  / ``_ends``, general matrices through the same functions), on n below
  ROWS, at it, past it and not a multiple of it, m of 0, 1, below ROWS and
  not a multiple of 4, internal pads on both sides, mismatch >= 0, the
  tie-rich scorings, (10,-30,15), (10,-30,40,15), BLOSUM62 11 and 11/1
  and a 4x4 DNA matrix;
- scores too wide for the packed key (the select tracker) and for the
  min-cap pad rule (the WIDE form);
- the row-major tie traps, where the first maximum in column order is
  not the first in row order;
- JAX's Pallas kernels in interpret mode, once per entry, at one pad-free
  shape of two sweeps.

And on a pretend card, the wrappers hand the launch the caller's [B, n] /
[B, m] codes, untransposed. The kernels themselves are held against the
mirrors and the plain tier on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.core.protein import BLOSUM62
from swtpu.core.scoring import DNA_10_30_15, ScoringParams, dna_matrix
from swtpu.kernels.pallas.sw_affine import sw_affine_pallas, sw_affine_pallas_ends
from swtpu.kernels.pallas.sw_batch import sw_batch_pallas, sw_batch_pallas_ends
from swtpu.kernels.pallas.sw_profile import (
    sw_batch_profile_pallas,
    sw_batch_profile_pallas_ends,
)
from swtpu.kernels.xla import affine_scan as jax_affine
from swtpu.kernels.xla import sw_scan as jax_scan
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import sw_affine, sw_batch, sw_profile
from swtpu_torch.utils import device as port_device

DNA_MATRIX = np.array(
    [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]
)
TIE_RICH = ScoringParams.linear(dna_matrix(2, -1), 1)
MISMATCH_NONNEG = ScoringParams.linear(dna_matrix(1, 1), 1)
AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
AFF_TIE = ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1)
BLOSUM_LINEAR = ScoringParams.linear(BLOSUM62, 11)
BLOSUM_GOTOH = ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)
R = sw_batch.ROWS
# (B, n, m): n below ROWS, at it, past it and ragged; m 0, 1, below ROWS,
# not a multiple of 4, past ROWS
SHAPES = {
    "n15_m37": (24, R - 1, 37),
    "n16_m16": (24, R, R),
    "n17_m9": (24, R + 1, 9),
    "n33_m1": (12, 2 * R + 1, 1),
    "n20_m0": (8, 20, 0),
    "n40_m70": (16, 40, 70),
    "n129_m30": (8, 8 * R + 1, 30),
}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def pairs(rng, B, n, m, A, pads=0.0):
    """B pairs, the first half related (the target is the query with ~15%
    substitutions behind a short random head), the rest random; ``pads``
    sets that share of codes to the pad codes, inside the sequences."""
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, A, size=(B, m)).astype(np.uint8)
    for b in range(B // 2):
        t = np.concatenate([rng.integers(0, A, 2).astype(np.uint8), qs[b]])
        sub = rng.random(len(t)) < 0.15
        t[sub] = rng.integers(0, A, int(sub.sum()))
        ts[b, : min(m, len(t))] = t[:m]
    if pads:
        pq, pt = (4, 5) if A == 4 else (24, 25)
        qs[rng.random(qs.shape) < pads] = pq
        ts[rng.random(ts.shape) < pads] = pt
    return qs, ts


def xla_ends(qs, ts, p):
    fn = jax_scan.sw_batch_diag_ends if p.is_linear else jax_affine.sw_affine_batch_diag_ends
    return fn(qs, ts, p)


def xla_scores(qs, ts, p):
    fn = jax_scan.sw_batch_diag if p.is_linear else jax_affine.sw_affine_batch_diag
    return fn(qs, ts, p)


def mirror(qs, ts, p, ends, select=False):
    if sw_batch._uniform_match_mismatch(port(p)) is not None and p.alphabet_size == 4:
        return sw_batch.rowscan_skew_mirror(qs, ts, port(p), ends, select)
    return sw_profile.profile_skew_mirror(qs, ts, port(p), ends, select)


def equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def check_all(qs, ts, p, scores_too=False):
    """Both mirrors' forms on one scoring against JAX's XLA tier: the
    endpoint (the key, and the select tracker), and the score (against
    the endpoint call's score, or with ``scores_too`` the scores call)."""
    want = xla_ends(qs, ts, p)
    equal(mirror(qs, ts, p, True), want)
    equal(mirror(qs, ts, p, True, select=True), want)
    equal(mirror(qs, ts, p, False), xla_scores(qs, ts, p) if scores_too else want[0])


# n = 129 (nine sweeps) runs at the headline scorings below
TILE_SHAPES = [s for s in SHAPES if s != "n129_m30"]


@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_rowscan_mirror_equals_xla(shape):
    """Uniform scoring with internal pads on both sides: tie-rich
    (2,-1,1), mismatch >= 0 (1,1,1), Gotoh (2,-1,3,1)."""
    B, n, m = SHAPES[shape]
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, 4, pads=0.05)
    for p in (TIE_RICH, MISMATCH_NONNEG, AFF_TIE):
        check_all(qs, ts, p)


@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_profile_mirror_equals_xla(shape):
    """The thread form's mirror on a 4x4 DNA matrix (linear 1, Gotoh 3/1)
    with internal pads and codes past the table, and on BLOSUM62 11 and
    11/1 at two shapes."""
    B, n, m = SHAPES[shape]
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, 4, pads=0.05)
    if m > 3:
        ts[:, 3] = 255
    for p in (ScoringParams.linear(DNA_MATRIX, 1), ScoringParams(DNA_MATRIX, 3, 1)):
        check_all(qs, ts, p)
    if shape in ("n17_m9", "n40_m70"):
        qs, ts = pairs(rng, B, n, m, 20, pads=0.05)
        for p in (BLOSUM_LINEAR, BLOSUM_GOTOH):
            check_all(qs, ts, p, scores_too=shape == "n40_m70")


@pytest.mark.parametrize("shape", ["n16_m16", "n129_m30"])
def test_mirrors_equal_xla_at_the_headline_scorings(shape):
    """(10,-30,15) and (10,-30,40,15), each form against its own XLA call."""
    B, n, m = SHAPES[shape]
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, 4, pads=0.05)
    for p in (DNA_10_30_15, AFF):
        check_all(qs, ts, p, scores_too=True)


@pytest.mark.parametrize("shape", ["n17_m9", "n40_m70"])
@pytest.mark.parametrize("p", [
    ScoringParams.linear(dna_matrix(10**7, -1), 1),
    ScoringParams(dna_matrix(3, -(2**21)), gap_open=5, gap_extend=1),
], ids=["key_too_narrow", "pad_cap_inexact"])
def test_mirror_wide_scores_equal_xla(p, shape):
    """Scores the packed key cannot hold (the select tracker), and a
    mismatch below -2^20, where the min-cap pad rule is not exact (the WIDE
    form: the pad selected), both as the launch chooses them."""
    B, n, m = SHAPES[shape]
    match, mismatch = int(p.matrix[0, 0]), int(p.matrix[0, 1])
    end, wide, kbits = sw_batch.local_tracker(False, True, n, m, match, mismatch,
                                              p.gap_open, p.gap_extend)
    assert end == sw_batch.END_SELECT and kbits is None
    assert wide == (mismatch < sw_batch.PAD_SCORE)
    assert sw_batch.local_tracker(False, True, n, m, 2, -1, 1, 1)[0] == sw_batch.END_KEY
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, 4, pads=0.05)
    check_all(qs, ts, p)


def full_h(qs, ts, match, mismatch, gap):
    """[B, n + 1, m + 1] local DP matrices, linear gap."""
    B, n = qs.shape
    m = ts.shape[1]
    H = np.zeros((B, n + 1, m + 1), np.int64)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = np.where(qs[:, i - 1] == ts[:, j - 1], match, mismatch)
            H[:, i, j] = np.maximum(
                np.maximum(H[:, i - 1, j - 1] + s, 0),
                np.maximum(H[:, i - 1, j], H[:, i, j - 1]) - gap)
    return H


@pytest.mark.parametrize("n,m", [(10, 12), (R + 4, 12)])
def test_mirror_tie_rule_on_column_order_traps(n, m):
    """512 pairs whose maximum appears in several cells, where the first in
    column order is not the first in row order (a skewed tile sees row r's
    column j at step j + r, after row r + 1 has seen column j - 1): the
    mirror's endpoints are the row-major-first cells, as the XLA tier's;
    at n = ROWS + 4 the ties also cross a sweep."""
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, 512, n, m, 4)
    H = full_h(qs, ts, 2, -1, 1)
    B, n1, m1 = H.shape
    row_first = np.argmax(H.reshape(B, -1), axis=1)
    col_first = np.argmax(H.transpose(0, 2, 1).reshape(B, -1), axis=1)
    col_first = (col_first % n1) * m1 + col_first // n1
    assert (row_first != col_first).sum() >= 10
    for select in (False, True):
        got = sw_batch.rowscan_skew_mirror(qs, ts, port(TIE_RICH), True, select)
        np.testing.assert_array_equal(got[1].numpy() * m1 + got[2].numpy(), row_first)
        np.testing.assert_array_equal(got[0].numpy(), H.reshape(B, -1).max(axis=1))
    equal(got, xla_ends(qs, ts, TIE_RICH))


@pytest.mark.parametrize("entry", [
    "sw_batch", "sw_batch_ends", "sw_affine", "sw_affine_ends", "sw_profile",
    "sw_profile_ends",
])
def test_mirrors_equal_pallas(entry):
    """One Pallas interpret call each (2-5 s): pad-free codes, two sweeps
    of rows, n % 8 == 0 and m % 16 == 0, half the pairs related."""
    B, n, m = 16, 2 * R, 48
    rng = np.random.default_rng(10000)
    ends = entry.endswith("_ends")
    if entry.startswith("sw_profile"):
        p = BLOSUM_GOTOH if ends else BLOSUM_LINEAR
        qs, ts = pairs(rng, B, n, m, 20)
        fn = sw_batch_profile_pallas_ends if ends else sw_batch_profile_pallas
    else:
        p = AFF if entry.startswith("sw_affine") else DNA_10_30_15
        qs, ts = pairs(rng, B, n, m, 4)
        fn = {"sw_batch": sw_batch_pallas, "sw_batch_ends": sw_batch_pallas_ends,
              "sw_affine": sw_affine_pallas, "sw_affine_ends": sw_affine_pallas_ends}[entry]
    with pltpu.force_tpu_interpret_mode():
        want = fn(qs, ts, p)
    got = mirror(qs, ts, p, ends)
    equal(got, want)
    score = got[0] if ends else got
    assert int((score > 0).sum()) >= B // 2
    if ends:
        assert int(got[1].max()) > R


def test_mirror_forms_follow_the_launch_rule():
    """The mirrors' copy of the library's choice: the key where it holds,
    else the select tracker; the WIDE pad select past the min cap's range;
    a profile entry counts as 127."""
    lt = sw_batch.local_tracker
    assert lt(False, False, 128, 128, 10, -30, 15, 15) == (sw_batch.END_SCORE, False, None)
    assert lt(False, True, 128, 128, 10, -30, 40, 15) == (sw_batch.END_KEY, False, 8)
    assert lt(False, True, 128, 128, 10, -30, 40, 15, select=True)[0] == sw_batch.END_SELECT
    assert lt(False, False, 8, 8, 1, -(2**20) - 1, 1, 1) == (sw_batch.END_SCORE, True, None)
    assert lt(False, False, 8, 8, 2**30, -1, 1, 1)[1]
    assert lt(False, False, 8, 8, 1, -1, 2**20, 2**20)[1]
    assert not lt(False, False, 8, 8, 1, -(2**20), 1, 1)[1]
    assert lt(True, True, 128, 128, 0, 0, 11, 1) == (sw_batch.END_KEY, False, 8)
    assert lt(True, True, 1200, 3000, 0, 0, 11, 1) == (sw_batch.END_SELECT, False, None)
    assert sw_batch.key_bits(True, 30, 2000, 0, 0, 11, 1) == 11


# -- the wrappers hand the launch [B, L] codes ---------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Pretend a card of 132 SMs exists: codes and tables stay on the CPU,
    the launches are recorders that return the mirrors' results, and the
    plain tiers as the wrappers see them fail."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    cpu = torch.device("cpu")

    def codes(qs, ts, device, what):
        assert device.type == "cuda"
        q, t = port_device.as_codes(qs, cpu), port_device.as_codes(ts, cpu)
        return q.contiguous(), t.contiguous()

    def rowscan(q, t, params, match, mismatch, affine, ends, select=False):
        calls.append(("rowscan", q, t))
        return sw_batch.local_skew_mirror(q, t, params, ends, profile=False, affine=affine)

    def thread(q, t, table, params, ends, select=False):
        calls.append(("thread", q, t))
        return sw_profile.profile_skew_mirror(q, t, params, ends)

    monkeypatch.setattr(sw_batch, "launch_codes", codes)
    monkeypatch.setattr(sw_batch, "rowscan_launch_t", rowscan)
    monkeypatch.setattr(sw_profile, "as_codes", lambda x, device: port_device.as_codes(x, cpu))
    monkeypatch.setattr(sw_profile, "profile_table",
                        lambda params, device: torch.zeros((32, 32), dtype=torch.int32))
    monkeypatch.setattr(sw_profile, "_sm_count", lambda device: 132)
    monkeypatch.setattr(sw_profile, "profile_launch_t", thread)
    for mod, names in ((sw_batch, ("sw_batch_plain", "sw_batch_ends_plain")),
                       (sw_affine, ("sw_affine_plain", "sw_affine_ends_plain")),
                       (sw_profile, ("sw_profile_plain", "sw_profile_ends_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name,
                                lambda *a, _n=name, **k: pytest.fail(f"{_n} ran on CUDA"))
    return calls


@pytest.mark.parametrize("wrapper", ["sw_batch", "sw_batch_ends", "sw_affine",
                                     "sw_affine_ends", "sw_profile", "sw_profile_ends"])
@pytest.mark.parametrize("layout", ["numpy", "torch"])
def test_wrappers_hand_the_launch_untransposed_codes(fake_card, wrapper, layout):
    ends = wrapper.endswith("_ends")
    if wrapper.startswith("sw_profile"):
        # past 64 pairs an SM: the thread form
        B, n, m, A = sw_profile.WARP_PAIRS_PER_SM * 132 + 1, R + 3, 21, 20
        p = BLOSUM_GOTOH if ends else BLOSUM_LINEAR
        fn = getattr(sw_profile, wrapper)
    else:
        B, n, m, A = 6, R + 3, R + 7, 4
        p = AFF if wrapper.startswith("sw_affine") else DNA_10_30_15
        fn = getattr(sw_affine if wrapper.startswith("sw_affine") else sw_batch, wrapper)
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, A, pads=0.02)
    q_in, t_in = ((qs, ts) if layout == "numpy"
                  else (torch.from_numpy(qs), torch.from_numpy(ts)))
    before = fn.launches
    got = fn(q_in, t_in, port(p), device="cuda")
    assert fn.launches == before + 1
    (form, q, t), = fake_card
    assert form == ("thread" if wrapper.startswith("sw_profile") else "rowscan")
    for x, h in ((q, qs), (t, ts)):
        assert x.dtype == torch.uint8 and x.is_contiguous()
        assert tuple(x.shape) == h.shape  # [B, n] / [B, m], not [n, B]
        np.testing.assert_array_equal(x.numpy(), h)
    if B <= 64:
        equal(got, xla_ends(qs, ts, p) if ends else xla_scores(qs, ts, p))
