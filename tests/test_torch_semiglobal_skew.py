"""The semi-global kernel's skewed tile, replayed on the CPU: port vs JAX.

``semiglobal_batch.semiglobal_skew_mirror`` follows
``csrc/sw_semiglobal.cu`` step for step (sweeps of ROWS rows, row r at
column s - r, groups of GROUP steps masked at the edges, the scratch
handed from sweep to sweep, per-pair row and column counts, the per-row
trackers and their fold, the pinned corner). The same numpy inputs (seed
10000) go through it and through JAX, tolerance 0:

- JAX's XLA tier (``semiglobal_batch_diag`` / ``_general``, and the
  ``nw_*`` scores for the pinned forms), all eight forms (uniform and
  matrix, linear and affine, argmax and pinned), on n below ROWS, at
  ROWS, past it and not a multiple of it, m of 0, 1, below ROWS and not
  a multiple of GROUP, per-pair lengths down to 0, internal pads;
- scores too wide for the argmax's packed key (the select tracker);
- the column-order tie traps of ``test_torch_semiglobal.py``;
- JAX's Pallas kernels in interpret mode, once per entry, at one pad-free
  shape of two sweeps.

And on a pretend card, the wrappers hand the launch the caller's [B, n] /
[B, m] codes, untransposed. The kernel itself is held against the mirror
and the plain tier on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.core.protein import BLOSUM62
from swtpu.core.scoring import ScoringParams
from swtpu.kernels.pallas.semiglobal_batch import semiglobal_batch_pallas
from swtpu.kernels.pallas.semiglobal_profile import (
    semiglobal_batch_profile_pallas,
)
from swtpu.kernels.xla import semiglobal_scan as jax_scan
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import semiglobal_batch as sb
from swtpu_torch.kernels import semiglobal_profile as sp
from swtpu_torch.kernels import semiglobal_scan as scan
from swtpu_torch.kernels import sw_scan
from swtpu_torch.utils import device as port_device

DNA_MATRIX = np.array(
    [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]
)
# the eight forms: (scoring, pinned); uniform scorings as the wrapper's
# keyword arguments, general matrices as JAX ScoringParams
SCORINGS = {
    "uniform_linear": dict(match=2, mismatch=1, gap=1),
    "uniform_affine": dict(match=2, mismatch=3, gap_open=5, gap_extend=1),
    "blosum62_linear": ScoringParams.linear(BLOSUM62, 11),
    "blosum62_gotoh": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1),
}
FORMS = [(s, pin) for s in SCORINGS for pin in (False, True)]
R = sb.ROWS
# (B, n, m): n below ROWS, at it, past it and ragged; m 0, 1, below ROWS,
# not a multiple of GROUP, past ROWS
SHAPES = {
    "n_below_rows": (12, R // 2 - 1, 2 * R + 3),
    "n_ragged": (12, 2 * R + 3, R + 5),
    "m_zero": (6, R + 1, 0),
    "m_one": (6, R + 1, 1),
    "m_below_rows": (10, 2 * R, R - 3),
    # a last sweep of one row, m = 3 mod GROUP: the corner sits in row 0
    # of a sweep whose last group runs past m
    "one_row_past_rows": (8, R + 1, R + 7),
    "one_row_one_col": (4, 1, 1),
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


def mirror_and_xla(scoring, qs, ts, lens, pin):
    """(mirror, XLA tier, XLA nw scores for a pinned form, else None)."""
    s = SCORINGS[scoring]
    if isinstance(s, dict):
        got = sb.semiglobal_skew_mirror(qs, ts, **s, **lens, pin_end=pin)
        want = jax_scan.semiglobal_batch_diag(qs, ts, **s, **lens, pin_end=pin)
        nw = jax_scan.nw_batch_diag(qs, ts, **s, **lens) if pin else None
    else:
        got = sb.semiglobal_skew_mirror(qs, ts, **lens, pin_end=pin, params=port(s))
        want = jax_scan.semiglobal_batch_general(qs, ts, s, **lens, pin_end=pin)
        nw = jax_scan.nw_batch_general(qs, ts, s, **lens) if pin else None
    return got, want, nw


def equal(got, want):
    got, want = tuple(got), tuple(want)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("scoring,pin", FORMS)
def test_mirror_equals_xla(scoring, pin, shape):
    """Per-pair lengths (lq = 0, lt = 0, the empty pair, full pairs, the
    rest random) with internal pads, then the same codes without
    lengths."""
    B, n, m = SHAPES[shape]
    s = SCORINGS[scoring]
    A = 4 if isinstance(s, dict) else 20
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, A, pads=0.05)
    lq, lt = rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)
    lq[:4], lt[:4] = (0, n, 0, n), (m, 0, 0, m)
    for lens in (dict(lens_q=lq, lens_t=lt), {}):
        got, want, nw = mirror_and_xla(scoring, qs, ts, lens, pin)
        equal(got, want)
        if pin:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(nw))
    if pin:  # global reads the corner
        assert got[1].tolist() == [n] * B and got[2].tolist() == [m] * B


@pytest.mark.parametrize("shape", ["n_ragged", "m_below_rows"])
@pytest.mark.parametrize("scoring", [
    dict(match=10**6, mismatch=1, gap=1),
    dict(match=10**6, mismatch=3, gap_open=5, gap_extend=1),
])
def test_mirror_select_tracker_equals_xla(scoring, shape):
    """Scores whose H range the packed key cannot hold: the argmax keeps
    (best, step) apart, as the launch then does."""
    B, n, m = SHAPES[shape]
    go, ge, _ = sb.gaps(**{k: v for k, v in scoring.items() if k.startswith("gap")})
    assert sb.key_bits(n, m, scoring["match"], -scoring["mismatch"], go, ge) is None
    assert sb.key_bits(n, m, 2, -1, 1, 1) is not None
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, 4, pads=0.05)
    lens = dict(lens_q=rng.integers(0, n + 1, B), lens_t=rng.integers(0, m + 1, B))
    for kw in (lens, {}):
        equal(sb.semiglobal_skew_mirror(qs, ts, **scoring, **kw),
              jax_scan.semiglobal_batch_diag(qs, ts, **scoring, **kw))


def full_h(qs, ts, match, mismatch, gap):
    """[B, n + 1, m + 1] semi-global DP matrices, linear gap."""
    B, n = qs.shape
    m = ts.shape[1]
    H = np.zeros((B, n + 1, m + 1), np.int64)
    H[:, 0, :] = -gap * np.arange(m + 1)
    H[:, :, 0] = -gap * np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = np.where(qs[:, i - 1] == ts[:, j - 1], match, -mismatch)
            H[:, i, j] = np.maximum(H[:, i - 1, j - 1] + s,
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
    kw = SCORINGS["uniform_linear"]
    H = full_h(qs, ts, 2, 1, 1)
    B, n1, m1 = H.shape
    row_first = np.argmax(H.reshape(B, -1), axis=1)
    col_first = np.argmax(H.transpose(0, 2, 1).reshape(B, -1), axis=1)
    col_first = (col_first % n1) * m1 + col_first // n1
    assert (row_first != col_first).sum() >= 10
    got = sb.semiglobal_skew_mirror(qs, ts, **kw)
    np.testing.assert_array_equal(got[1].numpy() * m1 + got[2].numpy(), row_first)
    np.testing.assert_array_equal(got[0].numpy(), H.reshape(B, -1).max(axis=1))
    equal(got, jax_scan.semiglobal_batch_diag(qs, ts, **kw))


@pytest.mark.parametrize("entry", ["uniform", "profile"])
def test_mirror_equals_pallas(entry):
    """One Pallas interpret call each (2-5 s): pad-free codes with n % 8
    == 0 and m % 16 == 0, two sweeps of rows, half the pairs related."""
    B, n, m = 16, 2 * R, 48
    rng = np.random.default_rng(10000)
    if entry == "uniform":
        s = SCORINGS["uniform_affine"]
        qs, ts = pairs(rng, B, n, m, 4)
        with pltpu.force_tpu_interpret_mode():
            want = semiglobal_batch_pallas(qs, ts, **s)
        got = sb.semiglobal_skew_mirror(qs, ts, **s)
    else:
        s = SCORINGS["blosum62_gotoh"]
        qs, ts = pairs(rng, B, n, m, 20)
        with pltpu.force_tpu_interpret_mode():
            want = semiglobal_batch_profile_pallas(qs, ts, s)
        got = sb.semiglobal_skew_mirror(qs, ts, params=port(s))
    equal(got, want)
    assert int((got[0] > 0).sum()) >= B // 2 and int(got[1].max()) > R


# -- the wrappers hand the launch [B, L] codes ---------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Pretend a card exists for the semi-global wrappers: codes, lengths
    and table stay on the CPU, and the launch is a recorder that returns
    the plain tier's result, computed apart; the plain tier as the
    wrappers see it fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls, seen = [], {}
    cpu = torch.device("cpu")
    lens_tensor = sb.lens_tensor

    def as_codes(x, device):
        assert device.type == "cuda"
        return port_device.as_codes(x, cpu)

    def lens(x, B, device):
        assert device.type == "cuda"
        return lens_tensor(x, B, cpu)

    def table(params, device):
        assert device.type == "cuda"
        seen["params"] = params
        return torch.as_tensor(sw_scan._extended_table(params))

    def launch(q, t, match, mismatch, go, ge, affine, pin_end, lens_q=None,
               lens_t=None, table=None, n_codes=None):
        calls.append((q, t, n_codes))
        kw = dict(lens_q=lens_q, lens_t=lens_t, pin_end=pin_end, device="cpu")
        if table is not None:
            return scan.semiglobal_batch_general(q, t, seen["params"], **kw)
        return scan.semiglobal_batch_diag(q, t, match, -mismatch, gap_open=go,
                                          gap_extend=ge, **kw)

    monkeypatch.setattr(sb, "as_codes", as_codes)
    for mod in (sb, sp):
        monkeypatch.setattr(mod, "lens_tensor", lens)
        monkeypatch.setattr(mod, "semiglobal_launch_t", launch)
    monkeypatch.setattr(sp, "profile_table", table)
    for mod, name in ((sb, "semiglobal_batch_diag"), (sb, "semiglobal_batch_plain"),
                      (sp, "semiglobal_batch_general"), (sp, "semiglobal_profile_plain")):
        monkeypatch.setattr(
            mod, name,
            lambda *a, _n=name, **k: pytest.fail(f"plain tier {_n} ran on CUDA"))
    return calls


@pytest.mark.parametrize("scoring,pin", FORMS)
@pytest.mark.parametrize("layout", ["numpy", "torch"])
def test_wrappers_hand_the_launch_untransposed_codes(fake_card, scoring, pin, layout):
    B, n, m = 6, R + 3, R + 7
    s = SCORINGS[scoring]
    A = 4 if isinstance(s, dict) else 20
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, A)
    lq, lt = rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)
    q_in, t_in = ((qs, ts) if layout == "numpy"
                  else (torch.from_numpy(qs), torch.from_numpy(ts)))
    lens = dict(lens_q=lq, lens_t=lt)
    if isinstance(s, dict):
        wrapper = sb.semiglobal_batch
        before = wrapper.launches
        got = wrapper(q_in, t_in, **s, **lens, pin_end=pin)
        want = jax_scan.semiglobal_batch_diag(qs, ts, **s, **lens, pin_end=pin)
    else:
        wrapper = sp.semiglobal_profile
        before = wrapper.launches
        got = wrapper(q_in, t_in, port(s), **lens, pin_end=pin)
        want = jax_scan.semiglobal_batch_general(qs, ts, s, **lens, pin_end=pin)
    assert wrapper.launches == before + 1
    (q, t, n_codes), = fake_card
    # the profile form's lane table holds the alphabet and one pad
    assert n_codes == (None if isinstance(s, dict) else s.alphabet_size + 1)
    for x, h in ((q, qs), (t, ts)):
        assert x.dtype == torch.uint8 and x.is_contiguous()
        assert tuple(x.shape) == h.shape  # [B, n] / [B, m], not [n, B]
        np.testing.assert_array_equal(x.numpy(), h)
    equal(got, want)
