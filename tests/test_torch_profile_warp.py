"""The profile kernel's warp form (a warp per pair, lanes as row bands) on
the CPU: its dispatch rule and a plain mirror of its lane schedule.

The CUDA kernel (``csrc/sw_profile.cu::sw_profile_warp_kernel``) runs only
on the card, where tests/test_torch_cuda.py and chip_smoke.py hold it
against the plain version. Here:

- ``profile_form``, the pure function that picks the warp or the thread
  form from (B, n, m, SM count);
- ``profile_warp_mirror``, the warp form's schedule in numpy (stripes of
  32 x 4 rows, skewed columns handed down the lanes, the stripe row
  carried to the next stripe, the endpoint fold), against JAX's XLA
  profile tier at n in {1, 31, 33, 120, 300} x m in {1, 50, 320}, linear
  BLOSUM62 11 and Gotoh 11/1, tail and internal pads (tolerance 0), and at
  one shape against ``sw_batch_profile_pallas_ends`` in interpret mode
  (tail pads only: the Pallas kernel scores pads at -128);
- on a faked card, the wrappers launch the form ``profile_form`` picks
  and count it, and never run the plain version.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.core.protein import BLOSUM62
from swtpu.core.scoring import ScoringParams
from swtpu.kernels.pallas.sw_profile import sw_batch_profile_pallas_ends
from swtpu.kernels.xla.affine_scan import sw_affine_batch_diag_ends
from swtpu.kernels.xla.sw_scan import sw_batch_diag_ends
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import sw_profile

SCORINGS = {
    "blosum62_linear11": ScoringParams.linear(BLOSUM62, 11),
    "blosum62_gotoh11_1": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1),
}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def inputs(n, m, B=6, seed=10000):
    """B protein pairs: one related (the query a stretch of its target),
    query tail pads, target tail pads, internal pads on both sides, a code
    past the table."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 20, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, 20, size=(B, m)).astype(np.uint8)
    k = min(n, m)
    qs[1, :k] = ts[1, :k]
    qs[2, n // 2:] = 24
    ts[3, m // 3:] = 25
    qs[4, ::7] = 24
    ts[4, ::5] = 25
    ts[5, 0] = 255
    return qs, ts


@pytest.mark.parametrize("B,n,m,sms,form", [
    (1, 120, 800, 132, "warp"),
    (2731, 120, 800, 132, "warp"),
    (sw_profile.WARP_PAIRS_PER_SM * 132, 120, 128, 132, "warp"),
    (sw_profile.WARP_PAIRS_PER_SM * 132 + 1, 120, 128, 132, "thread"),
    (1 << 20, 128, 128, 132, "thread"),
    (1 << 20, 128, sw_profile.THREAD_MAX_M, 132, "thread"),
    (1 << 20, 128, sw_profile.THREAD_MAX_M + 1, 132, "warp"),
    (32768, 120, 800, 132, "thread"),
    (sw_profile.WARP_PAIRS_PER_SM * 16 + 1, 120, 128, 16, "thread"),
    (0, 120, 128, 132, "thread"),
    (64, 0, 128, 132, "thread"),
    (64, 120, 0, 132, "thread"),
])
def test_profile_form_rule(B, n, m, sms, form):
    assert sw_profile.profile_form(B, n, m, sms) == form


@pytest.mark.parametrize("m", [1, 50, 320])
@pytest.mark.parametrize("n", [1, 31, 33, 120, 300])
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_warp_mirror_equals_xla(scoring, n, m):
    p = SCORINGS[scoring]
    qs, ts = inputs(n, m)
    ends_fn = sw_batch_diag_ends if p.is_linear else sw_affine_batch_diag_ends
    want = [np.asarray(x) for x in ends_fn(qs, ts, p)]
    got_ends = sw_profile.profile_warp_mirror(qs, ts, port(p), ends=True)
    got_scores = sw_profile.profile_warp_mirror(qs, ts, port(p), ends=False)
    for g, w in zip(got_ends, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got_scores.numpy(), want[0])
    assert got_scores.dtype == torch.int32


@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_warp_mirror_equals_pallas(scoring):
    """Two stripes (n = 150 > 128) with tail pads on both sides."""
    p = SCORINGS[scoring]
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 20, size=(12, 150)).astype(np.uint8)
    ts = rng.integers(0, 20, size=(12, 96)).astype(np.uint8)
    qs[:4, :80] = ts[:4, :80]
    qs[:, 140:] = 24
    ts[6:, 70:] = 25
    with pltpu.force_tpu_interpret_mode():
        want = sw_batch_profile_pallas_ends(qs, ts, p)
    got = sw_profile.profile_warp_mirror(qs, ts, port(p), ends=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].max()) > 0


@pytest.fixture
def fake_profile_card(monkeypatch):
    """Pretend a card of 132 SMs exists: codes and tables stay on the CPU,
    both forms' launches are recorders, the plain versions fail."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    cpu = torch.device("cpu")
    as_codes = sw_profile.as_codes

    def launch(form):
        def fn(q, t, table, params, ends):
            calls.append((form, tuple(q.shape), not params.is_linear, ends))
            z = torch.zeros((q.shape[0],), dtype=torch.int32)
            return (z, z, z) if ends else z
        return fn

    monkeypatch.setattr(sw_profile, "as_codes", lambda x, device: as_codes(x, cpu))
    monkeypatch.setattr(sw_profile, "profile_table",
                        lambda params, device: torch.zeros((32, 32), dtype=torch.int32))
    monkeypatch.setattr(sw_profile, "_sm_count", lambda device: 132)
    monkeypatch.setattr(sw_profile, "profile_warp_launch_t", launch("warp"))
    monkeypatch.setattr(sw_profile, "profile_launch_t", launch("thread"))
    for name in ("sw_profile_plain", "sw_profile_ends_plain", "sw_batch_diag",
                 "sw_batch_diag_ends", "sw_affine_batch_diag",
                 "sw_affine_batch_diag_ends"):
        monkeypatch.setattr(sw_profile, name,
                            lambda *a, _n=name, **k: pytest.fail(f"{_n} ran on CUDA"))
    return calls


@pytest.mark.parametrize("B,form", [(3, "warp"), (sw_profile.WARP_PAIRS_PER_SM * 132, "warp"),
                                    (sw_profile.WARP_PAIRS_PER_SM * 132 + 1, "thread")])
@pytest.mark.parametrize("scoring", list(SCORINGS))
@pytest.mark.parametrize("ends", [False, True])
def test_wrappers_launch_the_form_the_rule_picks(fake_profile_card, ends, scoring, B, form):
    p = port(SCORINGS[scoring])
    wrapper = sw_profile.sw_profile_ends if ends else sw_profile.sw_profile
    q = np.zeros((B, 5), np.uint8)
    t = np.zeros((B, 7), np.uint8)
    names = ("launches", "launches_affine", "launches_warp", "launches_warp_affine")
    before = [getattr(wrapper, k) for k in names]
    wrapper(q, t, p, device="cuda")
    affine, warp = not p.is_linear, form == "warp"
    assert fake_profile_card == [(form, (B, 5), affine, ends)]  # both forms: [B, n]
    assert [getattr(wrapper, k) for k in names] == [
        before[0] + 1, before[1] + affine, before[2] + warp, before[3] + (warp and affine)]
