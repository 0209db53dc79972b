"""Semi-global and global alignment under gap penalties <= 0 and matrix
entries past +-127, on the CPU against the JAX package (seed 10000,
tolerance 0).

Under such a gap row 0 and column 0 are >= 0 and can hold the first
maximum in row-major order, which the semi-global kernel
(``csrc/sw_semiglobal.cu``) tracks: row 0's best in closed form, then
each row's column-0 cell before its own. Held here:

- the plain tiers (``semiglobal_batch_plain``, ``semiglobal_profile_plain``)
  and the kernel's CPU mirror (``semiglobal_skew_mirror``) against JAX's
  XLA tier (``semiglobal_batch_diag`` / ``semiglobal_batch_general``,
  ``nw_*``) under gap 0, -1, Gotoh 2/-1, 3/0, 0/1 and -2/1, BLOSUM62 11/0,
  11/-1 and x 12 (entries to 132), and dna_matrix(200, -150); argmax and
  pinned, fixed widths and per-pair lengths down to 0, internal pads;
- the port's oracle copy under gap -1;
- the packed key's bound from the matrix's own largest |entry| and |go|;
- on a pretend card, both wrappers launch the kernel for these scorings;
- ``semiglobal_align_batch`` / ``nw_align_batch`` against JAX's.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.batch import traceback as jax_traceback
from swtpu.core.protein import BLOSUM62
from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu.kernels.xla import semiglobal_scan as jax_scan
from swtpu_torch.batch import traceback as port_traceback
from swtpu_torch.core.scoring import ScoringParams, dna_matrix, scoring_from_numpy
from swtpu_torch.kernels import semiglobal_batch as sb
from swtpu_torch.kernels import semiglobal_profile as sp
from swtpu_torch.oracle.semiglobal import semiglobal_affine_full, semiglobal_full

SEED = 10000
UNIFORM = {
    "gap_0": dict(match=1, mismatch=1, gap=0),
    "gap_-1": dict(match=1, mismatch=1, gap=-1),
    "gotoh_2_-1": dict(match=2, mismatch=1, gap_open=2, gap_extend=-1),
    "gotoh_3_0": dict(match=2, mismatch=3, gap_open=3, gap_extend=0),
    "gotoh_0_1": dict(match=1, mismatch=1, gap_open=0, gap_extend=1),
    "gotoh_-2_1": dict(match=1, mismatch=2, gap_open=-2, gap_extend=1),
}
MATRIX = {
    "blosum62_11_0": JaxScoring(BLOSUM62, 11, 0),
    "blosum62_11_-1": JaxScoring(BLOSUM62, 11, -1),
    "blosum62x12_11_1": JaxScoring(BLOSUM62 * 12, 11, 1),
    "dna200_linear_-3": JaxScoring.linear(dna_matrix(200, -150), -3),
}
R = sb.ROWS
# (B, n, m): two sweeps with a ragged last one; a target shorter than a
# sweep's rows (the masked groups)
SHAPES = ((10, 2 * R + 3, R + 5), (8, R + 1, R - 3))


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def _pairs(rng, B, n, m, A):
    qs = rng.integers(0, A, (B, n)).astype(np.uint8)
    ts = rng.integers(0, A, (B, m)).astype(np.uint8)
    pq, pt = (4, 5) if A == 4 else (24, 25)
    qs[rng.random(qs.shape) < 0.05] = pq
    ts[rng.random(ts.shape) < 0.05] = pt
    lq, lt = rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)
    lq[:4], lt[:4] = (0, n, 0, n), (m, 0, 0, m)
    return qs, ts, dict(lens_q=lq, lens_t=lt)


def _equal(got, want):
    for g, w in zip(tuple(got), tuple(want), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", list(UNIFORM))
def test_uniform_plain_and_mirror_match_xla(name):
    s = UNIFORM[name]
    for B, n, m in SHAPES:
        qs, ts, lens = _pairs(np.random.default_rng(SEED + n), B, n, m, 4)
        for kw in (lens, {}):
            for pin in (False, True):
                want = jax_scan.semiglobal_batch_diag(qs, ts, **s, **kw, pin_end=pin)
                _equal(sb.semiglobal_batch(qs, ts, **s, **kw, pin_end=pin, device="cpu"),
                       want)
                _equal(sb.semiglobal_skew_mirror(qs, ts, **s, **kw, pin_end=pin), want)
            np.testing.assert_array_equal(
                sb.semiglobal_skew_mirror(qs, ts, **s, **kw, pin_end=True)[0].numpy(),
                np.asarray(jax_scan.nw_batch_diag(qs, ts, **s, **kw)))


@pytest.mark.parametrize("name", list(MATRIX))
def test_matrix_plain_and_mirror_match_xla(name):
    p = MATRIX[name]
    A = p.alphabet_size
    for B, n, m in SHAPES:
        qs, ts, lens = _pairs(np.random.default_rng(SEED + n), B, n, m, A)
        for kw in (lens, {}):
            for pin in (False, True):
                want = jax_scan.semiglobal_batch_general(qs, ts, p, **kw, pin_end=pin)
                _equal(sp.semiglobal_profile(qs, ts, port(p), **kw, pin_end=pin,
                                             device="cpu"), want)
                _equal(sb.semiglobal_skew_mirror(qs, ts, **kw, pin_end=pin,
                                                 params=port(p)), want)


def test_boundary_cells_hold_the_first_maximum():
    """All-mismatch pairs under gap -1: every gap step climbs, so the
    first maximum is each pair's far corner, and column 0's last cell for
    a pair with no column (lt = 0); gap 0 ties the origin, which keeps
    it."""
    qs, ts = np.zeros((3, 5), np.uint8), np.ones((3, 7), np.uint8)
    kw = dict(lens_q=[5, 5, 3], lens_t=[7, 0, 2])
    s = dict(match=1, mismatch=9, gap=-1)
    want = jax_scan.semiglobal_batch_diag(qs, ts, **s, **kw)
    got = sb.semiglobal_skew_mirror(qs, ts, **s, **kw)
    _equal(got, want)
    _equal(sb.semiglobal_batch(qs, ts, **s, **kw, device="cpu"), want)
    assert [x.tolist() for x in got] == [[12, 5, 5], [5, 5, 3], [7, 0, 2]]
    zero = sb.semiglobal_skew_mirror(qs, ts, match=1, mismatch=9, gap=0)
    assert [x.tolist() for x in zero] == [[0, 0, 0]] * 3


@pytest.mark.parametrize("affine", [False, True])
def test_plain_matches_the_oracle_copy_under_a_negative_gap(affine):
    rng = np.random.default_rng(SEED)
    qs, ts = rng.integers(0, 4, (4, 16)), rng.integers(0, 4, (4, 32))
    if affine:
        got = sb.semiglobal_batch(qs, ts, 1, 1, gap_open=2, gap_extend=-1, device="cpu")
        want = [semiglobal_affine_full(q, t, 1, 1, gap_open=2, gap_extend=-1)
                for q, t in zip(qs, ts)]
    else:
        got = sb.semiglobal_batch(qs, ts, 1, 1, -1, device="cpu")
        want = [semiglobal_full(q, t, 1, 1, -1) for q, t in zip(qs, ts)]
    assert got[0].tolist() == [w[0] for w in want]
    assert list(zip(got[1].tolist(), got[2].tolist())) == [tuple(w[1][-1]) for w in want]


def test_key_bits_takes_the_matrix_own_range():
    """The packed key bounds |H - go| by (n + m + ROWS + GROUP) x the
    largest |score|, |go| or |ge|, plus |go| + 1: a negative go counts by
    its size, and a profile launch passes its matrix's largest |entry|."""
    assert sb.key_bits(128, 128, 1, -1, -1, -1) == 8
    assert sb.key_bits(128, 128, 132, 0, 11, 1) == 8
    big = sb.key_bits(16384, 16384, 1, -1, 1, 1)
    assert big is not None and sb.key_bits(16384, 16384, 1, -1, -200, 1) is None
    # wide entries past the key's range fall to the select tracker, exact
    qs, ts, lens = _pairs(np.random.default_rng(SEED), 6, R + 2, R + 5, 4)
    wide = JaxScoring.linear(dna_matrix(10**6, -1), -1)
    assert sb.key_bits(R + 2, R + 5, 10**6, 0, -1, -1) is None
    _equal(sb.semiglobal_skew_mirror(qs, ts, **lens, params=port(wide)),
           jax_scan.semiglobal_batch_general(qs, ts, wide, **lens))


def test_profile_form_refuses_only_alphabets_its_table_cannot_hold():
    for p in MATRIX.values():
        assert sp.semiglobal_profile_refusal(port(p)) is None
    assert sp.semiglobal_profile_refusal(
        ScoringParams.linear(np.eye(40, dtype=np.int64), 1)) is not None


@pytest.fixture
def pretend_card(monkeypatch):
    """A card for the wrappers: codes, lengths and table stay on the CPU,
    and the launch records its arguments and returns JAX's XLA tier's
    result on them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls, cpu = [], torch.device("cpu")
    lens_tensor = sb.lens_tensor
    monkeypatch.setattr(sb, "as_codes", lambda x, d: torch.as_tensor(np.asarray(x)))
    for mod in (sb, sp):
        monkeypatch.setattr(mod, "lens_tensor", lambda x, B, d: lens_tensor(x, B, cpu))
    monkeypatch.setattr(sp, "profile_table", lambda p, d: "table")

    def launch(q, t, match, mismatch, go, ge, affine, pin_end, lens_q=None, lens_t=None,
               table=None, n_codes=None):
        calls.append(dict(match=match, mismatch=mismatch, go=go, ge=ge, affine=affine,
                          profile=table is not None))
        return tuple(torch.zeros(q.shape[0], dtype=torch.int32) for _ in range(3))

    for mod in (sb, sp):
        monkeypatch.setattr(mod, "semiglobal_launch_t", launch)
    return calls


@pytest.mark.parametrize("name", ["gap_-1", "gotoh_3_0", "blosum62_11_-1",
                                  "blosum62x12_11_1"])
def test_wrappers_launch_the_kernel_for_these_scorings(pretend_card, name):
    q = np.zeros((2, 8), np.uint8)
    if name in UNIFORM:
        sb.semiglobal_batch(q, q, **UNIFORM[name], pin_end=True)
        go, ge, affine = sb.gaps(**{k: v for k, v in UNIFORM[name].items()
                                    if k.startswith("gap")})
        want = dict(match=UNIFORM[name]["match"], mismatch=-UNIFORM[name]["mismatch"],
                    go=go, ge=ge, affine=affine, profile=False)
    else:
        p = port(MATRIX[name])
        sp.semiglobal_profile(q, q, p)
        want = dict(match=int(np.abs(p.matrix).max()), mismatch=0, go=p.gap_open,
                    ge=p.gap_extend, affine=not p.is_linear, profile=True)
    assert pretend_card == [want]


@pytest.mark.parametrize("pin", [False, True])
def test_align_batch_matches_jax_under_negative_gaps(pin):
    """Both packages' walks on the same device scores and endpoints. An
    empty query under a negative gap fails the semi-global walk's check in
    both: the C++ walker gives 0 at (0, 0) where the scan takes row 0's
    last cell (ROADMAP.md, reference-side notes)."""
    rng = np.random.default_rng(SEED)
    qs, ts, lens = _pairs(rng, 6, 20, 28, 4)
    qs[qs > 3], ts[ts > 3] = 0, 1  # the host walks index real codes only
    lens = {k: np.maximum(v, 1) for k, v in lens.items()}
    fn = "nw_align_batch" if pin else "semiglobal_align_batch"
    for kw in (dict(match=1, mismatch=1, gap=-1),
               dict(match=2, mismatch=1, gap_open=2, gap_extend=-1)):
        got = getattr(port_traceback, fn)(qs, ts, **kw, **lens, device="cpu")
        assert got == getattr(jax_traceback, fn)(qs, ts, **kw, **lens)
    if not pin:
        empty = dict(lens_q=[0], lens_t=[28])
        for call in (lambda: port_traceback.semiglobal_align_batch(
                         qs[:1], ts[:1], 1, 1, -1, **empty, device="cpu"),
                     lambda: jax_traceback.semiglobal_align_batch(
                         qs[:1], ts[:1], 1, 1, -1, **empty)):
            with pytest.raises(AssertionError):
                call()
