"""The local engines under the scorings the row-scan and profile kernels'
guards refuse, on the CPU: the plain tiers against JAX's XLA tier, a plain
mirror of the general kernel's strip schedule against them, and the
dispatch.

JAX's TPU dispatch sends these scorings to its XLA tier (``best_engine``
past the Pallas guards, ``best_ends_engine``'s fallback); on the card the
port sends them to ``csrc/sw_general.cu`` (tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version there). Here, tolerance
0, on the scorings gap 0, gap -1, Gotoh 3/0 (a constant gap cost), Gotoh
2/-1, and a 4 x 4 matrix with entries of +-200 (linear and Gotoh):

- the port's plain tiers (``sw_scan.sw_batch_diag(_ends)``,
  ``affine_scan.sw_affine_batch_diag(_ends)``) against JAX's XLA ones;
- ``general_strip_mirror`` below, the sweep form's schedule (strips of 16
  rows swept over the tier's whole diagonal range, the start values below
  diagonal 2, the fills above row 0, rows past n and diagonals past n + m
  untracked, the endpoint tracked on H) against the plain tier on shapes
  around the strip (n = 0, 15, 16, 17, 40), m = 0 and 1, pads inside;
- ``general_tile_mirror`` below, the tile form's schedule (the skewed
  register tile over the real cells, ``sw_batch.local_skew_mirror`` with
  the lane table and the general kernel's key range) against the plain
  tier under every scoring with no negative gap penalty (gap 0, Gotoh 3/0
  and 0/2, the +-200 matrix linear 5 and Gotoh 30/5, BLOSUM62 x 12), on n
  in {0, 15, 16, 17, 40} x m in {0, 1, 3, 4, 5, 17} (the opening and
  closing steps at m >= 16, the masked groups below, the row scratch past
  one sweep), pads inside, with each tracker: the score, the packed key,
  the select tracker;
- the dispatch as pure functions: which kernel family the card takes for
  each scoring (``ops.variants.local_form``), which form of the general
  kernel (``sw_general.general_form``), the CPU engines.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.core.scoring import ScoringParams, dna_matrix
from swtpu.kernels.xla import affine_scan as jax_affine
from swtpu.kernels.xla import sw_scan as jax_scan
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import affine_scan, sw_general, sw_scan
from swtpu_torch.kernels.affine_scan import NEG_EF
from swtpu_torch.kernels.sw_batch import END_KEY, END_SCORE, END_SELECT, local_skew_mirror
from swtpu_torch.kernels.sw_batch import local_tracker
from swtpu_torch.kernels.sw_general import ROWS, general_form, max_entry
from swtpu_torch.kernels.sw_scan import _extended_table
from swtpu_torch.utils.device import as_codes
from swtpu_torch.ops import best_ends_engine, best_engine
from swtpu_torch.ops.variants import local_form

WIDE = np.where(np.eye(4, dtype=bool), 200, -150)
WIDE[0, 2] = WIDE[2, 0] = -100  # transitions: not uniform, past the profile's 127
EDGE = np.where(np.eye(4, dtype=bool), 127, -127)  # the profile kernel's widest
EDGE[0, 1] = -126  # not uniform
SCORINGS = {
    "gap0": ScoringParams.linear(dna_matrix(1, -1), 0),
    "gap_minus1": ScoringParams.linear(dna_matrix(2, -3), -1),
    "gotoh3_0": ScoringParams(dna_matrix(2, -3), gap_open=3, gap_extend=0),
    "gotoh2_minus1": ScoringParams(dna_matrix(2, -3), gap_open=2, gap_extend=-1),
    "wide200_linear": ScoringParams.linear(WIDE, 5),
    "wide200_gotoh": ScoringParams(WIDE, gap_open=30, gap_extend=5),
}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def pairs(rng, B, n, m, pads=0.05):
    """B pairs, half related (the target the query with ~15% substitutions
    behind a short head), pads (4 / 5) inside both sides."""
    qs = rng.integers(0, 4, (B, n)).astype(np.uint8)
    ts = rng.integers(0, 4, (B, m)).astype(np.uint8)
    for b in range(B // 2):
        t = np.concatenate([rng.integers(0, 4, 2).astype(np.uint8), qs[b]])
        sub = rng.random(len(t)) < 0.15
        t[sub] = rng.integers(0, 4, int(sub.sum()))
        ts[b, : min(m, len(t))] = t[:m]
    qs[rng.random(qs.shape) < pads] = 4
    ts[rng.random(ts.shape) < pads] = 5
    return qs, ts


def equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = tuple(want) if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def plain(qs, ts, p, ends):
    if p.is_linear:
        fn = sw_scan.sw_batch_diag_ends if ends else sw_scan.sw_batch_diag
    else:
        fn = affine_scan.sw_affine_batch_diag_ends if ends else affine_scan.sw_affine_batch_diag
    return fn(qs, ts, p, "cpu")


def xla(qs, ts, p, ends):
    if p.is_linear:
        fn = jax_scan.sw_batch_diag_ends if ends else jax_scan.sw_batch_diag
    else:
        fn = jax_affine.sw_affine_batch_diag_ends if ends else jax_affine.sw_affine_batch_diag
    return fn(qs, ts, p)


@pytest.mark.parametrize("name", list(SCORINGS) + ["gotoh0_2", "blosum62x12_gotoh"])
def test_plain_equals_xla(name):
    """Scores and endpoints at 24 x 30 x 45: the phantom cells of gap <= 0
    reach the real ones, in both tiers alike."""
    p = SCORINGS.get(name) or TILE_SCORINGS[name]
    qs, ts = tile_pairs(np.random.default_rng(10000), port(p), 24, 30, 45)
    for ends in (False, True):
        equal(plain(qs, ts, port(p), ends), xla(qs, ts, p, ends))


def general_strip_mirror(qs, ts, params, ends):
    """The kernel's schedule replayed in numpy over the batch: strips of
    ROWS rows swept column by column from diagonal 2 - (i0 + ROWS - 1) to n
    + m - i0, cells below diagonal 2 at the start values (H 0, E = F =
    -2^29), the row above a strip from the fill (row -1: 0 linear, -2^29
    Gotoh), the start values or the previous strip's last row, the table
    lookup with the query pad on row 0 and the target pad outside columns
    1..m, rows past n and diagonals past n + m untracked, the endpoint
    replaced on a greater H or an equal H on a smaller row. Same outputs
    as ``sw_general`` / ``sw_general_ends`` (int32 tensors on the CPU).
    The card's kernel (``csrc/sw_general.cu``) follows the same schedule."""
    cpu = torch.device("cpu")
    q = as_codes(qs, cpu).numpy().astype(np.int64)
    t = as_codes(ts, cpu).numpy().astype(np.int64)
    B, n = q.shape
    m = t.shape[1]
    tab = _extended_table(params).astype(np.int64)
    stride = tab.shape[0]
    qpad, tpad = stride - 2, stride - 1
    affine = not params.is_linear
    gap = params.gap_open
    go, ge = params.gap_open, params.gap_extend
    D = n + m
    fill = NEG_EF if affine else 0
    wrap = np.int64(2**32)

    def i32(x):  # the kernel's int32 arithmetic
        return (x + 2**31) % wrap - 2**31

    scratch = {}
    best = np.zeros(B, np.int64)
    bi = np.zeros(B, np.int64)
    bj = np.zeros(B, np.int64)
    for i0 in range(0, n + 1, ROWS):
        rows = np.arange(i0, i0 + ROWS)
        qc = np.full((B, ROWS), qpad)
        real = (rows >= 1) & (rows <= n)
        qc[:, real] = np.minimum(q[:, rows[real] - 1], qpad)
        hl = np.zeros((B, ROWS), np.int64)
        el = np.full((B, ROWS), NEG_EF, np.int64)
        jmin, jmax = 2 - (i0 + ROWS - 1), D - i0
        more = i0 + ROWS <= n

        def up(j):
            if i0 == 0:
                return np.full(B, fill, np.int64), np.full(B, NEG_EF, np.int64)
            if i0 - 1 + j <= 1:
                return np.zeros(B, np.int64), np.full(B, NEG_EF, np.int64)
            return scratch[j]

        hdg, _ = up(jmin - 1)
        new = {}
        for j in range(jmin, jmax + 1):
            tc = (np.minimum(t[:, j - 1], tpad) if 1 <= j <= m else np.full(B, tpad))
            hu, fu = up(j)
            hd, hdg = hdg, hu
            for r in range(ROWS):
                i, d = i0 + r, i0 + r + j
                s = tab[qc[:, r], tc]
                if affine:
                    e = np.maximum(i32(el[:, r] - ge), i32(hl[:, r] - go))
                    f = np.maximum(i32(fu - ge), i32(hu - go))
                    h = np.maximum(np.maximum(i32(hd + s), 0), np.maximum(e, f))
                else:
                    e = f = np.full(B, NEG_EF, np.int64)
                    h = np.maximum(np.maximum(i32(hd + s), i32(hu - gap)),
                                   np.maximum(i32(hl[:, r] - gap), 0))
                if d < 2:
                    h = np.zeros(B, np.int64)
                    e = f = np.full(B, NEG_EF, np.int64)
                if 2 <= d <= D and i <= n:
                    upd = (h > best) | ((h == best) & (i < bi)) if ends else h > best
                    best = np.where(upd, h, best)
                    bi = np.where(upd, i, bi)
                    bj = np.where(upd, j, bj)
                hd = hl[:, r].copy()
                hl[:, r] = h
                el[:, r] = e
                hu, fu = h, f
            if more:
                new[j] = (hu, fu)
        scratch = new
    score = torch.from_numpy(best.astype(np.int32))
    if not ends:
        return score
    pos = best > 0
    return (score, torch.from_numpy(np.where(pos, bi, 0).astype(np.int32)),
            torch.from_numpy(np.where(pos, bj, 0).astype(np.int32)))


# (B, n, m) around the strip of 16 rows, empty and one-column targets
SHAPES = [(6, 0, 7), (6, 15, 20), (6, 16, 16), (6, 17, 1), (5, 40, 33), (4, 9, 0)]


@pytest.mark.parametrize("name", list(SCORINGS))
def test_strip_mirror_equals_plain(name):
    p = port(SCORINGS[name])
    rng = np.random.default_rng(10000)
    for B, n, m in SHAPES:
        qs, ts = pairs(rng, B, n, m)
        for ends in (False, True):
            equal(general_strip_mirror(qs, ts, p, ends), plain(qs, ts, p, ends))


def test_strip_mirror_protein_gap0():
    """BLOSUM62 with gap 0 (the profile guard refuses it), 40 x 50."""
    p = port(ScoringParams(np.asarray(BLOSUM62), gap_open=0, gap_extend=0))
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 25, (5, 40)).astype(np.uint8)
    ts = rng.integers(0, 26, (5, 50)).astype(np.uint8)
    for ends in (False, True):
        equal(general_strip_mirror(qs, ts, p, ends), plain(qs, ts, p, ends))


def general_tile_mirror(qs, ts, params, ends, select=False):
    """The tile form's schedule (``csrc/sw_general.cu``
    ``sw_general_tile_kernel`` on ``csrc/sw_local_tile.cuh``) replayed on
    the CPU: the shared tile's mirror with the lane table's lookups (the
    extended table, codes clamped to the alphabet + 1) and the key range of
    the matrix's own largest |entry|, as the library picks its tracker.
    Same outputs as ``sw_general`` / ``sw_general_ends``."""
    assert general_form(params) == "tile"
    return local_skew_mirror(qs, ts, params, ends, profile=True, select=select,
                             entry=max_entry(params))


B62 = np.asarray(BLOSUM62)
TILE_SCORINGS = {
    "gap0": ScoringParams.linear(dna_matrix(1, -1), 0),
    "gotoh3_0": ScoringParams(dna_matrix(2, -3), gap_open=3, gap_extend=0),
    "gotoh0_2": ScoringParams(dna_matrix(2, -3), gap_open=0, gap_extend=2),
    "wide200_linear": SCORINGS["wide200_linear"],
    "wide200_gotoh": SCORINGS["wide200_gotoh"],
    "blosum62x12_gotoh": ScoringParams(B62 * 12, gap_open=132, gap_extend=12),
}


def tile_pairs(rng, p, B, n, m):
    """B pairs for scoring p: DNA as ``pairs``; protein the query's head
    with ~30% substitutions as the target; the pad codes (A, A + 1) inside
    both sides."""
    if p.alphabet_size == 4:
        return pairs(rng, B, n, m)
    A = p.alphabet_size
    qs = rng.integers(0, A, (B, n)).astype(np.uint8)
    ts = rng.integers(0, A, (B, m)).astype(np.uint8)
    k = min(n, m)
    keep = rng.random((B, k)) >= 0.3
    ts[:, :k] = np.where(keep, qs[:, :k], ts[:, :k])
    qs[rng.random(qs.shape) < 0.05] = A
    ts[rng.random(ts.shape) < 0.05] = A + 1
    return qs, ts


@pytest.mark.parametrize("name", list(TILE_SCORINGS))
@pytest.mark.parametrize("n", [0, 15, 16, 17, 40])
def test_tile_mirror_equals_plain(name, n):
    p = port(TILE_SCORINGS[name])
    rng = np.random.default_rng(10000 + n)
    for m in (0, 1, 3, 4, 5, 17):
        qs, ts = tile_pairs(rng, p, 5, n, m)
        equal(general_tile_mirror(qs, ts, p, False), plain(qs, ts, p, False))
        want = plain(qs, ts, p, True)
        for select in (False, True):
            equal(general_tile_mirror(qs, ts, p, True, select), want)


def test_general_form():
    """Which form of the general kernel takes each scoring, and which
    tracker its tile form runs."""
    for p in TILE_SCORINGS.values():
        assert general_form(port(p)) == "tile", p
    for name in ("gap_minus1", "gotoh2_minus1"):
        assert general_form(port(SCORINGS[name])) == "sweep", name
    assert general_form(port(ScoringParams(dna_matrix(2, -3), gap_open=-1,
                                           gap_extend=2))) == "sweep"
    assert general_form(port(ScoringParams.linear(dna_matrix(200, -150), 5))) == "tile"
    assert general_form(port(ScoringParams(dna_matrix(200, -150), 30, 5))) == "tile"
    # the tile's key holds the +-200 matrix at 128 x 128; entries of
    # 2^20 leave no room for it (the select tracker)
    assert max_entry(port(SCORINGS["wide200_linear"])) == 200
    assert local_tracker(True, True, 128, 128, 0, 0, 5, 5, entry=200)[0] == END_KEY
    assert local_tracker(True, True, 128, 128, 0, 0, 5, 5, entry=2**20)[0] == END_SELECT
    assert local_tracker(True, False, 128, 128, 0, 0, 5, 5, entry=2**20)[0] == END_SCORE


def test_local_form():
    """Which kernel family takes each scoring on the card."""
    forms = [
        (ScoringParams.linear(dna_matrix(1, -1), 1), "rowscan"),
        (ScoringParams.linear(dna_matrix(10, -30), 15), "rowscan"),
        (ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15), "affine"),
        (ScoringParams(dna_matrix(2, -3), gap_open=4, gap_extend=4), "rowscan"),
        (ScoringParams.linear(np.asarray(BLOSUM62), 11), "profile"),
        (ScoringParams(np.asarray(BLOSUM62), gap_open=11, gap_extend=1), "profile"),
        (ScoringParams.linear(EDGE, 2), "profile"),
        (ScoringParams.linear(EDGE + np.eye(4, dtype=np.int64), 2), "general"),
        (ScoringParams.linear(np.where(np.eye(4, dtype=bool), 128, -1), 2), "rowscan"),
        (ScoringParams(np.asarray(BLOSUM62), gap_open=11, gap_extend=0), "general"),
        (ScoringParams.linear(np.asarray(BLOSUM62), 0), "general"),
        (ScoringParams(dna_matrix(2, -3), gap_open=0, gap_extend=1), "general"),
        (ScoringParams(dna_matrix(2, -3), gap_open=-2, gap_extend=-2), "general"),
    ] + [(p, "general") for p in SCORINGS.values()]
    for p, form in forms:
        assert local_form(port(p)) == form, (p, form)


def test_cpu_engines_run_the_plain_tier():
    """On the CPU best_engine / best_ends_engine and the general wrappers
    run the plain tier for every scoring, and count no launch."""
    qs, ts = pairs(np.random.default_rng(10001), 8, 20, 25)
    counts = (sw_general.sw_general.launches, sw_general.sw_general_ends.launches)
    for p in SCORINGS.values():
        pp = port(p)
        want_s, want_e = xla(qs, ts, p, False), xla(qs, ts, p, True)
        equal(best_engine(pp, "cpu")(qs, ts), want_s)
        equal(best_ends_engine(pp, "cpu")(qs, ts), want_e)
        equal(sw_general.sw_general(qs, ts, pp, "cpu"), want_s)
        equal(sw_general.sw_general_ends(qs, ts, pp, "cpu"), want_e)
    assert counts == (sw_general.sw_general.launches, sw_general.sw_general_ends.launches)
