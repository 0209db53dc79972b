"""CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: each test decides inside the ``card`` fixture whether a
card is present and skips with a reason when it is not, so every pytest
worker collects the same tests. This file imports no JAX, so it also runs
on a machine without it (the repo's conftest imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Integer outputs must be exactly equal (tolerance 0). The row-scan
kernels (``sw_batch``, ``sw_affine``) run uniform DNA scoring; they and
the profile kernel's thread form take the [B, L] codes as they are and
equal the CPU mirror of their skewed tile (``local_skew_mirror``) and the
plain version on the tile's odd shapes, in every instantiation (the
score, the packed key, the select tracker, the WIDE pad select); the
profile kernels (``sw_profile``) run BLOSUM62 and general 4x4 matrices,
internal pads included, in both forms (a thread per pair, a warp per
pair: stripes of 128 rows crossed, ragged n, config-3-like buckets with
padded targets, the ends against the oracle copy), and the wrapper picks
the form ``profile_form`` names on both sides of its pair threshold; the
bf16 kernel (``sw_bf16``) equals its plain version everywhere, drift above
the exact range included, odd batches included, and the int32 kernel
inside it and below the promotion split 255 * g; its launch takes the
[B, L] codes as they are. The varlen and promotion entry points on the card
equal themselves on the CPU. The semi-global kernels
(``semiglobal_batch``, ``semiglobal_profile``) equal their plain version
and the CPU mirror of their skewed tile, argmax and pinned (global),
with per-pair lengths down to 0, on the tile's odd shapes and on scores
too wide for the packed argmax key; the launch takes the [B, L] codes as
they are; and the alignment entry points on the card equal themselves on
the CPU. The
fixed-band kernel (``sw_banded_static``, ``sw_banded_profile``) equals
its plain version on ragged shapes, W from 0 past max(n, m) and around
its skewed tile's two schedules, pads (above 0 too) and lengths, and its
launch takes the [B, L] codes as they are; the per-round banded kernel (``banded_batch``) equals its plain
version in every field at W from 8 to 128, on raw uint8 and int16 codes
with per-pair lengths, one pair, and each history form, and the earlier
per-round kernel equals it; the banded alignment entry points on the card
equal themselves on the CPU. The block tier's
one-launch forward (``block_forward``) equals the plain loop in every
field, whole (histories, bases and deltas past each pair's end too), at
W from 16 to 128 with K up to 129 - W, linear, Gotoh, BLOSUM62 and
per-pair lengths; negative gap penalties run the per-block kernels
(``block_gather``, ``block_rows``) under the host loop, equal to it too
on the same W / K grid and scorings (linear, Gotoh, BLOSUM62, per-pair
lengths);
the device walkers (``block_walk``, ``xdrop_walk``: producer CTAs map the
moves, a follower CTA a pair follows them) write the plain versions' wires
at W from 16 to 128, on 1, 8 and 1024 pairs, with their default chunks and
forced small ones, and equal the earlier one-thread-a-pair kernels;
``banded --block-adaptive`` and reference-scale ``banded_align_batch`` on
the card equal themselves on the CPU. The
strip tile (``tile_strip_linear``, ``tile_strip_affine``: the pipelined
warp bands) equals the plain column-scan tile on every return at R from 1
to 16384 (br 1 to 16, ragged R), C from 1, non-zero and -2^20
boundaries, pads and an all-negative tile, and the one-block kernel
equals it; a tile of 1024 rows or more runs on more than one warp (CTA);
the long-pair entries, the wavefront kernel
(``sw_wavefront``) and the ``longpair`` / ``align --engine wavefront``
CLI on the card equal themselves on the CPU; the wavefront kernel equals
its plain version and its schedule's mirror
(``wavefront_stream_mirror``) with one and many pairs a stream, ragged
last streams, targets shorter than 4 and both tables (by column pairs for
DNA, by columns for protein). The mesh: a world of one under NCCL and two
gloo ranks sharing the card (``tests/_torch_mesh_worker.py``) give the
one-card entry points' scores, hits, ends and paths. The harnesses on the
card: ``run_fuzz`` with the kernels beside the plain tiers finds no
mismatch, ``run_selftest`` passes JAX's 23 checks, and a
``profile_trace`` sees the kernels. The benchmark suite at ``--quick``
emits JAX's TPU records, every parity field true.
"""

import numpy as np
import pytest
import torch

from swtpu_torch.batch import (
    banded_align_batch, banded_static_align_batch, nw_align_batch, promote,
    semiglobal_align_batch, sw_scores_varlen,
)
from swtpu_torch.core.encode import mutate, pack_2bit
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import (
    DNA_10_30_15, DNA_111, ScoringParams, dna_matrix,
)
from swtpu_torch.kernels import (
    banded_batch, banded_block, banded_scan, device_walk, longpair_strip,
    semiglobal_batch, semiglobal_profile, sw_affine, sw_banded, sw_batch, sw_bf16,
    sw_general, sw_profile, sw_wavefront,
)
from swtpu_torch.ops import best_ends_engine, best_engine
from swtpu_torch.kernels.banded_scan import BandedBatchResult, _prep_padded
from swtpu_torch.oracle import (
    nw_affine_full, nw_full, semiglobal_affine_full, semiglobal_full,
    sw_affine_traceback, sw_score_batch, sw_traceback,
)
from swtpu_torch.oracle.affine import sw_affine_score_batch
from swtpu_torch.parallel import longpair

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
        qs, ts, p, *sw_batch._uniform_match_mismatch(p), affine, ends,
    )
    for g, w in zip(tup(got), tup(PAIRS[name][0](qs, ts, p))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="contiguous uint8"):
        sw_batch.rowscan_launch_t(qs.t(), ts.t(), p, 10, -30, affine, ends)
    with pytest.raises(ValueError, match="batch mismatch"):
        sw_batch.rowscan_launch_t(qs, ts[:-1], p, 10, -30, affine, ends)


def test_guards_raise_on_card(card):
    q = torch.zeros((2, 8), dtype=torch.uint8, device=card)
    general = ScoringParams.linear(np.arange(16).reshape(4, 4) - 8, 2)
    for kern, _ in PAIRS.values():
        with pytest.raises(NotImplementedError):
            kern(q, q, general)
    # the general matrix runs on the profile kernels (all-A pairs: the
    # diagonal entry -8 never wins, so every score is 0)
    assert sw_profile.sw_profile(q, q, general).tolist() == [0, 0]
    assert [x.tolist() for x in sw_profile.sw_profile_ends(q, q, general)] == [
        [0, 0], [0, 0], [0, 0]]
    # entries past [-127, 127]: the profile wrappers keep their guard, and
    # the engines take the scoring on the general kernel, equal to the plain
    # tier (a 200 on the diagonal: every all-A pair scores 8 x 200)
    wide = ScoringParams.linear(np.where(np.eye(4, dtype=bool), 200, -1) - np.eye(
        4, k=1, dtype=np.int64), 2)
    for kern in (sw_profile.sw_profile, sw_profile.sw_profile_ends):
        with pytest.raises(NotImplementedError, match="general kernel"):
            kern(q, q, wide)
    before = (sw_general.sw_general.launches, sw_general.sw_general_ends.launches)
    got = best_engine(wide, card)(q, q)
    got_ends = best_ends_engine(wide, card)(q, q)
    assert (sw_general.sw_general.launches, sw_general.sw_general_ends.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, sw_general.sw_general_plain(q, q, wide, card))
    assert got.tolist() == [1600, 1600]
    for g, w in zip(got_ends, sw_general.sw_general_ends_plain(q, q, wide, card),
                    strict=True):
        assert torch.equal(g, w)


DNA_GENERAL = np.array(
    [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]
)
PROFILE_SCORINGS = {
    "blosum62_linear11": ScoringParams.linear(BLOSUM62, 11),
    "blosum62_gotoh11_1": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1),
    "blosum62_tie_rich": ScoringParams.linear(BLOSUM62, 1),
    "dna_general_linear2": ScoringParams.linear(DNA_GENERAL, 2),
    "dna_general_gotoh3_1": ScoringParams(DNA_GENERAL, gap_open=3, gap_extend=1),
}
PROFILE_PAIRS = {
    "sw_profile": (sw_profile.sw_profile, sw_profile.sw_profile_plain),
    "sw_profile_ends": (sw_profile.sw_profile_ends,
                        sw_profile.sw_profile_ends_plain),
}


def profile_codes(rng, B, L, A, device):
    hi = 20 if A == 24 else A
    return torch.from_numpy(rng.integers(0, hi, size=(B, L)).astype(np.uint8)).to(device)


@pytest.mark.parametrize("shape", ["1000x90x200_padtail", "4096x128x128",
                                   "33x7x1", "4x40x2560", "2048x64x96_internal"])
@pytest.mark.parametrize("scoring", list(PROFILE_SCORINGS))
def test_profile_kernels_equal_plain_on_card(card, scoring, shape):
    p = PROFILE_SCORINGS[scoring]
    A = p.alphabet_size
    B, n, m = (int(x) for x in shape.split("_")[0].split("x"))
    rng = np.random.default_rng(10000)
    qs, ts = profile_codes(rng, B, n, A, card), profile_codes(rng, B, m, A, card)
    if shape.endswith("padtail"):
        qs[:, 70:] = A
        ts[: B // 2, 180:] = A + 1
    if shape.endswith("internal"):  # pads inside both sides, and codes > 31
        qs[torch.from_numpy(rng.random(tuple(qs.shape)) < 0.05).to(card)] = A
        ts[torch.from_numpy(rng.random(tuple(ts.shape)) < 0.05).to(card)] = A + 1
        ts[:, 7] = 255
    for name, (kern, plain) in PROFILE_PAIRS.items():
        before = (kern.launches, kern.launches_affine)
        got = tup(kern(qs, ts, p))
        torch.cuda.synchronize()
        assert (kern.launches, kern.launches_affine) == (
            before[0] + 1, before[1] + (not p.is_linear))
        for g, w in zip(got, tup(plain(qs, ts, p))):
            assert g.device.type == "cuda" and g.dtype == torch.int32
            assert torch.equal(g, w), name


@pytest.mark.parametrize("scoring", ["10_30_15", "affine_10_30_40_15"])
def test_profile_equals_rowscan_on_uniform_scoring(card, scoring):
    p = SCORINGS[scoring]
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, 4096, 128, card), codes(rng, 4096, 128, card)
    rowscan = ((sw_batch.sw_batch, sw_batch.sw_batch_ends) if p.is_linear
               else (sw_affine.sw_affine, sw_affine.sw_affine_ends))
    for prof, row in zip(PROFILE_PAIRS.values(), rowscan):
        for g, w in zip(tup(prof[0](qs, ts, p)), tup(row(qs, ts, p))):
            assert torch.equal(g, w)


def test_profile_kernels_equal_oracle_on_card(card):
    rng = np.random.default_rng(10000)
    qh = rng.integers(0, 20, size=(32, 64)).astype(np.uint8)
    th = rng.integers(0, 20, size=(32, 80)).astype(np.uint8)
    qd, td = torch.from_numpy(qh).to(card), torch.from_numpy(th).to(card)
    for p, batch_oracle, walker in (
        (PROFILE_SCORINGS["blosum62_linear11"], sw_score_batch, sw_traceback),
        (PROFILE_SCORINGS["blosum62_gotoh11_1"], sw_affine_score_batch,
         sw_affine_traceback),
    ):
        want = batch_oracle(qh, th, p)
        assert np.array_equal(sw_profile.sw_profile(qd, td, p).cpu().numpy(), want)
        sc, ei, ej = (x.cpu().numpy() for x in sw_profile.sw_profile_ends(qd, td, p))
        for b in range(32):
            s0, path = walker(qh[b], th[b], p)
            assert s0 == sc[b] == want[b]
            assert (ei[b], ej[b]) == (path[-1] if s0 else (0, 0))


@pytest.mark.parametrize("scoring", ["blosum62_linear11", "blosum62_gotoh11_1"])
@pytest.mark.parametrize("name", list(PROFILE_PAIRS))
def test_profile_bare_launch_equals_wrapper_on_card(card, name, scoring):
    p = PROFILE_SCORINGS[scoring]
    rng = np.random.default_rng(10000)
    qs, ts = profile_codes(rng, 300, 50, 24, card), profile_codes(rng, 300, 70, 24, card)
    table = sw_profile.profile_table(p, card)
    ends = name.endswith("_ends")
    got = sw_profile.profile_launch_t(qs, ts, table, p, ends)
    for g, w in zip(tup(got), tup(PROFILE_PAIRS[name][0](qs, ts, p))):
        assert torch.equal(g, w)
    for g, w in zip(tup(got), tup(sw_profile.profile_warp_launch_t(qs, ts, table, p,
                                                                   ends))):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="contiguous uint8"):
        sw_profile.profile_warp_launch_t(qs.t(), ts, table, p, ends)
    with pytest.raises(ValueError, match="contiguous uint8"):
        sw_profile.profile_launch_t(qs.t(), ts.t(), table, p, ends)
    with pytest.raises(ValueError, match="int32 table"):
        sw_profile.profile_launch_t(qs, ts, table.to(torch.int64), p, ends)


# the local tile's odd shapes: n below, at and past a sweep of 16 rows, 129;
# m not a multiple of 4, below 16, 1
TILE_SHAPES = {"512x15x37": (512, 15, 37), "512x16x16": (512, 16, 16),
               "512x17x9": (512, 17, 9), "64x129x130": (64, 129, 130),
               "300x33x1": (300, 33, 1)}
ROWSCAN_WIDE = {
    "key_too_narrow": ScoringParams.linear(dna_matrix(10**7, -1), 1),
    "pad_cap_inexact": ScoringParams(dna_matrix(3, -(2**21)), gap_open=5, gap_extend=1),
}


def tile_pairs(rng, B, n, m, A, device):
    """Half related pairs with internal pads on both sides (A + 1 / A + 2
    for the alphabet of A letters, protein's 24 / 25) and a code of 255."""
    hi = 20 if A == 24 else A
    q = rng.integers(0, hi, (B, n)).astype(np.uint8)
    t = rng.integers(0, hi, (B, m)).astype(np.uint8)
    k = min(n, m)
    t[: B // 2, :k] = q[: B // 2, :k]
    q[rng.random(q.shape) < 0.03] = A
    t[rng.random(t.shape) < 0.03] = A + 1
    if m > 5:
        t[:, 5] = 255
    return q, t, torch.from_numpy(q).to(device), torch.from_numpy(t).to(device)


@pytest.mark.parametrize("shape", list(TILE_SHAPES))
@pytest.mark.parametrize("scoring", ["10_30_15", "tie_rich", "affine_10_30_40_15",
                                     "affine_tie_rich"] + list(ROWSCAN_WIDE))
def test_rowscan_kernel_equals_mirror_and_plain_on_card(card, scoring, shape):
    """Every instantiation the launch picks (score, key, select, WIDE) and
    the forced select tracker: equal to the plain version and, on the first
    16 pairs, to the CPU mirror of the skewed tile; the library's choice of
    form and its ROWS equal the mirror's."""
    p = SCORINGS.get(scoring) or ROWSCAN_WIDE[scoring]
    B, n, m = TILE_SHAPES[shape]
    qh, th, qs, ts = tile_pairs(np.random.default_rng(10000), B, n, m, 4, card)
    mm = sw_batch._uniform_match_mismatch(p)
    lib = sw_batch._rowscan_fn()[0]
    assert lib.swtpu_sw_rowscan_rows() == sw_batch.ROWS
    for affine in ((False, True) if p.is_linear else (True,)):
        for ends in (False, True):
            want = (sw_affine.sw_affine_ends_plain if ends else sw_affine.sw_affine_plain)(
                qs, ts, p)
            end, wide, _ = sw_batch.local_tracker(False, ends, n, m, *mm, p.gap_open,
                                                  p.gap_extend)
            assert lib.swtpu_sw_rowscan_form(int(ends), 0, n, m, *mm, p.gap_open,
                                             p.gap_extend) == 2 * end + wide
            mirror = tup(sw_batch.local_skew_mirror(qh[:16], th[:16], p, ends,
                                                    profile=False, affine=affine))
            for select in ((False, True) if ends else (False,)):
                got = tup(sw_batch.rowscan_launch_t(qs, ts, p, *mm, affine, ends,
                                                    select=select))
                torch.cuda.synchronize()
                for g, w, x in zip(got, tup(want), mirror):
                    assert torch.equal(g, w)
                    assert torch.equal(g[:16].cpu(), x)


@pytest.mark.parametrize("shape", list(TILE_SHAPES) + ["4x1200x3000"])
@pytest.mark.parametrize("scoring", ["blosum62_linear11", "blosum62_gotoh11_1",
                                     "dna_general_gotoh3_1"])
def test_profile_thread_form_equals_mirror_and_plain_on_card(card, scoring, shape):
    """The thread form's instantiations (score, key, select: the forced one,
    and at 1200 x 3000 the one the launch picks for scores too wide for the
    key) against the plain version and, on 16 pairs, the CPU mirror."""
    p = PROFILE_SCORINGS[scoring]
    B, n, m = TILE_SHAPES.get(shape) or (4, 1200, 3000)
    qh, th, qs, ts = tile_pairs(np.random.default_rng(10000), B, n, m, p.alphabet_size,
                                card)
    lib = sw_profile._profile_fn()[0]
    assert lib.swtpu_sw_profile_rows() == sw_batch.ROWS
    table = sw_profile.profile_table(p, card)
    for ends in (False, True):
        want = (sw_profile.sw_profile_ends_plain if ends else sw_profile.sw_profile_plain)(
            qs, ts, p)
        end, _, _ = sw_batch.local_tracker(True, ends, n, m, 0, 0, p.gap_open, p.gap_extend)
        assert lib.swtpu_sw_profile_form(int(ends), 0, n, m, p.gap_open,
                                         p.gap_extend) == end
        mirror = (tup(sw_profile.profile_skew_mirror(qh[:16], th[:16], p, ends))
                  if n * m <= 20000 else None)
        for select in ((False, True) if ends else (False,)):
            got = tup(sw_profile.profile_launch_t(qs, ts, table, p, ends, select=select))
            torch.cuda.synchronize()
            for k, (g, w) in enumerate(zip(got, tup(want))):
                assert torch.equal(g, w)
                if mirror is not None:
                    assert torch.equal(g[:16].cpu(), mirror[k])


WARP_SHAPES = {
    # stripes of 128 rows crossed, ragged n, one row, one column, long
    # targets; a config-3 bucket (120 x 800, targets padded past lengths)
    "64x300x320": (64, 300, 320), "40x129x33": (40, 129, 33), "33x127x1": (33, 127, 1),
    "16x1x500": (16, 1, 500), "8x257x64": (8, 257, 64), "4x40x2560": (4, 40, 2560),
    "2731x120x800_config3": (2731, 120, 800),
}


@pytest.mark.parametrize("shape", list(WARP_SHAPES))
@pytest.mark.parametrize("scoring", ["blosum62_linear11", "blosum62_gotoh11_1",
                                     "dna_general_gotoh3_1"])
def test_profile_warp_form_equals_plain_on_card(card, scoring, shape):
    """The warp form's four instantiations (launch alone) against the plain
    version, with tail and internal pads and a code past the table."""
    p = PROFILE_SCORINGS[scoring]
    A = p.alphabet_size
    B, n, m = WARP_SHAPES[shape]
    rng = np.random.default_rng(10000)
    qs, ts = profile_codes(rng, B, n, A, card), profile_codes(rng, B, m, A, card)
    if shape.endswith("config3"):
        ts[torch.arange(m, device=card)[None, :] >= torch.from_numpy(
            rng.integers(80, m + 1, B)).to(card)[:, None]] = A + 1
    else:
        qs[:, n - n // 4:] = A
        ts[torch.from_numpy(rng.random(tuple(ts.shape)) < 0.05).to(card)] = A + 1
        ts[:, 0] = 255
    k = min(n, m)
    qs[: B // 4, :k] = ts[: B // 4, :k]  # related pairs: endpoints inside
    table = sw_profile.profile_table(p, card)
    for ends, plain in ((False, sw_profile.sw_profile_plain),
                        (True, sw_profile.sw_profile_ends_plain)):
        got = tup(sw_profile.profile_warp_launch_t(qs, ts, table, p, ends))
        torch.cuda.synchronize()
        for g, w in zip(got, tup(plain(qs, ts, p)), strict=True):
            assert g.device.type == "cuda" and g.dtype == torch.int32
            assert torch.equal(g, w), (shape, ends)


@pytest.mark.parametrize("side", ["at", "past"])
@pytest.mark.parametrize("scoring", ["blosum62_linear11", "blosum62_gotoh11_1"])
def test_profile_wrapper_picks_the_form_by_shape_on_card(card, scoring, side):
    """Batches on both sides of profile_form's pair threshold: the wrapper
    launches the form the rule picks, counts it, and equals the plain
    version."""
    p = PROFILE_SCORINGS[scoring]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    B = sw_profile.WARP_PAIRS_PER_SM * sms + (side == "past")
    rng = np.random.default_rng(10000)
    qs, ts = profile_codes(rng, B, 24, 24, card), profile_codes(rng, B, 40, 24, card)
    form = sw_profile.profile_form(B, 24, 40, sms)
    assert form == ("warp" if side == "at" else "thread")
    for kern, plain in PROFILE_PAIRS.values():
        before = (kern.launches, kern.launches_warp)
        got = tup(kern(qs, ts, p))
        assert (kern.launches, kern.launches_warp) == (before[0] + 1,
                                                       before[1] + (form == "warp"))
        for g, w in zip(got, tup(plain(qs, ts, p)), strict=True):
            assert torch.equal(g, w)


def test_profile_warp_ends_equal_oracle_on_card(card):
    rng = np.random.default_rng(10000)
    qh = rng.integers(0, 20, size=(32, 150)).astype(np.uint8)
    th = rng.integers(0, 20, size=(32, 90)).astype(np.uint8)
    qh[:12, 20:110] = th[:12, :90]
    qd, td = torch.from_numpy(qh).to(card), torch.from_numpy(th).to(card)
    for p, walker in ((PROFILE_SCORINGS["blosum62_linear11"], sw_traceback),
                      (PROFILE_SCORINGS["blosum62_gotoh11_1"], sw_affine_traceback)):
        table = sw_profile.profile_table(p, card)
        sc, ei, ej = (x.cpu().numpy() for x in sw_profile.profile_warp_launch_t(
            qd, td, table, p, True))
        for b in range(32):
            s0, path = walker(qh[b], th[b], p)
            assert s0 == sc[b] and (ei[b], ej[b]) == (path[-1] if s0 else (0, 0))


P7 = ScoringParams.linear(dna_matrix(7, -1), 1)
BF16_CASES = {
    # (B, n, m, scoring, allow_overflow, related fraction)
    "4096x128x128_10_30_15": (4096, 128, 128, DNA_10_30_15, False, 0),
    "4096x128x128_111": (4096, 128, 128, DNA_111, False, 0),
    "1000x90x200_111": (1000, 90, 200, DNA_111, False, 0),
    "4x40x2560_10_30_15": (4, 40, 2560, DNA_10_30_15, False, 0),
    "33x7x1_111": (33, 7, 1, DNA_111, False, 0),
    "2048x300x320_111_overflow": (2048, 300, 320, DNA_111, True, 8),
    "2048x64x64_7_1_1_overflow": (2048, 64, 64, P7, True, 2),
    # g = 5: the promotion split sits at 255 * 5; an odd batch (the last
    # thread's pad pair), n below a sweep and not a multiple of 8
    "2047x300x320_10_30_15_overflow": (2047, 300, 320, DNA_10_30_15, True, 2),
    "1001x61x70_7_1_1_overflow": (1001, 61, 70, P7, True, 2),
    "5x7x40_10_30_15": (5, 7, 40, DNA_10_30_15, False, 0),
}


def bf16_inputs(rng, B, n, m, every):
    qh = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    th = rng.integers(0, 4, size=(B, m)).astype(np.uint8)
    for b in range(0, B, every) if every else ():
        th[b, :n] = mutate(rng, qh[b], 0.02, 0, 0, out_len=min(n, m))[:m]
    return qh, th


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_kernel_equals_plain_on_card(card, case):
    B, n, m, p, ov, every = BF16_CASES[case]
    rng = np.random.default_rng(10000)
    qh, th = bf16_inputs(rng, B, n, m, every)
    qs, ts = torch.from_numpy(qh).to(card), torch.from_numpy(th).to(card)
    before = sw_bf16.sw_bf16.launches
    got = sw_bf16.sw_bf16(qs, ts, p, allow_overflow=ov)
    torch.cuda.synchronize()
    assert sw_bf16.sw_bf16.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, sw_bf16.sw_bf16_plain(qs, ts, p, allow_overflow=ov))
    exact = sw_batch.sw_batch(qs, ts, p)
    if not ov:
        assert torch.equal(got, exact)
    else:  # below 255 * g exact, and the same pairs at or above it
        g = sw_bf16._guard_bf16(p, n, True)[3]
        low = (got < 255 * g) | (exact < 255 * g)
        assert torch.equal(got[low], exact[low])
        assert torch.equal(got >= 255 * g, exact >= 255 * g)
        assert bool((got >= 255 * g).any())


def test_bf16_pad_cases_on_card(card):
    """Equal codes match in the bf16 tier, pads included: an N in both
    sequences, and a target N against the query's pad rows (n = 30 pads
    to 32 with code 4)."""
    rng = np.random.default_rng(10000)
    q = rng.integers(0, 4, size=(16, 32)).astype(np.uint8)
    q[:, 10:14] = 4
    qs = torch.from_numpy(q).to(card)
    assert sw_bf16.sw_bf16(qs, qs.clone(), DNA_111).tolist() == [32] * 16
    q30 = rng.integers(0, 4, size=(3, 30)).astype(np.uint8)
    t32 = np.concatenate([q30, np.full((3, 2), 4, np.uint8)], axis=1)
    q30, t32 = torch.from_numpy(q30).to(card), torch.from_numpy(t32).to(card)
    assert sw_bf16.sw_bf16(q30, t32, DNA_111).tolist() == [32] * 3
    assert sw_bf16.sw_bf16_plain(q30, t32, DNA_111).tolist() == [32] * 3
    assert sw_batch.sw_batch(q30, t32, DNA_111).tolist() == [30] * 3


def test_bf16_bare_launch_equals_wrapper_on_card(card):
    """The launch takes the [B, n] / [B, m] codes as the caller holds
    them, an odd batch included, and refuses transposed or mismatched ones."""
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, 300, 50, card), codes(rng, 300, 70, card)
    got = sw_bf16.bf16_launch_t(qs, ts, DNA_10_30_15)
    assert torch.equal(got, sw_bf16.sw_bf16(qs, ts, DNA_10_30_15))
    assert torch.equal(got, sw_bf16.sw_bf16_plain(qs, ts, DNA_10_30_15))
    with pytest.raises(ValueError, match="contiguous uint8"):
        sw_bf16.bf16_launch_t(qs.t(), ts.t(), DNA_10_30_15)
    with pytest.raises(ValueError, match="batch mismatch"):
        sw_bf16.bf16_launch_t(qs[:299], ts, DNA_10_30_15)
    odd_q, odd_t = codes(rng, 33, 7, card), codes(rng, 33, 9, card)
    assert sw_bf16.bf16_launch_t(odd_q, odd_t, DNA_111).shape == (33,)
    assert torch.equal(sw_bf16.sw_bf16(odd_q, odd_t, DNA_111),
                       sw_batch.sw_batch(odd_q, odd_t, DNA_111))


def test_bf16_guards_raise_on_card(card):
    q85 = torch.zeros((2, 85), dtype=torch.uint8, device=card)
    three = ScoringParams.linear(dna_matrix(3, -1), 1)
    before = sw_bf16.sw_bf16.launches
    with pytest.raises(NotImplementedError, match="n\\*match/gcd"):
        sw_bf16.sw_bf16(q85, q85, three)
    for p in (AFF, ScoringParams.linear(dna_matrix(1, 0), 1)):
        with pytest.raises(NotImplementedError):
            sw_bf16.sw_bf16(q85, q85, p, allow_overflow=True)
    assert sw_bf16.sw_bf16.launches == before
    assert sw_bf16.sw_bf16(q85, q85, three, allow_overflow=True).tolist() == [255] * 2


@pytest.mark.parametrize("packed", [False, True])
def test_varlen_on_card_equals_cpu(card, packed):
    rng = np.random.default_rng(10000)
    B = 4096
    qs = rng.integers(0, 4, size=(B, 300)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(B, 320)).astype(np.uint8)
    lq, lt = rng.integers(100, 301, B), rng.integers(200, 321, B)
    if packed:
        qs, ts = pack_2bit(qs), pack_2bit(ts)
    before = sw_batch.sw_batch.launches
    got = sw_scores_varlen(qs, ts, DNA_111, lq, lt, packed=packed)
    assert sw_batch.sw_batch.launches == before + 1
    want = sw_scores_varlen(qs, ts, DNA_111, lq, lt, packed=packed, device="cpu")
    np.testing.assert_array_equal(got, want)
    for sc in (3, 4):  # in chunks: the same scores
        np.testing.assert_array_equal(
            sw_scores_varlen(qs, ts, DNA_111, lq, lt, packed=packed,
                             stream_chunks=sc), want)


@pytest.mark.parametrize("cap_frac", [0.25, 1 / 2048])
def test_promoted_device_on_card_equals_cpu(card, cap_frac):
    rng = np.random.default_rng(10000)
    qh, th = bf16_inputs(rng, 1024, 300, 320, 8)
    counts = (sw_bf16.sw_bf16.launches, sw_batch.sw_batch.launches)
    got = promote.sw_scores_promoted_device(qh, th, DNA_111, cap_frac=cap_frac)
    assert sw_bf16.sw_bf16.launches == counts[0] + 1
    assert sw_batch.sw_batch.launches >= counts[1] + 1
    want = promote.sw_scores_promoted(qh, th, DNA_111, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert 0 < got[1].mean() < 1
    np.testing.assert_array_equal(
        got[0][:8], sw_score_batch(qh[:8], th[:8], DNA_111))


SG_SCORINGS = {
    "111": dict(match=1, mismatch=1, gap=1),
    "tie_rich_211": dict(match=2, mismatch=1, gap=1),
    "affine_2351": dict(match=2, mismatch=3, gap_open=5, gap_extend=1),
    "go_eq_ge": dict(match=2, mismatch=3, gap_open=2, gap_extend=2),
    "blosum62_linear11": PROFILE_SCORINGS["blosum62_linear11"],
    "blosum62_gotoh11_1": PROFILE_SCORINGS["blosum62_gotoh11_1"],
    "dna_general_linear2": PROFILE_SCORINGS["dna_general_linear2"],
    "dna_general_gotoh3_1": PROFILE_SCORINGS["dna_general_gotoh3_1"],
}


def sg_call(scoring, plain, qs, ts, **kw):
    """The semi-global wrapper (or its plain version) for a scoring."""
    s = SG_SCORINGS[scoring]
    if isinstance(s, dict):
        fn = (semiglobal_batch.semiglobal_batch_plain if plain
              else semiglobal_batch.semiglobal_batch)
        return fn(qs, ts, **s, **kw)
    fn = (semiglobal_profile.semiglobal_profile_plain if plain
          else semiglobal_profile.semiglobal_profile)
    return fn(qs, ts, s, **kw)


def sg_codes(rng, scoring, B, n, m, device):
    """Half related pairs (the target is the query behind a 2-letter head
    with ~15% substitutions), half random, in the scoring's alphabet."""
    s = SG_SCORINGS[scoring]
    A = 4 if isinstance(s, dict) or s.alphabet_size == 4 else 20
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, A, size=(B, m)).astype(np.uint8)
    for b in range(B // 2):
        t = np.concatenate([rng.integers(0, A, 2), qs[b]]).astype(np.uint8)
        sub = rng.random(len(t)) < 0.15
        t[sub] = rng.integers(0, A, int(sub.sum()))
        ts[b, : min(m, len(t))] = t[:m]
    return torch.from_numpy(qs).to(device), torch.from_numpy(ts).to(device)


@pytest.mark.parametrize("shape", ["4096x128x128", "1000x90x200_varlen",
                                   "33x7x1", "4x40x2560", "64x0x9_varlen",
                                   "64x9x0"])
@pytest.mark.parametrize("scoring", list(SG_SCORINGS))
def test_semiglobal_kernels_equal_plain_on_card(card, scoring, shape):
    B, n, m = (int(x) for x in shape.split("_")[0].split("x"))
    rng = np.random.default_rng(10000)
    qs, ts = sg_codes(rng, scoring, B, n, m, card)
    lens = {}
    if shape.endswith("varlen"):
        lq, lt = rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)
        lq[:3], lt[:3] = (0, n, 0), (m, 0, 0)
        lens = dict(lens_q=lq, lens_t=lt)
    s = SG_SCORINGS[scoring]
    kern = (semiglobal_batch.semiglobal_batch if isinstance(s, dict)
            else semiglobal_profile.semiglobal_profile)
    for pin in (False, True):
        before = kern.launches
        got = sg_call(scoring, False, qs, ts, pin_end=pin, **lens)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for g, w in zip(got, sg_call(scoring, True, qs, ts, pin_end=pin, **lens)):
            assert g.device.type == "cuda" and g.dtype == torch.int32
            assert torch.equal(g, w), (scoring, shape, pin)


def test_semiglobal_kernels_equal_oracle_on_card(card):
    rng = np.random.default_rng(10000)
    for scoring, full, nw in (
        ("tie_rich_211", semiglobal_full, nw_full),
        ("affine_2351", semiglobal_affine_full, nw_affine_full),
        ("blosum62_gotoh11_1", semiglobal_affine_full, nw_affine_full),
    ):
        qd, td = sg_codes(rng, scoring, 32, 40, 48, card)
        qh, th = qd.cpu().numpy(), td.cpu().numpy()
        s = SG_SCORINGS[scoring]
        if isinstance(s, dict):
            kw = dict(match=s["match"], mismatch=s["mismatch"])
            kw.update(gap_open=s["gap_open"], gap_extend=s["gap_extend"]
                      ) if "gap_open" in s else kw.update(gap=s["gap"])
        else:
            kw = dict(matrix=s.matrix, gap_open=s.gap_open, gap_extend=s.gap_extend)
        for pin, walker in ((False, full), (True, nw)):
            sc, ei, ej = (x.cpu().numpy() for x in sg_call(
                scoring, False, qd, td, pin_end=pin))
            for b in range(32):
                s0, path = walker(qh[b], th[b], **kw)
                assert (s0, path[-1]) == (sc[b], (ei[b], ej[b])), (scoring, pin, b)


@pytest.mark.parametrize("scoring", ["affine_2351", "blosum62_linear11"])
def test_semiglobal_bare_launch_equals_wrapper_on_card(card, scoring):
    rng = np.random.default_rng(10000)
    qs, ts = sg_codes(rng, scoring, 300, 50, 70, card)
    lq = torch.from_numpy(rng.integers(0, 51, 300).astype(np.int32)).to(card)
    lt = torch.from_numpy(rng.integers(0, 71, 300).astype(np.int32)).to(card)
    s = SG_SCORINGS[scoring]
    if isinstance(s, dict):
        go, ge, affine = semiglobal_batch.gaps(**{k: v for k, v in s.items()
                                                  if k.startswith("gap")})
        args = (s["match"], -s["mismatch"], go, ge, affine)
        table = None
    else:
        args = (int(np.abs(s.matrix).max()), 0, s.gap_open, s.gap_extend,
                not s.is_linear)
        table = sw_profile.profile_table(s, card)
    for pin in (False, True):  # the launch takes the [B, L] codes as they are
        want = sg_call(scoring, False, qs, ts, pin_end=pin, lens_q=lq, lens_t=lt)
        for select in (False, True):  # the argmax's two trackers agree
            got = semiglobal_batch.semiglobal_launch_t(qs, ts, *args, pin, lq, lt,
                                                       table=table, select=select)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (pin, select)
    for q, t in ((qs.t(), ts.t()), (qs[:, ::2], ts), (qs, ts[:, 1:])):
        with pytest.raises(ValueError, match="contiguous uint8"):
            semiglobal_batch.semiglobal_launch_t(q, t, *args, False, table=table)
    with pytest.raises(ValueError, match="int32"):
        semiglobal_batch.semiglobal_launch_t(qs, ts, *args, False, lq.long(), lt,
                                             table=table)


# the skewed tile's odd shapes (tests/test_torch_semiglobal_skew.py): n
# below, at and past ROWS, ragged; m 0, 1, below ROWS, 3 mod GROUP
_R = semiglobal_batch.ROWS
SKEW_SHAPES = {
    "n_below_rows": (12, _R // 2 - 1, 2 * _R + 3),
    "n_ragged": (12, 2 * _R + 3, _R + 5),
    "m_zero": (6, _R + 1, 0),
    "m_one": (6, _R + 1, 1),
    "m_below_rows": (10, 2 * _R, _R - 3),
    "one_row_past_rows": (8, _R + 1, _R + 7),
    "one_row_one_col": (4, 1, 1),
    "ragged_wide": (300, 3 * _R + 5, 203),
}
# scores too wide for the argmax's packed key: the select tracker runs
WIDE_SCORINGS = {
    "wide_linear": dict(match=10**6, mismatch=1, gap=1),
    "wide_affine": dict(match=10**6, mismatch=3, gap_open=5, gap_extend=1),
}


def mirror_call(scoring, qs, ts, **kw):
    s = {**SG_SCORINGS, **WIDE_SCORINGS}[scoring]
    if isinstance(s, dict):
        return semiglobal_batch.semiglobal_skew_mirror(qs, ts, **s, **kw)
    return semiglobal_batch.semiglobal_skew_mirror(qs, ts, **kw, params=s)


@pytest.mark.parametrize("shape", list(SKEW_SHAPES))
@pytest.mark.parametrize("scoring", ["tie_rich_211", "affine_2351", "blosum62_linear11",
                                     "blosum62_gotoh11_1", "wide_linear", "wide_affine"])
def test_semiglobal_kernel_equals_mirror_and_plain_on_card(card, scoring, shape):
    """The kernel against the CPU mirror of its schedule and the plain tier
    on the card, argmax and pinned, with per-pair lengths down to 0 and
    without lengths."""
    B, n, m = SKEW_SHAPES[shape]
    rng = np.random.default_rng(10000)
    s = {**SG_SCORINGS, **WIDE_SCORINGS}[scoring]
    qs, ts = sg_codes(rng, "111" if scoring.startswith("wide") else scoring, B, n, m, card)
    lq, lt = rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)
    lq[:3], lt[:3] = (0, n, 0), (m, 0, 0)
    plain = (semiglobal_batch.semiglobal_batch_plain, semiglobal_batch.semiglobal_batch)
    for pin in (False, True):
        for lens in (dict(lens_q=lq, lens_t=lt), {}):
            if isinstance(s, dict):
                got = plain[1](qs, ts, **s, **lens, pin_end=pin)
                want = plain[0](qs, ts, **s, **lens, pin_end=pin)
            else:
                got = semiglobal_profile.semiglobal_profile(qs, ts, s, **lens, pin_end=pin)
                want = semiglobal_profile.semiglobal_profile_plain(qs, ts, s, **lens,
                                                                   pin_end=pin)
            mirror = mirror_call(scoring, qs.cpu(), ts.cpu(), **lens, pin_end=pin)
            for g, w, x in zip(got, want, mirror):
                assert torch.equal(g, w), (scoring, shape, pin, bool(lens))
                assert torch.equal(g.cpu(), x), (scoring, shape, pin, bool(lens))


def test_semiglobal_library_agrees_with_the_mirror_on_card(card):
    """The library's ROWS and its packed-key choice are the mirror's."""
    import ctypes

    lib, _ = semiglobal_batch._semiglobal_fn()
    assert lib.swtpu_sw_semiglobal_rows() == semiglobal_batch.ROWS
    fn = lib.swtpu_sw_semiglobal_key_bits
    fn.argtypes, fn.restype = [ctypes.c_int] * 6, ctypes.c_int
    for n, m in ((0, 0), (1, 1), (128, 128), (300, 2000), (16384, 16384)):
        for match, mismatch, go, ge in ((1, -1, 1, 1), (10, -30, 40, 15), (10**6, -1, 1, 1),
                                        (2, -3, 5, 1), (132, 0, 11, -1), (1, -1, -3, -3)):
            want = semiglobal_batch.key_bits(n, m, match, mismatch, go, ge)
            got = fn(n, m, match, mismatch, go, ge)
            assert got == (-1 if want is None else want), (n, m, match, go)


def test_semiglobal_guards_raise_on_card(card):
    """No longer raises: gaps of 0 or below and entries past +-127 run the
    kernels, equal to the plain tier (the boundary's cells in the
    argmax)."""
    rng = np.random.default_rng(10000)
    q = torch.from_numpy(rng.integers(0, 4, (40, 20)).astype(np.uint8)).to(card)
    t = torch.from_numpy(rng.integers(0, 4, (40, 30)).astype(np.uint8)).to(card)
    counts = (semiglobal_batch.semiglobal_batch.launches,
              semiglobal_profile.semiglobal_profile.launches)
    for kw in (dict(gap=0), dict(gap_open=3, gap_extend=0), dict(gap=-1)):
        for g, w in zip(semiglobal_batch.semiglobal_batch(q, t, **kw),
                        semiglobal_batch.semiglobal_batch_plain(q, t, **kw, device=card),
                        strict=True):
            assert torch.equal(g, w)
    for p in (ScoringParams.linear(dna_matrix(1, -1), 0),
              ScoringParams.linear(np.where(np.eye(4, dtype=bool), 200, -1), 2)):
        for g, w in zip(semiglobal_profile.semiglobal_profile(q, t, p),
                        semiglobal_profile.semiglobal_profile_plain(q, t, p, device=card),
                        strict=True):
            assert torch.equal(g, w)
    assert (counts[0] + 3, counts[1] + 2) == (
        semiglobal_batch.semiglobal_batch.launches,
        semiglobal_profile.semiglobal_profile.launches)


@pytest.mark.parametrize("scoring", ["tie_rich_211", "affine_2351",
                                     "blosum62_gotoh11_1"])
def test_semiglobal_align_on_card_equals_cpu(card, scoring):
    rng = np.random.default_rng(10000)
    qd, td = sg_codes(rng, scoring, 64, 60, 72, card)
    qh, th = qd.cpu().numpy(), td.cpu().numpy()
    lens = dict(lens_q=rng.integers(0, 61, 64), lens_t=rng.integers(0, 73, 64))
    s = SG_SCORINGS[scoring]
    kw = dict(s) if isinstance(s, dict) else dict(params=s)
    for fn in (semiglobal_align_batch, nw_align_batch):
        for extra in ({}, lens):
            got = fn(qh, th, **kw, **extra)
            assert got == fn(qh, th, **kw, **extra, device="cpu")


# -- fixed band (B8) and the per-round adaptive band (B11/B12) ----------

FIXED_SCORINGS = {
    "111": ScoringParams.linear(dna_matrix(1, -1), 1),
    "10_30_15": DNA_10_30_15,
    "affine_1_1_3_1": ScoringParams(dna_matrix(1, -1), 3, 1),
    "blosum62_linear11": ScoringParams.linear(BLOSUM62, 11),
    "blosum62_gotoh11_1": ScoringParams(BLOSUM62, 11, 1),
    "dna_general_gotoh3_1": ScoringParams(
        np.array([[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2],
                  [-2, -1, -2, 3]]), 3, 1),
}


def banded_codes(rng, A, B, n, m, device):
    """Half the pairs related (the target is the query, cut or filled to
    m, with 10% substitutions), half random."""
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, A, size=(B, m)).astype(np.uint8)
    k = min(n, m)
    ts[: B // 2, :k] = qs[: B // 2, :k]
    sub = rng.random((B // 2, k)) < 0.1
    ts[: B // 2, :k][sub] = rng.integers(0, A, int(sub.sum()))
    return torch.from_numpy(qs).to(device), torch.from_numpy(ts).to(device)


@pytest.mark.parametrize("shape", ["1000x90x200_lens", "2048x128x128", "33x7x1",
                                   "64x40x300", "64x300x40"])
@pytest.mark.parametrize("scoring", list(FIXED_SCORINGS))
def test_fixed_band_kernel_equals_plain_on_card(card, scoring, shape):
    B, n, m = (int(x) for x in shape.split("_")[0].split("x"))
    p = FIXED_SCORINGS[scoring]
    rng = np.random.default_rng(10000)
    qs, ts = banded_codes(rng, 4 if p.alphabet_size == 4 else 20, B, n, m, card)
    lens = {}
    if shape.endswith("lens"):
        lens = dict(lens_q=rng.integers(0, n + 1, B), lens_t=rng.integers(0, m + 1, B))
    uniform = sw_batch._uniform_match_mismatch(p) is not None
    kerns = [sw_banded.sw_banded_profile] + ([sw_banded.sw_banded_static] if uniform
                                             else [])
    for W in (0, 1, 8, 32, 100, 400):
        want = sw_banded.sw_banded_plain(qs, ts, p, W, **lens)
        for kern in kerns:
            before = kern.launches
            got = kern(qs, ts, p, W, **lens)
            torch.cuda.synchronize()
            assert kern.launches == before + 1
            assert got.device.type == "cuda" and got.dtype == torch.int32
            assert torch.equal(got, want), (kern.__name__, W)


@pytest.mark.parametrize("scoring", list(FIXED_SCORINGS))
def test_fixed_band_skewed_tile_edges_on_card(card, scoring):
    """Around the skewed tile's schedules (W = 14 / 15 / 16: masked groups
    below K = 30 offsets a sweep, the compile-time schedule from it), odd
    batches, n below a sweep and per-pair lengths; 2048-mers at W = 32."""
    p = FIXED_SCORINGS[scoring]
    A = 4 if p.alphabet_size == 4 else 20
    rng = np.random.default_rng(10000)
    uniform = sw_batch._uniform_match_mismatch(p) is not None
    kerns = [sw_banded.sw_banded_profile] + ([sw_banded.sw_banded_static] if uniform
                                             else [])
    for B, n, m, widths in ((257, 100, 90, (14, 15, 16)), (33, 13, 70, (14, 15, 16)),
                            (64, 2048, 2048, (32,))):
        qs, ts = banded_codes(rng, A, B, n, m, card)
        qs[:, 7], ts[:, 11] = A, A + 1  # pads at matrix.min()
        for W in widths:
            for lens in ({}, dict(lens_q=rng.integers(0, n + 1, B),
                                  lens_t=rng.integers(0, m + 1, B))):
                want = sw_banded.sw_banded_plain(qs, ts, p, W, **lens)
                for kern in kerns:
                    assert torch.equal(kern(qs, ts, p, W, **lens), want), (
                        kern.__name__, B, n, m, W, bool(lens))


def test_fixed_band_pads_above_zero_on_card(card):
    """A matrix whose smallest entry is positive: pads past a pair's length
    can win, so the kernel runs the full width with pads past the lengths."""
    p = ScoringParams(np.arange(16).reshape(4, 4) % 5 + 1, 2, 1)
    rng = np.random.default_rng(10000)
    qs, ts = banded_codes(rng, 4, 300, 70, 60, card)
    lens = dict(lens_q=rng.integers(0, 71, 300), lens_t=rng.integers(0, 61, 300))
    for W in (5, 32):
        for kw in ({}, lens):
            assert torch.equal(sw_banded.sw_banded_profile(qs, ts, p, W, **kw),
                               sw_banded.sw_banded_plain(qs, ts, p, W, **kw))


def test_fixed_band_pads_and_bare_launch_on_card(card):
    rng = np.random.default_rng(10000)
    p = FIXED_SCORINGS["affine_1_1_3_1"]
    qs, ts = banded_codes(rng, 4, 500, 60, 70, card)
    qs[:, 13], ts[:, 29] = 4, 5  # in-length pads score matrix.min()
    want = sw_banded.sw_banded_plain(qs, ts, p, 12)
    assert torch.equal(sw_banded.sw_banded_static(qs, ts, p, 12), want)
    assert torch.equal(sw_banded.banded_launch_t(qs, ts, p, 12), want)
    table = sw_banded.banded_table(p.matrix, card)
    assert torch.equal(sw_banded.banded_launch_t(qs, ts, p, 12, table), want)
    with pytest.raises(ValueError, match="contiguous uint8"):
        sw_banded.banded_launch_t(qs.t(), ts, p, 12)


def test_fixed_band_guards_raise_on_card(card):
    q = torch.zeros((2, 8), dtype=torch.uint8, device=card)
    before = (sw_banded.sw_banded_static.launches, sw_banded.sw_banded_profile.launches)
    for p in (ScoringParams.linear(dna_matrix(1, 1), 1),
              ScoringParams.linear(dna_matrix(1, -1), 0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sw_banded.sw_banded_static(q, q, p)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sw_banded.sw_banded_profile(q, q, ScoringParams(BLOSUM62, 11, 0))
    assert before == (sw_banded.sw_banded_static.launches,
                      sw_banded.sw_banded_profile.launches)


def xdrop_set(rng, A, B, n, device):
    """Related pairs (10% substitutions, a few indels), the last quarter
    random, with per-pair lengths."""
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = np.stack([mutate(rng, q, p_mismatch=0.1, p_insert=0.02, p_delete=0.02,
                          out_len=n) % A for q in qs])
    ts[-B // 4:] = rng.integers(0, A, size=(B // 4, n))
    lens = dict(lens_q=rng.integers(n // 2, n + 1, B), lens_t=rng.integers(n // 2, n + 1, B))
    return torch.from_numpy(qs).to(device), torch.from_numpy(ts).to(device), lens


XDROP_MODES = {
    "linear_varlen": dict(lens=True),
    "gotoh_compressed": dict(gap_open=3, gap_extend=1, compress_history=True),
    "blosum62_x120": dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120,
                          lens=True),
    "harsh_scores_only": dict(mismatch=3, gap=2, x_threshold=40, with_history=False),
}


def xdrop_fields(res):
    """The result's fields, the per-round ones (history, pos_y, offsets)
    zeroed at and past each pair's n_rounds: the kernel writes only below
    it."""
    out = [res.score, res.max_round, res.n_rounds]
    if res.pos_y is not None:
        live = (torch.arange(res.pos_y.shape[0], device=res.pos_y.device)[:, None]
                < res.n_rounds[None, :])
        out.append(torch.where(live[..., None], res.band_history, 0))
        out += [torch.where(live, x, 0) for x in (res.pos_y, res.offsets)
                if x is not None]
    return out


@pytest.mark.parametrize("W", [8, 32, 40, 64, 96, 128])
@pytest.mark.parametrize("mode", list(XDROP_MODES))
def test_xdrop_kernel_equals_plain_on_card(card, mode, W):
    kw = dict(XDROP_MODES[mode])
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 20 if "matrix" in kw else 4, 64, 260, card)
    if kw.pop("lens", False):
        kw.update(lens)
    kern = banded_batch.banded_batch
    before = (kern.launches, kern.launches_w32_w64)
    got = kern(qs, ts, bandwidth=W, **kw)
    torch.cuda.synchronize()
    assert (kern.launches, kern.launches_w32_w64) == (
        before[0] + 1, before[1] + (W in (32, 64)))
    want = banded_batch.banded_batch_plain(qs, ts, bandwidth=W, device=card, **kw)
    got_f, want_f = xdrop_fields(got), xdrop_fields(want)
    assert len(got_f) == len(want_f)
    for g, w in zip(got_f, want_f):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w), (mode, W)


def test_xdrop_guards_and_bare_launch_on_card(card):
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 4, 40, 100, card)
    kern = banded_batch.banded_batch
    before = (kern.launches, kern.launches_wide)
    # past the wide kernel's cap the wrapper raises, naming the ROADMAP item
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        banded_batch.banded_batch(qs, ts, bandwidth=banded_batch.MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="254"):
        banded_batch.banded_batch(qs, ts, compress_history=True, x_threshold=300)
    assert (kern.launches, kern.launches_wide) == before
    staged = banded_batch.stage(qs, ts, lens["lens_q"], lens["lens_t"], card)
    out = banded_batch.xdrop_launch_t(*staged, 32, 70, 1, 1, 1)
    want = banded_batch.banded_batch(qs, ts, bandwidth=32, **lens)
    assert out[5] is None
    got_f = xdrop_fields(BandedBatchResult(*out[:5]))
    for g, w in zip(got_f, xdrop_fields(want), strict=True):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="uint8"):
        banded_batch.xdrop_launch_t(staged[0].int(), *staged[1:], 32, 70, 1, 1, 1)
    with pytest.raises(ValueError, match="int32"):
        banded_batch.xdrop_launch_t(*staged[:2], staged[2].long(), staged[3], 32, 70, 1,
                                    1, 1)


@pytest.mark.parametrize("hist", ["off", "int32", "8-bit"])
@pytest.mark.parametrize("W", [8, 32, 40, 64, 96, 128])
def test_xdrop_raw_codes_one_pair_and_history_forms_on_card(card, W, hist):
    """Raw codes as given (uint8 and int16, per-pair lengths, no padded
    rows) on 64 pairs and on one pair, each history form, Gotoh and linear:
    every field equals the plain version."""
    rng = np.random.default_rng(10001)
    qs, ts, lens = xdrop_set(rng, 4, 64, 200, card)
    kw = dict(with_history=hist != "off", compress_history=hist == "8-bit")
    for extra in (dict(), dict(gap_open=3, gap_extend=1)):
        for q, t, lq, lt in ((qs, ts.to(torch.int16), lens["lens_q"], lens["lens_t"]),
                             (qs[:1], ts[:1], lens["lens_q"][:1], lens["lens_t"][:1]),
                             (qs[5:6].to(torch.int16), ts[5:6], None, None)):
            got = banded_batch.banded_batch(q, t, lq, lt, bandwidth=W, x_threshold=50,
                                            **kw, **extra)
            want = banded_batch.banded_batch_plain(q, t, lq, lt, bandwidth=W,
                                                   x_threshold=50, device=card, **kw,
                                                   **extra)
            for g, w in zip(xdrop_fields(got), xdrop_fields(want), strict=True):
                assert torch.equal(g, w), (W, hist, extra, q.shape[0])


@pytest.mark.parametrize("W", [32, 96, 128])
def test_earlier_xdrop_kernel_equals_the_kernel_on_card(card, W):
    """The earlier per-round kernel (padded rows), off every entry point,
    writes what the kernel writes below n_rounds."""
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 20, 64, 260, card)
    kw = dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120)
    want = banded_batch.banded_batch(qs, ts, bandwidth=W, **lens, **kw)
    qp, tp, lq, lt = _prep_padded(qs, ts, lens["lens_q"], lens["lens_t"], W, card,
                                  torch.int16)
    out = banded_batch._earlier_launch_t(
        qp, tp, lq.int(), lt.int(), W, 120, 1, 1, 1, 11, 1,
        sw_banded.banded_table(BLOSUM62, card))
    for g, w in zip(xdrop_fields(BandedBatchResult(*out[:5])), xdrop_fields(want),
                    strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("scoring", ["affine_1_1_3_1", "blosum62_gotoh11_1"])
def test_banded_align_on_card_equals_cpu(card, scoring):
    p = FIXED_SCORINGS[scoring]
    rng = np.random.default_rng(10000)
    A = 4 if p.alphabet_size == 4 else 20
    qd, td = banded_codes(rng, A, 32, 60, 64, card)
    qh, th = qd.cpu().numpy(), td.cpu().numpy()
    assert banded_static_align_batch(qh, th, p, 12) == banded_static_align_batch(
        qh, th, p, 12, device="cpu")
    qd, td, lens = xdrop_set(rng, A, 32, 150, card)
    qh, th = qd.cpu().numpy(), td.cpu().numpy()
    kw = dict(gap_open=p.gap_open, gap_extend=p.gap_extend, x_threshold=60, **lens)
    if A == 20:
        kw["matrix"] = p.matrix
    for W in (32, 96):
        assert banded_align_batch(qh, th, bandwidth=W, **kw) == banded_align_batch(
            qh, th, bandwidth=W, device="cpu", **kw)


@pytest.mark.parametrize("W", [129, 160, 255, 256, 257, 384, 512, 1000, 1024])
@pytest.mark.parametrize("mode", list(XDROP_MODES))
def test_xdrop_wide_kernel_equals_plain_on_card(card, mode, W):
    """Bands past 128 take the wide kernel (a CTA a pair, a warp each 128
    cells): every field equals the plain version, one launch counted
    apart, at one to eight warps, W a multiple of 128 and not."""
    kw = dict(XDROP_MODES[mode])
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 20 if "matrix" in kw else 4, 32, 300, card)
    if kw.pop("lens", False):
        kw.update(lens)
    kern = banded_batch.banded_batch
    warp = banded_batch.banded_form(W) == "wide_warp"
    before = (kern.launches, kern.launches_w32_w64, kern.launches_wide,
              kern.launches_wide_warp)
    got = kern(qs, ts, bandwidth=W, **kw)
    torch.cuda.synchronize()
    assert (kern.launches, kern.launches_w32_w64, kern.launches_wide,
            kern.launches_wide_warp) == (before[0], before[1], before[2] + 1,
                                         before[3] + warp)
    want = banded_batch.banded_batch_plain(qs, ts, bandwidth=W, device=card, **kw)
    for g, w in zip(xdrop_fields(got), xdrop_fields(want), strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w), (mode, W)
    # the CTA launch alone at every W, and the one-warp form alone to 256
    matrix = kw.get("matrix")
    args = (*banded_batch.stage(qs, ts, kw.get("lens_q"), kw.get("lens_t"), card), W,
            kw.get("x_threshold", 70), kw.get("match", 1), kw.get("mismatch", 1),
            kw.get("gap", 1), kw.get("gap_open"), kw.get("gap_extend"),
            None if matrix is None else sw_banded.banded_table(matrix, card),
            kw.get("with_history", True), kw.get("compress_history", False))
    launches = [banded_batch.xdrop_wide_launch_t]
    if warp:
        launches.append(banded_batch.xdrop_wide_warp_launch_t)
    for launch in launches:
        out = BandedBatchResult(*launch(*args))
        for g, w in zip(xdrop_fields(out), xdrop_fields(want), strict=True):
            assert torch.equal(g, w), (mode, W, launch.__name__)


@pytest.mark.parametrize("W", [1, 8, 32, 40, 96, 128])
def test_xdrop_wide_launch_equals_warp_kernel_on_card(card, W):
    """The wide kernel's launch takes every W from 1, and writes what the
    warp kernel writes below n_rounds (linear, Gotoh 8-bit, BLOSUM62)."""
    rng = np.random.default_rng(10001)
    for A, kw in ((4, dict()), (4, dict(gap_open=3, gap_extend=1, compress_history=True)),
                  (20, dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120))):
        qs, ts, lens = xdrop_set(rng, A, 32, 200, card)
        want = banded_batch.banded_batch(qs, ts, bandwidth=W, **lens, **kw)
        table = sw_banded.banded_table(BLOSUM62, card) if "matrix" in kw else None
        out = banded_batch.xdrop_wide_launch_t(
            *banded_batch.stage(qs, ts, lens["lens_q"], lens["lens_t"], card), W,
            kw.get("x_threshold", 70), 1, 1, 1, kw.get("gap_open"), kw.get("gap_extend"),
            table, True, kw.get("compress_history", False))
        for g, w in zip(xdrop_fields(BandedBatchResult(*out)), xdrop_fields(want),
                        strict=True):
            assert torch.equal(g, w), (W, kw)


@pytest.mark.parametrize("W", [160, 256, 1024])
def test_xdrop_walk_wide_bands_on_card(card, W):
    """The per-round device walk over the wide kernel's history: its ring of
    chunks sized by W (default_chunk), and chunks of 2 rounds, write the
    plain version's wire."""
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 4, 8, 400, card)
    lens["lens_q"][0] = 0
    res = banded_batch.banded_batch(qs, ts, bandwidth=W, compress_history=False, **lens)
    pad = _prep_padded(qs, ts, lens["lens_q"], lens["lens_t"], W, card, torch.int16)
    want = device_walk.xdrop_walk_plain(res, pad, W)
    assert torch.equal(device_walk.xdrop_walk(res, pad, W).cpu(), want)
    pad32 = (*pad[:2], pad[2].int(), pad[3].int())
    small = device_walk.xdrop_walk_launch_t(res, pad32, W, 70, 1, 1, 1, _chunk=2)
    assert torch.equal(small.cpu(), want)


def test_banded_align_wide_on_card_equals_cpu(card):
    """W = 160 through the entry points: Gotoh and BLOSUM62 on the host walk,
    linear at reference scale (n + m + 1 > 6000) on the device walk, and the
    banded CLI with --traceback --cigar."""
    import contextlib
    import io

    from swtpu_torch.cli import main

    rng = np.random.default_rng(10000)
    for A, kw in ((4, dict(gap_open=3, gap_extend=1)),
                  (20, dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120))):
        qd, td, lens = xdrop_set(rng, A, 16, 300, card)
        qh, th = qd.cpu().numpy(), td.cpu().numpy()
        assert banded_align_batch(qh, th, bandwidth=160, **lens, **kw) == \
            banded_align_batch(qh, th, bandwidth=160, device="cpu", **lens, **kw)
    qs = rng.integers(0, 4, size=(2, 3200)).astype(np.uint8)
    ts = np.stack([mutate(rng, q, out_len=3200) for q in qs])
    before = (device_walk.xdrop_walk.launches, banded_batch.banded_batch.launches_wide)
    got = banded_align_batch(qs, ts, bandwidth=256)
    assert (device_walk.xdrop_walk.launches,
            banded_batch.banded_batch.launches_wide) == (before[0] + 1, before[1] + 1)
    assert got == banded_align_batch(qs, ts, bandwidth=256, device="cpu")

    def run(device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["banded", "--random", "8x300x300", "--bandwidth", "160", "--traceback",
                  "--cigar", "--device", device])
        return buf.getvalue()

    on_card = run("cuda")
    assert on_card == run("cpu") and len(on_card.splitlines()) == 8


GENERAL_SCORINGS = {
    "gap0": ScoringParams.linear(dna_matrix(1, -1), 0),
    "gap_minus1": ScoringParams.linear(dna_matrix(2, -3), -1),
    "gotoh3_0": ScoringParams(dna_matrix(2, -3), 3, 0),
    "gotoh2_minus1": ScoringParams(dna_matrix(2, -3), 2, -1),
    "dna200_linear": ScoringParams.linear(dna_matrix(200, -150), 5),
    "dna200_gotoh": ScoringParams(dna_matrix(200, -150), 30, 5),
    "g4x60_gotoh": ScoringParams(np.array([[3, -2, -1, -2], [-2, 3, -2, -1],
                                           [-1, -2, 3, -2], [-2, -1, -2, 3]]) * 60, 100, 20),
    "blosum62_gap0": ScoringParams(BLOSUM62, 0, 0),
    "gotoh0_2": ScoringParams(dna_matrix(2, -3), 0, 2),
    "blosum62x12_gotoh": ScoringParams(np.asarray(BLOSUM62) * 12, 132, 12),
}


@pytest.mark.parametrize("shape", ["4096x128x128", "1000x90x200_pads", "33x7x1",
                                   "64x300x40", "8x0x5", "16x16x0"])
@pytest.mark.parametrize("scoring", list(GENERAL_SCORINGS))
def test_general_kernel_equals_plain_on_card(card, scoring, shape):
    """The general local kernel, scores and endpoints, every instantiation:
    equal to the plain tier on strips crossed (n = 90, 128, 300), n below a
    strip, empty queries and targets, pads inside."""
    p = GENERAL_SCORINGS[scoring]
    B, n, m = (int(x) for x in shape.split("_")[0].split("x"))
    rng = np.random.default_rng(10000)
    A = p.alphabet_size
    qs = torch.from_numpy(rng.integers(0, A, (B, n)).astype(np.uint8)).to(card)
    ts = torch.from_numpy(rng.integers(0, A, (B, m)).astype(np.uint8)).to(card)
    if shape.endswith("_pads"):
        qs[:, 70:] = A
        ts[:, ::17] = A + 1
    tile = sw_general.general_form(p) == "tile"
    table = sw_profile.profile_table(p, card)
    for ends, kern, plain in ((False, sw_general.sw_general, sw_general.sw_general_plain),
                              (True, sw_general.sw_general_ends,
                               sw_general.sw_general_ends_plain)):
        before = (kern.launches, kern.launches_affine, kern.launches_tile)
        got = kern(qs, ts, p)
        assert (kern.launches, kern.launches_affine, kern.launches_tile) == (
            before[0] + 1, before[1] + (not p.is_linear), before[2] + tile)
        want = tup(plain(qs, ts, p, card))
        for g, w in zip(tup(got), want, strict=True):
            assert g.device.type == "cuda" and torch.equal(g, w), (scoring, shape, ends)
        # each form launched alone: the sweep under every scoring, the tile
        # where no gap penalty is negative, with the packed key and the
        # select tracker
        launches = [sw_general.general_sweep_launch_t(qs, ts, table, p, ends)]
        if tile:
            launches += [sw_general.general_tile_launch_t(qs, ts, table, p, ends, select)
                         for select in (False, True)]
        for out in launches:
            for g, w in zip(tup(out), want, strict=True):
                assert torch.equal(g, w), (scoring, shape, ends)


@pytest.mark.parametrize("shape", [(128, 128), (40, 17), (300, 1200), (17, 3)])
def test_general_tile_tracker_equals_mirror_copy(card, shape):
    """The tile form's library picks the tracker its mirrors' copy picks
    (the packed key where key_bits holds the matrix's own range)."""
    lib, _ = sw_general._general_fn("swtpu_sw_general_tile")
    n, m = shape
    for p in GENERAL_SCORINGS.values():
        if sw_general.general_form(p) != "tile":
            continue
        mag = sw_general.max_entry(p)
        for ends, select in ((False, False), (True, False), (True, True)):
            end, _, _ = sw_batch.local_tracker(True, ends, n, m, 0, 0, p.gap_open,
                                               p.gap_extend, select, entry=mag)
            assert lib.swtpu_sw_general_tile_form(int(ends), int(select), n, m, mag,
                                                  p.gap_open, p.gap_extend) == end


def test_general_calls_leave_rows_1_to_6_alone_on_card(card):
    """A call that local_form sends to the general kernel launches it
    alone, in either form: the row-scan and profile kernels' counts (rows
    1-6) do not move."""
    from swtpu_torch.ops.variants import local_form

    rng = np.random.default_rng(10003)
    qs, ts = codes(rng, 256, 64, card), codes(rng, 256, 80, card)
    rows = (sw_batch.sw_batch, sw_batch.sw_batch_ends, sw_affine.sw_affine,
            sw_affine.sw_affine_ends, sw_profile.sw_profile, sw_profile.sw_profile_ends)
    before = [w.launches for w in rows]
    general = (sw_general.sw_general.launches, sw_general.sw_general_ends.launches)
    scorings = [p for p in GENERAL_SCORINGS.values() if local_form(p) == "general"]
    assert {sw_general.general_form(p) for p in scorings} == {"tile", "sweep"}
    for p in scorings:
        best_engine(p, card)(qs, ts)
        best_ends_engine(p, card)(qs, ts)
    torch.cuda.synchronize()
    assert [w.launches for w in rows] == before
    assert (sw_general.sw_general.launches, sw_general.sw_general_ends.launches) == (
        general[0] + len(scorings), general[1] + len(scorings))


def test_engines_take_every_local_scoring_on_card(card):
    """best_engine / best_ends_engine on the card no longer refuse: a gap of 0
    or below, Gotoh with gap_extend <= 0 and entries past [-127, 127] run the
    general kernel, equal to the plain tier; the scorings the row-scan and
    profile kernels take stay on them."""
    from swtpu_torch.ops.variants import local_form

    rng = np.random.default_rng(10002)
    qs = codes(rng, 512, 64, card)
    ts = codes(rng, 512, 80, card)
    for p in [p for p in GENERAL_SCORINGS.values() if p.alphabet_size == 4]:
        before = (sw_general.sw_general.launches, sw_general.sw_general_ends.launches)
        got, got_ends = best_engine(p, card)(qs, ts), best_ends_engine(p, card)(qs, ts)
        assert (sw_general.sw_general.launches, sw_general.sw_general_ends.launches) == (
            before[0] + 1, before[1] + 1) or local_form(p) != "general"
        assert torch.equal(got, sw_general.sw_general_plain(qs, ts, p, card))
        for g, w in zip(got_ends, sw_general.sw_general_ends_plain(qs, ts, p, card),
                        strict=True):
            assert torch.equal(g, w)
    for p, kern in ((DNA_10_30_15, sw_batch.sw_batch), (AFF, sw_affine.sw_affine),
                    (ScoringParams(BLOSUM62, 11, 1), sw_profile.sw_profile)):
        before = (kern.launches, sw_general.sw_general.launches)
        best_engine(p, card)(qs, ts)
        assert (kern.launches, sw_general.sw_general.launches) == (before[0] + 1,
                                                                    before[1])


@pytest.mark.parametrize("argv", [
    ["--random", "32x128x128", "--gap", "0", "--traceback", "--cigar"],
    ["--random", "16x100x120", "--scoring", "2,-3", "--gap-open", "3", "--gap-extend", "0",
     "--traceback"],
])
def test_align_traceback_general_scoring_on_card_equals_cpu(card, argv):
    import contextlib
    import io

    from swtpu_torch.cli import main

    def run(device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["align"] + argv + ["--device", device])
        return buf.getvalue()

    before = sw_general.sw_general_ends.launches
    on_card = run("cuda")
    assert sw_general.sw_general_ends.launches > before
    assert on_card == run("cpu") and len(on_card.splitlines()) == int(argv[1].split("x")[0])


BLOCK_MODES = {
    "linear": dict(),
    "gotoh_31": dict(gap_open=3, gap_extend=1),
    "blosum62": dict(matrix=BLOSUM62, x_threshold=60),
    "varlen_x30": dict(lens=True, x_threshold=30),
}


def block_fields(res):
    """Every field of a block-tier result, whole."""
    return [res.score, res.end_y, res.end_j, res.n_rows, res.band_history, res.bases,
            res.deltas]


def block_launches():
    return (banded_block.block_forward.launches, banded_block.block_rows.launches,
            banded_block.block_gather.launches)


@pytest.mark.parametrize("W,K", [(16, 1), (16, 113), (32, 16), (48, 33), (64, 32),
                                 (64, 65), (80, 49), (96, 8), (112, 17), (128, 1)])
@pytest.mark.parametrize("mode", list(BLOCK_MODES))
def test_block_kernels_equal_plain_on_card(card, mode, W, K):
    kw = dict(BLOCK_MODES[mode], width=W, block=K, with_history=True, with_meta=True)
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 20 if "matrix" in kw else 4, 200, 230, card)
    if kw.pop("lens", False):
        kw.update(lens)
        kw["lens_q"][:3] = (0, K, K + 1)  # a zero length, a block end, past it
    before = block_launches()
    got = banded_block.banded_block_batch(qs, ts, **kw)
    torch.cuda.synchronize()
    # one launch a forward, no B10 and no per-block B9
    assert block_launches() == (before[0] + 1, before[1], before[2])
    want = banded_block.banded_block_batch_plain(qs, ts, device=card, **kw)
    names = ("score", "end_y", "end_j", "n_rows", "history", "bases", "deltas")
    for name, g, w in zip(names, block_fields(got), block_fields(want), strict=True):
        assert g.device.type == "cuda" and torch.equal(g, w), (mode, W, K, name)


NEG_BLOCK_MODES = {
    "linear_-1": dict(gap=-1, x_threshold=20),
    "linear_-2_x30": dict(gap=-2, x_threshold=30),
    "gotoh_2_-1": dict(gap_open=2, gap_extend=-1, x_threshold=20),
    "blosum62_-1": dict(matrix=BLOSUM62, gap=-1, x_threshold=60),
    "varlen_-1_x30": dict(lens=True, gap=-1, x_threshold=30),
}


@pytest.mark.parametrize("W,K", [(16, 1), (16, 113), (32, 16), (48, 33), (64, 32),
                                 (64, 65), (80, 49), (96, 8), (112, 17), (128, 1)])
@pytest.mark.parametrize("mode", list(NEG_BLOCK_MODES))
def test_block_negative_gaps_take_the_per_block_kernels_on_card(card, mode, W, K):
    """Negative gap penalties run B10 and the per-block B9 under the host
    loop: every register width (WR 16-64) and the shared-memory form (W =
    80-128), linear, Gotoh, BLOSUM62 and per-pair lengths, histories on
    and off, equal to the plain loop in every field."""
    kw = dict(NEG_BLOCK_MODES[mode], width=W, block=K, with_meta=True,
              with_history=(W, K) != (64, 32))
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 20 if "matrix" in kw else 4, 160, 170, card)
    if kw.pop("lens", False):
        kw.update(lens)
        kw["lens_q"][:3] = (0, K, K + 1)  # a zero length, a block end, past it
    before = block_launches()
    got = banded_block.banded_block_batch(qs, ts, **kw)
    runs = [a - b for a, b in zip(block_launches(), before)]
    assert runs[0] == 0 and runs[1] == runs[2] > 0
    want = banded_block.banded_block_batch_plain(qs, ts, device=card, **kw)
    names = ("score", "end_y", "end_j", "n_rows", "history", "bases", "deltas")
    for name, g, w in zip(names, block_fields(got), block_fields(want), strict=True):
        if g is None:
            assert w is None and not kw["with_history"], name
            continue
        assert g.device.type == "cuda" and torch.equal(g, w), (mode, W, K, name)


def test_block_forward_early_stop_on_card(card):
    """Most pairs die in their first blocks, a few live to the end: the
    blocks after each pair's end hold what the host loop's poll leaves."""
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(300, 400)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(300, 400)).astype(np.uint8)
    ts[:5] = np.stack([mutate(rng, q, out_len=400) for q in qs[:5]])
    for early in (True, False):
        runs = [banded_block._setup(qs, ts, 1, 3, 2, 32, 16, 10, None, None, True,
                                    None, None, None, None, dev)
                for dev in (card, card)]
        banded_block.block_forward(runs[0], early_exit=early)
        banded_block._forward(runs[1], early_exit=early, plain=True)
        for f in ("state", "n_rows", "bases", "deltas", "hist", "carried"):
            assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), (early, f)
    assert int((runs[0].n_rows < 400).sum()) >= 250


def test_block_gather_equals_plain_on_card(card):
    rng = np.random.default_rng(10000)
    t = torch.from_numpy(rng.integers(-1, 20, size=(300, 500)).astype(np.int16)).to(card)
    bases = torch.from_numpy(rng.integers(-200, 700, 300).astype(np.int32)).to(card)
    for C in (1, 47, 127):
        assert torch.equal(banded_block.block_gather(t, bases, C),
                           banded_block.block_gather_plain(t, bases, C))


def test_block_guards_on_card(card):
    q = torch.zeros((4, 40), dtype=torch.uint8, device=card)
    before = block_launches()
    for kw, err in ((dict(width=40), ValueError), (dict(width=64, block=66), ValueError),
                    (dict(gap_open=3, gap_extend=1, lens_q=[3] * 4), NotImplementedError)):
        with pytest.raises(err):
            banded_block.banded_block_batch(q, q, **kw)
    assert block_launches() == before


WALK_PAIRS = {1: 300, 8: 300, 1024: 64}  # pairs: their length


@pytest.mark.parametrize("B", list(WALK_PAIRS))
@pytest.mark.parametrize("W,K", [(16, 16), (32, 16), (64, 32), (128, 1)])
@pytest.mark.parametrize("mode", ["linear", "blosum62", "varlen_x30"])
def test_block_walk_equals_plain_on_card(card, mode, W, K, B):
    """The map kernel (its default chunk, and chunks of 3 rows; its default
    pairs a producer CTA, one and GROUP) writes the plain version's wire:
    one launch a walk, on the card."""
    kw = dict(BLOCK_MODES[mode])
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 20 if "matrix" in kw else 4, max(B, 4), WALK_PAIRS[B], card)
    qs, ts = qs[:B], ts[:B]
    if kw.pop("lens", False):
        kw.update({k: v[:B] for k, v in lens.items()})
        kw["lens_q"][0] = 0
    run = banded_block._setup(qs, ts, 1, 1, 1, W, K, kw.get("x_threshold", 70), None,
                              kw.get("matrix"), True, None, None, kw.get("lens_q"),
                              kw.get("lens_t"), card)
    banded_block._forward(run)
    before = device_walk.block_walk.launches
    wire = device_walk.block_walk(run)
    assert device_walk.block_walk.launches == before + 1 and wire.device.type == "cuda"
    want = device_walk.block_walk_plain(run)
    assert torch.equal(wire.cpu(), want)
    for G in (None, 1, device_walk.GROUP):
        assert torch.equal(device_walk.block_walk_launch_t(run, _chunk=3, _group=G).cpu(),
                           want)
        assert torch.equal(device_walk.block_walk_launch_t(run, _group=G).cpu(), want)


@pytest.mark.parametrize("B", list(WALK_PAIRS))
@pytest.mark.parametrize("W", [16, 32, 96, 128])
@pytest.mark.parametrize("mode", ["linear", "blosum62"])
def test_xdrop_walk_equals_plain_on_card(card, mode, W, B):
    """The per-round map kernel (its default chunk, and chunks of 2 rounds)
    writes the plain version's wire, one launch a walk: per-pair lengths
    (one of 0) under (1,1,1), BLOSUM62 at X = 120."""
    kw = dict(matrix=BLOSUM62, x_threshold=120) if mode == "blosum62" else {}
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 20 if kw else 4, max(B, 4), WALK_PAIRS[B], card)
    qs, ts = qs[:B], ts[:B]
    lens = {k: v[:B] for k, v in lens.items()}
    lens["lens_q"][0] = 0
    res = banded_batch.banded_batch(qs, ts, bandwidth=W, compress_history=False,
                                    **lens, **kw)
    pad = _prep_padded(qs, ts, lens["lens_q"], lens["lens_t"], W, card, torch.int16)
    before = device_walk.xdrop_walk.launches
    wire = device_walk.xdrop_walk(res, pad, W, **kw)
    assert device_walk.xdrop_walk.launches == before + 1
    want = device_walk.xdrop_walk_plain(res, pad, W, **kw)
    assert torch.equal(wire.cpu(), want)
    pad32 = (*pad[:2], pad[2].int(), pad[3].int())
    table = sw_banded.banded_table(BLOSUM62, card) if kw else None
    small = device_walk.xdrop_walk_launch_t(res, pad32, W, kw.get("x_threshold", 70), 1,
                                            1, 1, table, _chunk=2)
    assert torch.equal(small.cpu(), want)


def test_serial_walk_kernels_equal_the_map_kernels_on_card(card):
    """The earlier one-thread-a-pair kernels (off every entry point) and the
    map kernels write the same wires on the same inputs: 64 related and
    random pairs with per-pair lengths."""
    rng = np.random.default_rng(10000)
    qs, ts, lens = xdrop_set(rng, 4, 64, 400, card)
    run = banded_block._setup(qs, ts, 1, 1, 1, 64, 32, 70, None, None, True, None, None,
                              lens["lens_q"], lens["lens_t"], card)
    banded_block._forward(run)
    serial = device_walk._block_serial_launch_t(run)
    for G in (1, device_walk.GROUP):
        assert torch.equal(device_walk.block_walk_launch_t(run, _group=G), serial)
    res = banded_batch.banded_batch(qs, ts, bandwidth=32, compress_history=False, **lens)
    pad = _prep_padded(qs, ts, lens["lens_q"], lens["lens_t"], 32, card, torch.int16)
    pad32 = (*pad[:2], pad[2].int(), pad[3].int())
    assert torch.equal(device_walk.xdrop_walk_launch_t(res, pad32, 32, 70, 1, 1, 1),
                       device_walk._xdrop_serial_launch_t(res, pad32, 32, 70, 1, 1, 1))


def test_walk_grids_past_what_the_card_holds_on_card(card):
    """Grids of more CTAs than the card holds at once: 2048 pairs, at least
    two producer CTAs a pair (a group of pairs, for the block walk's grouped
    producers) and a follower CTA a pair, of 256 threads. The CTAs take
    their roles by ticket, producers first, so no follower waiting on a
    producer can hold its place; the wires equal the plain versions'."""
    props = torch.cuda.get_device_properties(card)
    resident = (props.multi_processor_count
                * getattr(props, "max_threads_per_multi_processor", 2048) // 256)
    B = 2048
    assert B + B // device_walk.GROUP * 2 > resident
    rng = np.random.default_rng(10001)
    qs, ts, lens = xdrop_set(rng, 4, B, 48, card)
    run = banded_block._setup(qs, ts, 1, 1, 1, 32, 16, 70, None, None, True, None, None,
                              lens["lens_q"], lens["lens_t"], card)
    banded_block._forward(run)
    want = device_walk.block_walk_plain(run)
    for G in (1, device_walk.GROUP):
        assert torch.equal(device_walk.block_walk_launch_t(run, _group=G).cpu(), want)
    res = banded_batch.banded_batch(qs, ts, bandwidth=32, compress_history=False, **lens)
    pad = _prep_padded(qs, ts, lens["lens_q"], lens["lens_t"], 32, card, torch.int16)
    pad32 = (*pad[:2], pad[2].int(), pad[3].int())
    assert torch.equal(device_walk.xdrop_walk_launch_t(res, pad32, 32, 70, 1, 1, 1).cpu(),
                       device_walk.xdrop_walk_plain(res, pad, 32))


def test_reference_scale_banded_align_walks_on_card(card):
    """n + m + 1 > 6000, linear: banded_align_batch walks on the card."""
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(4, 3200)).astype(np.uint8)
    ts = np.stack([mutate(rng, q, out_len=3200) for q in qs])
    before = device_walk.xdrop_walk.launches
    got = banded_align_batch(qs, ts, bandwidth=32)
    assert device_walk.xdrop_walk.launches == before + 1
    assert got == banded_align_batch(qs, ts, bandwidth=32, device="cpu")


@pytest.mark.parametrize("argv", [
    ["--random", "8x300x300", "--bandwidth", "32", "--cigar"],
    ["--alphabet", "protein", "--random", "8x200x200", "--bandwidth", "16",
     "--x-drop", "120"],
    ["--random", "8x300x300", "--bandwidth", "32", "--gap-open", "3", "--gap-extend",
     "1"],
])
def test_block_cli_on_card_equals_cpu(card, argv):
    import contextlib
    import io

    from swtpu_torch.cli import main

    def run(device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["banded", "--block-adaptive"] + argv + ["--device", device])
        return buf.getvalue()

    before = banded_block.block_forward.launches
    on_card = run("cuda")
    assert banded_block.block_forward.launches > before
    assert on_card == run("cpu") and len(on_card.splitlines()) == 8


G4 = np.array([[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]])
STRIP_SCORINGS = {
    "dna_111": DNA_111,
    "gotoh_2_3_5_1": ScoringParams(dna_matrix(2, -3), 5, 1),
    "go_lt_ge": ScoringParams(dna_matrix(1, -1), 1, 3),
    "blosum62_11": ScoringParams.linear(BLOSUM62, 11),
    "blosum62_11_1": ScoringParams(BLOSUM62, 11, 1),
    "g4_2": ScoringParams.linear(G4, 2),
    "g4_3_1": ScoringParams(G4, 3, 1),
}


def _strip_case(rng, p, R, C, bounds):
    letters = 20 if p.alphabet_size > 4 else 4
    q, t = rng.integers(0, letters, R), rng.integers(0, letters, C)
    q[rng.random(R) < 0.03] = p.alphabet_size
    t[rng.random(C) < 0.03] = p.alphabet_size + 1
    if bounds == "random":
        return q, t, (rng.integers(-5, 60, C), rng.integers(-40, 40, C),
                      rng.integers(-5, 60, R), rng.integers(-40, 40, R), 7)
    if bounds == "neg":
        nc, nr = np.full(C, -(2**20)), np.full(R, -(2**20))
        return q, t, (nc, nc, nr, nr, -(2**20))
    return q, t, (np.zeros(C), np.full(C, -(2**20)), np.zeros(R), np.full(R, -(2**20)),
                  0)


def _strip(q, t, b, p, device):
    top, topf, left, lefte, corner = b
    if p.is_linear:
        return longpair_strip.strip_tile(q, t, top, left, corner, p, device=device)
    return longpair_strip.strip_tile_affine(q, t, top, topf, left, lefte, corner, p,
                                            device=device)


@pytest.mark.parametrize("R,C", [(1, 1), (7, 300), (33, 1), (1000, 64), (1031, 2),
                                 (1500, 700), (2053, 129), (4096, 257), (16384, 9)])
@pytest.mark.parametrize("scoring", list(STRIP_SCORINGS))
def test_strip_tile_equals_plain_on_card(card, scoring, R, C):
    p = STRIP_SCORINGS[scoring]
    rng = np.random.default_rng(10000 + R + C)
    for bounds in ("random", "neg", "zero"):
        q, t, b = _strip_case(rng, p, R, C, bounds)
        got = _strip(q, t, b, p, card)
        want = _strip(q, t, b, p, "cpu")
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), (bounds, R, C)


@pytest.mark.parametrize("R,C,scoring", [(40, 1024, "gotoh_2_3_5_1"),
                                         (1024, 256, "dna_111"), (1499, 700, "g4_3_1"),
                                         (4096, 4096, "gotoh_2_3_5_1"),
                                         (16383, 33, "blosum62_11_1")])
def test_strip_tile_one_block_equals_pipelined_on_card(card, R, C, scoring):
    """The earlier one-block kernel equals the pipelined one; a tile of 1024
    rows or more runs on several warps (one a CTA)."""
    p = STRIP_SCORINGS[scoring]
    rng = np.random.default_rng(10000 + R)
    q, t, (top, topf, left, lefte, corner) = _strip_case(rng, p, R, C, "random")
    affine = not p.is_linear
    i32 = (lambda x: torch.as_tensor(np.asarray(x)).to(card, torch.int32).contiguous())
    lext = torch.cat([i32([corner]), i32(left)])
    lexte = torch.cat([i32([-(2**20)]), i32(lefte)]) if affine else None
    args = (longpair_strip.stage_codes(q, p, card), longpair_strip.stage_codes(t, p, card),
            sw_profile.profile_table(p, card), i32(top), i32(topf) if affine else None,
            lext, lexte, p)
    got, grid = longpair_strip._pipe_launch(*args)
    br, bands = longpair_strip.strip_plan(R, C)
    assert grid == bands and (R < 1024 or bands > 1)
    for g, w in zip(got, longpair_strip.strip_launch_t(*args), strict=True):
        assert torch.equal(g, w)
    for g, w in zip(got, longpair_strip._one_block_launch_t(*args), strict=True):
        assert torch.equal(g, w)


def test_strip_tile_all_negative_and_guards_on_card(card):
    p = ScoringParams.linear(dna_matrix(-1, -1), 1)
    q = np.zeros(50, np.uint8)
    got = longpair_strip.strip_tile(q, q, np.zeros(50), np.zeros(50), 0, p, device=card)
    assert [int(x) for x in got[2:]] == [0, 0, 0]
    # a negative gap runs (within the plain tile's fill bound, which the
    # refusal states)
    neg = ScoringParams.linear(dna_matrix(1, -1), -1)
    got = longpair_strip.strip_tile(q, q, np.zeros(50), np.zeros(50), 0, neg, device=card)
    want = longpair_strip.strip_tile(q, q, np.zeros(50), np.zeros(50), 0, neg, device="cpu")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    before = longpair_strip.tile_strip_linear.launches
    with pytest.raises(NotImplementedError, match="2\\^20"):
        longpair_strip.strip_tile(np.zeros(16384, np.uint8), q, np.zeros(50),
                                  np.zeros(16384), 0,
                                  ScoringParams.linear(dna_matrix(1, -1), -33), device=card)
    with pytest.raises(NotImplementedError, match="rows"):
        longpair_strip.strip_tile(np.zeros(16385, np.uint8), q, np.zeros(50),
                                  np.zeros(16385), 0, DNA_111, device=card)
    assert longpair_strip.tile_strip_linear.launches == before
    with pytest.raises(NotImplementedError, match="engine='xla'"):
        longpair.longpair_sw_score(q, q, DNA_111, engine="xla", device=card)


@pytest.mark.parametrize("scoring,n,m,block", [
    ("dna_111", 3000, 2500, None), ("dna_111", 3000, 2500, 500),
    ("gotoh_2_3_5_1", 2000, 1800, 600), ("blosum62_11_1", 1200, 1000, None),
    ("dna_111", 17000, 300, None),
])
def test_longpair_on_card_equals_cpu(card, scoring, n, m, block):
    p = STRIP_SCORINGS[scoring]
    rng = np.random.default_rng(10000)
    letters = 20 if p.alphabet_size > 4 else 4
    q = rng.integers(0, letters, n).astype(np.uint8)
    t = np.concatenate([rng.integers(0, letters, 7), q])[:m].copy()
    t[rng.random(m) < 0.15] = rng.integers(0, letters, 1)
    before = (longpair_strip.tile_strip_linear.launches
              + longpair_strip.tile_strip_affine.launches)
    got = longpair.longpair_sw_ends(q, t, p, block=block, device=card)
    after = (longpair_strip.tile_strip_linear.launches
             + longpair_strip.tile_strip_affine.launches)
    strips = -(-n // longpair.STRIP_ROWS)
    assert after - before == strips * (m // (block or m))
    assert got == longpair.longpair_sw_ends(q, t, p, block=block, device="cpu")
    if n * m <= 4_000_000:
        assert longpair.longpair_sw_align(q, t, p, block=block, device=card)[0] == got[0]


@pytest.mark.parametrize("B,n,m,scoring,pairs", [
    (300, 100, 150, "dna_111", None), (257, 128, 128, "dna_10_30_15", None),
    (64, 128, 128, "blosum62_11", None), (33, 7, 1, "dna_111", None),
    (40, 128, 700, "g4_2", None), (5, 1, 64, "dna_111", None),
    (2500, 128, 128, "dna_10_30_15", None), (2500, 128, 128, "blosum62_11", None),
    # pairs a stream forced: ragged last streams, one and many pairs a
    # stream, m < 4, protein on the lane table, DNA on the table by pairs of
    # columns
    (1001, 128, 128, "dna_10_30_15", 4), (999, 128, 3, "dna_111", 16),
    (301, 128, 2, "blosum62_11", 3), (130, 60, 130, "g4_2", 3),
    (77, 128, 1, "blosum62_11", 1), (515, 100, 33, "dna_111", 1),
    (64, 128, 300, "blosum62_11", 7),
])
def test_wavefront_equals_plain_on_card(card, B, n, m, scoring, pairs):
    p = DNA_10_30_15 if scoring == "dna_10_30_15" else STRIP_SCORINGS[scoring]
    rng = np.random.default_rng(10000 + n + m + B)
    letters = 20 if p.alphabet_size > 4 else 4
    qs = rng.integers(0, letters, (B, n)).astype(np.uint8)
    ts = rng.integers(0, letters, (B, m)).astype(np.uint8)
    qs[:, n - n // 5:] = p.alphabet_size
    ts[rng.random(ts.shape) < 0.03] = p.alphabet_size + 1
    plain = sw_wavefront.sw_wavefront_plain(qs, ts, p, device=card)
    if pairs is None:
        before = sw_wavefront.sw_wavefront.launches
        got = sw_wavefront.sw_wavefront(qs, ts, p, device=card)
        assert sw_wavefront.sw_wavefront.launches == before + 1
        n_sm = torch.cuda.get_device_properties(card).multi_processor_count
        pairs = sw_wavefront.wavefront_stream(B, n, m, n_sm, p.alphabet_size)
    else:
        qd = torch.from_numpy(qs).to(card)
        td = torch.from_numpy(ts).to(card)
        got = sw_wavefront.wavefront_launch_t(qd, td, sw_wavefront.wavefront_table(p, card),
                                              p, pairs)
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), sw_wavefront.sw_wavefront(qs, ts, p, device="cpu"))
    if B * m <= 200_000:
        assert torch.equal(got, sw_wavefront.wavefront_stream_mirror(qs, ts, p, pairs,
                                                                     device=card))


@pytest.mark.parametrize("B,m,pairs", [(1001, 128, 4), (8192, 128, None), (99, 3, 16)])
def test_wavefront_table_forms_agree_on_card(card, B, m, pairs):
    """DNA on the lane table by pairs of columns (its default) and by
    columns (the form protein takes) give the same scores."""
    p = DNA_10_30_15
    rng = np.random.default_rng(10000 + B + m)
    qd = torch.from_numpy(rng.integers(0, 5, (B, 128)).astype(np.uint8)).to(card)
    td = torch.from_numpy(rng.integers(0, 6, (B, m)).astype(np.uint8)).to(card)
    table = sw_wavefront.wavefront_table(p, card)
    by_pairs = sw_wavefront.wavefront_launch_t(qd, td, table, p, pairs, True)
    by_columns = sw_wavefront.wavefront_launch_t(qd, td, table, p, pairs, False)
    assert torch.equal(by_pairs, by_columns)
    assert torch.equal(by_pairs, sw_wavefront.sw_wavefront_plain(qd, td, p))


def test_wavefront_refuses_negative_gap_on_card(card):
    """No longer refused: a negative gap runs the kernel at one pair a
    stream (the TPU schedule's score, the plain version's), and ``align
    --engine wavefront`` takes it."""
    p = ScoringParams.linear(dna_matrix(2, -3), -1)
    q = np.random.default_rng(10000).integers(0, 4, (4, 16)).astype(np.uint8)
    qd = torch.from_numpy(q).to(card)
    before = (sw_wavefront.sw_wavefront.launches,
              sw_wavefront.sw_wavefront.launches_negative)
    assert torch.equal(sw_wavefront.sw_wavefront(q, q, p, device=card),
                       sw_wavefront.sw_wavefront_plain(qd, qd, p))
    with pytest.raises(ValueError, match="one pair a stream"):
        sw_wavefront.wavefront_launch_t(qd, qd, sw_wavefront.wavefront_table(p, card), p,
                                        pairs=4)
    from swtpu_torch.ops.variants import variant_engine

    got = variant_engine("wavefront", p, 16, device=card)(qd, qd)
    assert (sw_wavefront.sw_wavefront.launches,
            sw_wavefront.sw_wavefront.launches_negative) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, sw_wavefront.sw_wavefront_plain(qd, qd, p))


def test_wavefront_long_queries_on_card(card):
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, (2, 512)).astype(np.uint8)
    ts = rng.integers(0, 4, (2, 384)).astype(np.uint8)
    before = longpair_strip.tile_strip_linear.launches
    got = sw_wavefront.sw_wavefront(qs, ts, DNA_111, device=card)
    assert longpair_strip.tile_strip_linear.launches == before + 2
    assert got.cpu().tolist() == sw_score_batch(qs, ts, DNA_111).tolist()


@pytest.mark.parametrize("argv", [
    ["longpair", "--random", "2x3000x2000", "--cigar"],
    ["longpair", "--alphabet", "protein", "--random", "1x900x800", "--gap-open", "11",
     "--gap-extend", "1", "--block", "300", "--sam"],
    ["align", "--random", "64x128x128", "--scoring", "10,-30", "--gap", "15",
     "--engine", "wavefront"],
])
def test_longpair_and_wavefront_cli_on_card_equals_cpu(card, argv, capsys):
    from swtpu_torch.cli import main

    main(argv)
    on_card = capsys.readouterr().out
    main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == on_card and on_card


SEARCH_SCORINGS = {"dna": DNA_10_30_15, "gotoh": AFF,
                   "protein": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)}


@pytest.mark.parametrize("scoring", list(SEARCH_SCORINGS))
def test_search_modes_on_card_equal_cpu(card, scoring):
    from swtpu_torch.parallel.search import all_vs_all_topk

    p = SEARCH_SCORINGS[scoring]
    letters = 20 if p.alphabet_size > 4 else 4
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, letters, (5, 48)).astype(np.uint8)
    ts = rng.integers(0, letters, (1000, 52)).astype(np.uint8)
    ts[::97, :48] = qs[0]  # tied top hits: the lower id first
    want = all_vs_all_topk(qs, ts, p, k=7, chunk_size=128, resident=False, packed=False,
                           device="cpu")
    modes = [dict(resident=False, packed=False), dict(resident=True, packed=False),
             dict(resident=True, packed=False, max_retries=0),
             dict(resident=False, packed=False, sync_every=2)]
    if letters == 4:
        modes += [dict(resident=False, packed=True), dict(resident=True, packed=True),
                  dict(resident=True, packed=True, max_retries=0)]
    for kw in modes:
        got = all_vs_all_topk(qs, ts, p, k=7, chunk_size=128, **kw)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), kw
    assert (want[1][0, :5] == np.arange(0, 97 * 5, 97)).all()


def test_search_checkpoint_and_retry_on_card(card, tmp_path):
    from swtpu_torch.parallel.search import SearchCheckpoint, all_vs_all_topk
    from swtpu_torch.ops.variants import best_engine

    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, (4, 64)).astype(np.uint8)
    ts = rng.integers(0, 4, (700, 64)).astype(np.uint8)
    full = all_vs_all_topk(qs, ts, DNA_10_30_15, k=5, chunk_size=64)
    ck = SearchCheckpoint(str(tmp_path / "c.npz"))
    all_vs_all_topk(qs, ts[:256], DNA_10_30_15, k=5, chunk_size=64, checkpoint=ck)
    got = all_vs_all_topk(qs, ts, DNA_10_30_15, k=5, chunk_size=64, checkpoint=ck)
    assert np.array_equal(got[0], full[0]) and np.array_equal(got[1], full[1])
    engine, calls = best_engine(DNA_10_30_15), {"n": 0}

    def flaky(q, t):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected fault")
        return engine(q, t)

    got = all_vs_all_topk(qs, ts, DNA_10_30_15, k=5, chunk_size=64, engine=flaky,
                          sync_every=4)
    assert np.array_equal(got[0], full[0]) and np.array_equal(got[1], full[1])
    assert calls["n"] > 11


@pytest.mark.parametrize("argv", [
    ["search", "--random", "8x2000x40", "--topk", "5", "--chunk", "256", "--tsv"],
    ["search", "--random", "4x500x40", "--topk", "3", "--chunk", "128", "--both-strands",
     "--sam"],
    ["search", "--alphabet", "protein", "--random", "4x300x32", "--topk", "3", "--chunk",
     "128", "--gap-open", "11", "--gap-extend", "1", "--tsv", "--stats", "preset"],
])
def test_search_cli_on_card_equals_cpu(card, argv, capsys):
    from swtpu_torch.cli import main

    main(argv)
    on_card = capsys.readouterr().out
    main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == on_card and on_card


# -- the models (mapper, MSA, assembly) on the card against the CPU -----------

from swtpu_torch.models import assembly as models_assembly  # noqa: E402
from swtpu_torch.models import mapper as models_mapper  # noqa: E402
from swtpu_torch.models import msa as models_msa  # noqa: E402


@pytest.fixture(scope="module")
def map_case():
    """A 20,000-base genome, 96 mutation-model reads of 120 (half reverse
    complemented), the index at k = 9."""
    rng = np.random.default_rng(10000)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    starts = rng.integers(0, 20000 - 120, 96)
    reads = np.stack([mutate(rng, genome[s: s + 120], out_len=120) for s in starts])
    flip = rng.random(96) < 0.5
    reads[flip] = np.stack([3 - r[::-1] for r in reads[flip]])
    return reads, models_mapper.build_index([genome], k=9)


def _hits(hits):
    return [None if h is None else (h.read, h.contig, h.pos, h.score, h.strand,
                                    h.n_seeds, h.path, h.window_start) for h in hits]


def _model_counts():
    return dict(fixed=sw_banded.sw_banded_static.launches,
                fixed_profile=sw_banded.sw_banded_profile.launches,
                xdrop=banded_batch.banded_batch.launches,
                b9=banded_block.block_forward.launches + banded_block.block_rows.launches,
                walk=device_walk.block_walk.launches)


@pytest.mark.parametrize("kw,need", [
    (dict(), ("fixed",)),
    (dict(traceback=True, both_strands=True), ("fixed", "b9", "walk")),
    (dict(traceback=True, gap_open=3, gap_extend=1), ("fixed", "xdrop")),
    (dict(traceback=True, bandwidth=48), ("fixed", "xdrop")),
    (dict(extend="adaptive", traceback=True, ambiguous=True), ("xdrop", "b9", "walk")),
    (dict(extend="fixed", ambiguous=True), ("fixed",)),
])
def test_mapper_on_card_equals_card_route_on_cpu(card, map_case, kw, need):
    """The mapper on the card (its route: the fixed corridor on the 2-bit
    wire, the raw wire for reads with an in-length N, linear winners on
    the block tier, Gotoh and wide-band winners on the per-round band)
    equals the same route on the CPU's plain tiers, hit for hit."""
    reads, idx = map_case
    kw = dict(kw)
    if kw.pop("ambiguous", False):
        reads = reads.copy()
        reads[::7, 60] = 4
    before = _model_counts()
    got = models_mapper.map_reads(reads, index=idx, min_score=20, **kw)
    after = _model_counts()
    want = models_mapper.map_reads(reads, index=idx, min_score=20, device="cpu",
                                   route="card", **kw)
    assert _hits(got) == _hits(want)
    assert sum(h is not None for h in got) >= len(reads) // 3
    ran = {k for k in after if after[k] > before[k]}
    assert set(need) <= ran, (need, ran)
    if "b9" not in need:
        assert "b9" not in ran and "walk" not in ran


def test_mapper_pipelined_on_card(card, map_case):
    reads, idx = map_case
    kw = dict(index=idx, min_score=20, traceback=True, both_strands=True)
    assert _hits(models_mapper.map_reads_pipelined(reads, chunk_reads=32, **kw)) == _hits(
        models_mapper.map_reads(reads, **kw))


@pytest.mark.parametrize("scoring", ["linear", "gotoh", "protein"])
def test_msa_on_card_equals_cpu(card, scoring, monkeypatch):
    """The MSA on the card launches the pinned semi-global kernel (row 8
    uniform, row 9 BLOSUM62), never the plain scan, and equals the CPU."""
    rng = np.random.default_rng(10000)
    letters = 20 if scoring == "protein" else 4
    anc = rng.integers(0, letters, 90).astype(np.uint8)
    seqs = [mutate(rng, anc) for _ in range(9)]
    params = {"linear": ScoringParams.linear(dna_matrix(2, -3), 2),
              "gotoh": ScoringParams(dna_matrix(2, -3), 4, 1),
              "protein": ScoringParams(BLOSUM62, 11, 1)}[scoring]
    want = models_msa.msa_center_star(seqs, params=params, device="cpu")
    wrapper = (semiglobal_profile.semiglobal_profile if scoring == "protein"
               else semiglobal_batch.semiglobal_batch)
    before = wrapper.launches_pinned
    for mod, name in ((semiglobal_batch, "semiglobal_batch_diag"),
                      (semiglobal_profile, "semiglobal_batch_general")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(
            f"plain scan {_n} ran on the card"))
    got = models_msa.msa_center_star(seqs, params=params)
    assert wrapper.launches_pinned == before + 3  # center pick, star, self score
    assert got.center == want.center and got.sp == want.sp
    assert np.array_equal(got.scores, want.scores)
    assert all(np.array_equal(a, b) for a, b in zip(got.rows, want.rows))


def test_assembly_on_card_equals_cpu(card):
    """The assembly screen launches the row-scan kernel (rows 1-4) on the
    card; with N inside the reads its scores and the contig equal the
    CPU's."""
    rng = np.random.default_rng(10000)
    genome = rng.integers(0, 4, 1500).astype(np.uint8)
    reads = [r.copy() for r in models_assembly.make_reads(rng, genome, 150, 50)]
    for r in reads:
        r[rng.integers(0, 150, 2)] = 4
    bq, bt, _ = models_assembly._screen_batch(reads)
    before = sw_batch.sw_batch.launches
    from swtpu_torch.ops.variants import best_engine

    got = best_engine(DNA_111)(bq, bt).cpu().numpy()
    assert sw_batch.sw_batch.launches == before + 1
    assert np.array_equal(got, best_engine(DNA_111, "cpu")(bq, bt).numpy())
    contig = models_assembly.assemble_greedy(reads, min_overlap=30, slack=4)
    assert sw_batch.sw_batch.launches == before + 2
    assert np.array_equal(contig, models_assembly.assemble_greedy(
        reads, min_overlap=30, slack=4, device="cpu"))
    assert len(contig) == len(genome)


@pytest.mark.parametrize("argv", [
    ["msa", "--random", "12x80", "--scoring", "2,-3", "--gap", "2"],
    ["msa", "--random", "6x60", "--alphabet", "protein", "--gap-open", "11",
     "--gap-extend", "1"],
    ["assemble", "--random", "3000x150x50"],
    ["assemble", "--random", "1200x150x50", "--sam"],
])
def test_models_cli_on_card_equals_cpu(card, argv, capsys):
    from swtpu_torch.cli import main

    main(argv)
    on_card = capsys.readouterr()
    main(argv + ["--device", "cpu"])
    assert capsys.readouterr() == on_card and on_card.out


def test_map_cli_on_card(card, capsys):
    import json

    from swtpu_torch.cli import main

    main(["map", "--random", "100000x256x150", "--traceback"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["reads"] == 256 and rec["correct_locus"] >= 0.9 * 256


@pytest.fixture
def world_of_one_on_card(card):
    import torch.distributed as dist

    yield card
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_world_of_one_on_card(world_of_one_on_card):
    """With no process group, make_mesh starts a world of one under NCCL on
    the card; data-parallel scores, the sharded search and the sharded
    long-pair sweep through it equal the one-card entry points."""
    import torch.distributed as dist

    from swtpu_torch.ops.variants import best_engine
    from swtpu_torch.parallel import (
        all_vs_all_topk, data_parallel_scores, longpair_sw_ends, make_mesh,
        sharded_all_vs_all_topk,
    )

    card = world_of_one_on_card
    mesh, sp = make_mesh(), make_mesh(axis="sp")
    assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, 4096, 128, card), codes(rng, 4096, 120, card)
    for p in (DNA_10_30_15, ScoringParams(BLOSUM62, 11, 1)):
        d = data_parallel_scores(qs, ts, p, mesh)
        assert d.to_local().is_cuda
        assert torch.equal(d.full_tensor(), best_engine(p)(qs, ts))
    Q = rng.integers(0, 4, (8, 100)).astype(np.uint8)
    T = rng.integers(0, 4, (3001, 100)).astype(np.uint8)
    got = sharded_all_vs_all_topk(Q, T, DNA_111, mesh, k=7)
    want = all_vs_all_topk(Q, T, DNA_111, k=7, chunk_size=1024)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    q = rng.integers(0, 4, 3000).astype(np.uint8)
    t = mutate(rng, q, out_len=2000)
    for p in (DNA_111, ScoringParams(dna_matrix(2, -3), 5, 1)):
        assert longpair_sw_ends(q, t, p, sp) == longpair_sw_ends(q, t, p)


def test_mesh_two_ranks_share_the_card(card, tmp_path, capsys):
    """Two gloo ranks on the one card (tests/_torch_mesh_worker.py): their
    kernels run on the card, their exchanges cross through the host, and
    every sharded result equals the one-card entry point's."""
    import importlib.util
    import json
    import os
    import subprocess
    import sys

    from swtpu_torch.cli import main
    from swtpu_torch.ops.variants import best_engine
    from swtpu_torch.parallel import all_vs_all_topk, longpair_sw_align, longpair_sw_ends

    worker = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
    spec = importlib.util.spec_from_file_location("_torch_mesh_worker", worker)
    W = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(W)
    out = tmp_path / "out.json"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(tmp_path / "store"), str(out), "cuda"],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    logs = [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    for r, (so, se, rc) in enumerate(logs):
        assert rc == 0 and f"MESH_OK {r}" in so, f"rank {r} rc={rc}\n{so}\n{se}"
    res = json.loads(out.read_text())
    z = W.inputs()
    for key in W.DP:
        want = best_engine(W.SCORINGS[key])(z["dp_q"], z["dp_t"]).cpu().tolist()
        assert res["dp_" + key] == want
    for case, (key, *_, k) in W.TOPK.items():
        s, i = all_vs_all_topk(*z[case], W.SCORINGS[key], k=k, chunk_size=16)
        assert res["topk_" + case] == [s.tolist(), i.tolist()]
    q, t = z["lp"]
    for key in W.LP:
        p = W.SCORINGS[key]
        for block in W.BLOCKS:
            blk = None if block == "auto" else int(block)
            rows, ends = res[f"lp_{key}_{block}"]
            assert tuple(ends) == longpair_sw_ends(q, t, p, block=blk)
            assert len(rows) == 2 and max(r_[0] for r_ in rows) == ends[0]
        score, path = longpair_sw_align(q, t, p)
        assert res[f"lp_{key}_align"] == [score, [list(x) for x in path]]
    main(W.CLI[1])
    assert res["cli_1"] == [capsys.readouterr().out, ""]


def test_fuzz_on_card_adds_the_kernels(card):
    """Every family once on the card: 0 mismatches, and more engine runs
    than on the CPU (the kernels beside the plain tiers, and the fixed-band
    and block-band rounds, which the CPU skips)."""
    from swtpu_torch.fuzz import run_fuzz

    kw = dict(max_rounds=11, pairs_per_round=64, save_dir=None, log=None, minutes=30)
    on_card = run_fuzz(**kw)
    on_cpu = run_fuzz(**kw, device="cpu")
    assert on_card.mismatches == 0 and on_card.rounds == 11
    assert on_card.pairs > on_cpu.pairs and on_card.cells > on_cpu.cells


def test_selftest_on_card_runs_every_check(card):
    from swtpu_torch.selftest import run_selftest

    checks = run_selftest()
    assert len(checks) == 23 and all(ok for _, ok in checks), checks


def test_profile_trace_on_card_sees_the_kernels(card, tmp_path):
    from swtpu_torch.ops.variants import best_engine
    from swtpu_torch.utils.obs import profile_trace, trace_busy

    rng = np.random.default_rng(10000)
    qs, ts = codes(rng, 8192, 128, card), codes(rng, 8192, 128, card)
    fn = best_engine(DNA_10_30_15)
    fn(qs, ts)
    with profile_trace(str(tmp_path)) as prof:
        fn(qs, ts)
        torch.cuda.synchronize()
    busy, window = trace_busy(prof.trace_path)
    assert 0 < busy <= window


def test_bench_suite_quick_on_card(card, tmp_path, capsys):
    """The benchmark suite at --quick on the card (its 16K child too):
    JAX's TPU names in order, every parity field true, the kernels'
    launches by record."""
    import json

    from swtpu_torch import bench_suite

    path = tmp_path / "launches.json"
    bench_suite.main(["--quick", "--launches", str(path)])
    recs = [json.loads(x[len("JSON: "):]) for x in capsys.readouterr().out.splitlines()
            if x.startswith("JSON: ")]
    assert [r["kernel"] for r in recs] == bench_suite.expected_kernels("all", quick=True)
    assert all(r.get(f) is not False for r in recs for f in bench_suite.PARITY_FIELDS)
    assert {r["device"] for r in recs if "device" in r} == {torch.cuda.get_device_name(0)}
    counts = json.loads(path.read_text())["by_record"]
    assert counts["sw_111_rowscan"]["sw_batch.sw_batch.launches"] > 0
    assert counts["banded_16k_traceback_e2e"]["device_walk.xdrop_walk.launches"] > 0


# -- gaps of 0 and below, entries past +-127: the three extended kernels ----

@pytest.mark.parametrize("gap", [-1, -3])
@pytest.mark.parametrize("B,n,m,protein", [
    (1, 7, 50, False), (3, 100, 128, False), (200, 128, 128, False),
    (5, 128, 3, False), (64, 60, 300, True), (9, 0, 4, False),
])
def test_wavefront_negative_gap_equals_plain_on_card(card, gap, B, n, m, protein):
    """One pair a stream over the TPU's step count, both tables."""
    p = ScoringParams.linear(BLOSUM62 if protein else dna_matrix(2, -3), gap)
    A = p.alphabet_size
    rng = np.random.default_rng(10000 + B + n + m)
    qs = rng.integers(0, A + 1, (B, n)).astype(np.uint8)
    ts = rng.integers(0, A + 2, (B, m)).astype(np.uint8)
    want = sw_wavefront.sw_wavefront_plain(qs, ts, p, device=card)
    assert torch.equal(sw_wavefront.sw_wavefront(qs, ts, p, device=card), want)
    assert torch.equal(sw_wavefront.wavefront_stream_mirror(qs, ts, p, 1, device=card),
                       want)
    if not protein:  # DNA by columns too
        qd, td = torch.from_numpy(qs).to(card), torch.from_numpy(ts).to(card)
        assert torch.equal(sw_wavefront.wavefront_launch_t(
            qd, td, sw_wavefront.wavefront_table(p, card), p, 1, False), want)


NEG_STRIP = {
    "gap_-1": ScoringParams.linear(dna_matrix(1, -1), -1),
    "gap_-32": ScoringParams.linear(dna_matrix(1, -1), -32),
    "gotoh_2_-1": ScoringParams(dna_matrix(2, -3), 2, -1),
    "gotoh_3_0": ScoringParams(dna_matrix(2, -3), 3, 0),
    "gotoh_-2_1": ScoringParams(dna_matrix(2, -3), -2, 1),
    "blosum62_11_-1": ScoringParams(BLOSUM62, 11, -1),
}


@pytest.mark.parametrize("name", list(NEG_STRIP))
@pytest.mark.parametrize("R,C", [(300, 200), (33, 1000), (4096, 129), (16384, 40)])
def test_strip_tile_negative_gaps_equal_plain_on_card(card, name, R, C):
    """B13 (both kernels) against the plain tile on random boundaries."""
    p = NEG_STRIP[name]
    A = 20 if p.alphabet_size > 4 else 4
    rng = np.random.default_rng(10000 + R + C)
    q, t = rng.integers(0, A + 1, R), rng.integers(0, A + 2, C)
    top, left = rng.integers(0, 60, C), rng.integers(0, 60, R + 1)
    topf, lefte = rng.integers(-2, 40, C), rng.integers(-2, 40, R + 1)
    lefte[0] = -(2**20)
    i32 = dict(dtype=torch.int32, device=card)
    args = (longpair_strip.stage_codes(q, p, card), longpair_strip.stage_codes(t, p, card),
            sw_profile.profile_table(p, card), torch.as_tensor(top, **i32),
            None if p.is_linear else torch.as_tensor(topf, **i32),
            torch.as_tensor(left, **i32),
            None if p.is_linear else torch.as_tensor(lefte, **i32), p)
    if p.is_linear:
        want = longpair_strip.strip_tile(q, t, top, left[1:], left[0], p, device="cpu")
    else:
        want = longpair_strip.strip_tile_affine(q, t, top, topf, left[1:], lefte[1:],
                                                left[0], p, device="cpu")
    for got in (longpair_strip.strip_launch_t(*args),
                longpair_strip._one_block_launch_t(*args)):
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", ["gap_-1", "gotoh_2_-1", "dna_111"])
def test_strip_tile_wide_key_on_card(card, name):
    """Boundaries near 2^27: H passes the packed key's range, and B13
    keeps (value, row) apart, equal to the plain tile."""
    p = NEG_STRIP.get(name) or DNA_111
    rng = np.random.default_rng(10000)
    R, C = 300, 200
    q, t = rng.integers(0, 4, R), rng.integers(0, 4, C)
    high = longpair_strip.KEY_MAX - 20
    top, left = high + rng.integers(0, 60, C), high + rng.integers(0, 60, R + 1)
    topf, lefte = top - 2, left - 2
    i32 = dict(dtype=torch.int32, device=card)
    args = (longpair_strip.stage_codes(q, p, card), longpair_strip.stage_codes(t, p, card),
            sw_profile.profile_table(p, card), torch.as_tensor(top, **i32),
            None if p.is_linear else torch.as_tensor(topf, **i32),
            torch.as_tensor(left, **i32),
            None if p.is_linear else torch.as_tensor(lefte, **i32), p)
    if p.is_linear:
        want = longpair_strip.strip_tile(q, t, top, left[1:], left[0], p, device="cpu")
    else:
        want = longpair_strip.strip_tile_affine(q, t, top, topf, left[1:], lefte[1:],
                                                left[0], p, device="cpu")
    assert int(want[-3]) >= longpair_strip.KEY_MAX
    for got in (longpair_strip.strip_launch_t(*args),
                longpair_strip._one_block_launch_t(*args)):
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", ["gap_-1", "gotoh_2_-1"])
def test_longpair_negative_gaps_on_card_equal_cpu(card, name):
    p = NEG_STRIP[name]
    rng = np.random.default_rng(10000)
    q = rng.integers(0, 4, 17000).astype(np.uint8)
    t = np.concatenate([rng.integers(0, 4, 7), q])[:2500].copy()
    got = longpair.longpair_sw_ends(q, t, p, block=500, device=card)
    assert got == longpair.longpair_sw_ends(q, t, p, block=500, device="cpu")
    q2, t2 = q[:1500], t[:1200]
    assert (longpair.longpair_sw_align(q2, t2, p, device=card)
            == longpair.longpair_sw_align(q2, t2, p, device="cpu"))


NONPOS_SG = {
    "gap_0": dict(match=1, mismatch=1, gap=0),
    "gap_-1": dict(match=1, mismatch=1, gap=-1),
    "gotoh_2_-1": dict(match=2, mismatch=1, gap_open=2, gap_extend=-1),
    "gotoh_3_0": dict(match=2, mismatch=3, gap_open=3, gap_extend=0),
    "gotoh_0_1": dict(match=1, mismatch=1, gap_open=0, gap_extend=1),
    "blosum62_11_0": ScoringParams(BLOSUM62, 11, 0),
    "blosum62_11_-1": ScoringParams(BLOSUM62, 11, -1),
    "blosum62x12_11_1": ScoringParams(BLOSUM62 * 12, 11, 1),
}


@pytest.mark.parametrize("name", list(NONPOS_SG))
@pytest.mark.parametrize("B,n,m", [(300, 64, 96), (200, 20, 13), (50, 40, 300),
                                   (40, 5, 3)])
def test_semiglobal_nonpositive_gaps_equal_plain_on_card(card, name, B, n, m):
    """Both forms, argmax (key and select trackers) and pinned, fixed and
    per-pair lengths (down to -1 and past the widths), against the plain
    tier and the CPU mirror."""
    s = NONPOS_SG[name]
    uniform = isinstance(s, dict)
    A = 4 if uniform else 20
    rng = np.random.default_rng(10000 + n + m)
    q = torch.from_numpy(rng.integers(0, A + 1, (B, n)).astype(np.uint8)).to(card)
    t = torch.from_numpy(rng.integers(0, A + 1, (B, m)).astype(np.uint8)).to(card)
    lens = dict(lens_q=rng.integers(-1, n + 2, B), lens_t=rng.integers(-1, m + 2, B))
    for pin in (False, True):
        for kw in ({}, lens):
            if uniform:
                got = semiglobal_batch.semiglobal_batch(q, t, **s, **kw, pin_end=pin)
                want = semiglobal_batch.semiglobal_batch_plain(q, t, **s, **kw,
                                                               pin_end=pin, device=card)
                mirror = semiglobal_batch.semiglobal_skew_mirror(q.cpu(), t.cpu(), **s,
                                                                 **kw, pin_end=pin)
            else:
                got = semiglobal_profile.semiglobal_profile(q, t, s, **kw, pin_end=pin)
                want = semiglobal_profile.semiglobal_profile_plain(q, t, s, **kw,
                                                                   pin_end=pin,
                                                                   device=card)
                mirror = semiglobal_batch.semiglobal_skew_mirror(
                    q.cpu(), t.cpu(), **kw, pin_end=pin, params=s)
            for g, w, x in zip(got, want, mirror, strict=True):
                assert torch.equal(g, w) and torch.equal(g.cpu(), x)
    if uniform:  # the select tracker where the key would run
        go, ge, affine = semiglobal_batch.gaps(**{k: v for k, v in s.items()
                                                   if k.startswith("gap")})
        got = semiglobal_batch.semiglobal_launch_t(q, t, s["match"], -s["mismatch"], go, ge,
                                                   affine, False, select=True)
        want = semiglobal_batch.semiglobal_batch_plain(q, t, **s, device=card)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("argv", [
    ["semiglobal", "--random", "4x64x256", "--gap", "-1", "--traceback"],
    ["global", "--random", "4x64x256", "--gap", "-1", "--traceback"],
    ["semiglobal", "--random", "6x40x50", "--gap", "0", "--cigar"],
    ["global", "--alphabet", "protein", "--random", "4x60x70", "--gap-open", "11",
     "--gap-extend", "-1", "--sam"],
    ["align", "--random", "8x128x128", "--engine", "wavefront", "--gap", "-1"],
    ["longpair", "--random", "1x300x300", "--gap", "-1", "--traceback"],
])
def test_nonpositive_gap_cli_on_card_equals_cpu(card, argv, capsys):
    from swtpu_torch import cli

    cli.main(argv)
    on_card = capsys.readouterr().out
    cli.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == on_card and on_card
