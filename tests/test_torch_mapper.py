"""The port's read mapper (``swtpu_torch/models/mapper.py``) and ``map``
CLI against the JAX package's on ``device="cpu"``, and the card's route
composed on the CPU's plain tiers against the port's oracles.

- the index (k-mer codes, the sorted table, the direct-addressed table,
  the 2-bit reference and its separator bitmask) and the seeding on its
  numpy and C++ paths, equal to JAX's;
- ``extend_candidates`` in "adaptive", "fixed" and "fixed-packed" (one
  Pallas interpret call on JAX's side) equal to JAX's;
- ``map_reads`` on JAX's CPU route with and without traceback, both
  strands, several contigs, and ``map_reads_pipelined`` equal to it;
- the card's route (fixed corridor on the 2-bit wire, linear winners on
  the block tier, every other winner on the per-round band) against
  ``oracle.banded_static``, ``oracle.banded_block`` and the per-round
  oracles; gap_open == gap_extend (where JAX's off-TPU traceback raises
  TypeError) against the per-round oracle;
- ``map`` byte-equal to ``python -m swtpu map`` on five flag sets.

Seed 10000; tolerance 0 everywhere.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

from swtpu import native as jax_native
from swtpu.cli import main as jax_cli
from swtpu.models import mapper as jm
from swtpu_torch import cli as port_cli
from swtpu_torch import native as port_native
from swtpu_torch.core.encode import mutate, revcomp
from swtpu_torch.core.io import decode_dna, write_fasta
from swtpu_torch.core.scoring import ScoringParams, dna_matrix
from swtpu_torch.models import mapper as pm
from swtpu_torch.oracle.banded_affine import banded_affine_xdrop
from swtpu_torch.oracle.banded_block import banded_xdrop_block
from swtpu_torch.oracle.banded_static import sw_banded_static_score
from swtpu_torch.oracle.semiglobal import banded_xdrop

SEED = 10000
INDEX_FIELDS = ("ref", "codes", "pos", "contig_starts", "contig_lens", "starts",
                "ref_packed", "ref_sepmask")


def _reads(rng, contigs, R, L, both_strands=False):
    """R mutation-model reads of length L from random loci of the contigs
    (half reverse-complemented with ``both_strands``)."""
    reads = []
    for _ in range(R):
        c = contigs[int(rng.integers(0, len(contigs)))]
        s = int(rng.integers(0, len(c) - L))
        r = mutate(rng, c[s: s + L], out_len=L)
        reads.append(revcomp(r) if both_strands and rng.random() < 0.5 else r)
    return np.stack(reads)


@pytest.fixture(scope="module")
def case():
    """Two contigs (3000 and 2500 bases), 40 reads of 100 (every fifth
    with an in-length N), both indexes at k = 9."""
    rng = np.random.default_rng(SEED)
    contigs = [rng.integers(0, 4, n).astype(np.uint8) for n in (3000, 2500)]
    reads = _reads(rng, contigs, 40, 100, both_strands=True)
    reads[::5, 50] = 4
    return dict(contigs=contigs, reads=reads, jidx=jm.build_index(contigs, k=9),
                pidx=pm.build_index(contigs, k=9))


def _same_hits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("k", [3, 9, 13])
def test_kmer_codes_match_jax(k):
    rng = np.random.default_rng(SEED)
    rows = rng.integers(0, 6, (7, 40)).astype(np.uint8)  # pads 4 and 5 inside
    assert np.array_equal(pm._kmer_codes(rows, k), jm._kmer_codes(rows, k))
    assert np.array_equal(pm._kmer_codes(rows[:, :2], k), jm._kmer_codes(rows[:, :2], k))


@pytest.mark.parametrize("k", [9, 13])
def test_build_index_matches_jax(k):
    rng = np.random.default_rng(SEED)
    contigs = rng.integers(0, 4, (3, 700)).astype(np.uint8)
    lens = [700, 513, 299]  # padded rows trimmed to their lengths
    want = jm.build_index(contigs, ["a", "b", "c"], k=k, lens=lens)
    got = pm.build_index(contigs, ["a", "b", "c"], k=k, lens=lens)
    for f in INDEX_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None)
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert got.contig_names == want.contig_names and got.k == want.k
    pos = np.array([0, 699, 700 + k, 1300, 1500])
    assert all(np.array_equal(a, b) for a, b in zip(got.locate(pos), want.locate(pos)))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_find_candidates_matches_jax(case, path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(port_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)  # JAX's anchor
    reads = case["reads"]
    lens = np.full(len(reads), reads.shape[1])
    lens[3] = 60  # a shorter read: its k-mers past the length are masked
    for kw in (dict(), dict(min_seeds=3, max_occ=4, max_loci=2, diag_window=16)):
        want = jm.find_candidates(case["jidx"], reads, lens, **kw)
        got = pm.find_candidates(case["pidx"], reads, lens, **kw)
        for f in ("read", "tstart", "n_seeds"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), (path, kw, f)
        assert len(got.read) >= 10


@pytest.mark.parametrize("extend", ["adaptive", "fixed"])
def test_extend_candidates_matches_jax(case, extend):
    reads = case["reads"][:12]
    lens = np.full(len(reads), reads.shape[1])
    cands = pm.find_candidates(case["pidx"], reads, lens)
    for kw in (dict(), dict(match=2, mismatch=3, gap_open=3, gap_extend=1)):
        want = jm.extend_candidates(case["jidx"], reads, lens, cands, extend=extend, **kw)
        got = pm.extend_candidates(case["pidx"], reads, lens, cands, extend=extend,
                                   device="cpu", **kw)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0].astype(np.int64), want[0].astype(np.int64)), kw


def test_extend_fixed_packed_matches_jax():
    """The 2-bit wire (decode, separator restore, lengths) on windows that
    cross both contig boundaries and clip at both ends of the reference,
    against JAX's packed wire through its Pallas kernel in interpret
    mode (its one interpret call here)."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(SEED)
    c1, c2 = (rng.integers(0, 4, n).astype(np.uint8) for n in (300, 260))
    L = 60
    jidx, pidx = jm.build_index([c1, c2], k=9), pm.build_index([c1, c2], k=9)
    src = [(c1, 0), (c1, 240), (c2, 0), (c2, 200), (c1, 120)]
    reads = np.stack([mutate(rng, c[s: s + L], out_len=L) for c, s in src])
    lens = np.full(len(reads), L)
    cands = pm.find_candidates(pidx, reads, lens)
    assert cands.tstart.min() < 8 and cands.tstart.max() + L + 64 > len(pidx.ref)
    with pltpu.force_tpu_interpret_mode():
        want = jm.extend_candidates(jidx, reads, lens, cands, extend="fixed-packed")
    got = pm.extend_candidates(pidx, reads, lens, cands, extend="fixed-packed",
                               device="cpu")
    assert np.array_equal(got[1], want[1])
    assert np.array_equal(got[0].astype(np.int64), np.asarray(want[0], np.int64))
    # the card's route picks the 2-bit wire for pure-ACGT reads
    card = pm.extend_candidates(pidx, reads, lens, cands, device="cpu", route="card")
    assert np.array_equal(card[0], got[0]) and np.array_equal(card[1], got[1])


@pytest.mark.parametrize("traceback", [False, True])
@pytest.mark.parametrize("both_strands", [False, True])
def test_map_reads_matches_jax(case, traceback, both_strands):
    reads = case["reads"]
    lens = np.full(len(reads), reads.shape[1])
    lens[7] = 80
    kw = dict(min_score=20, traceback=traceback, both_strands=both_strands)
    want = jm.map_reads(reads, lens, index=case["jidx"], **kw)
    got = pm.map_reads(reads, lens, index=case["pidx"], device="cpu", **kw)
    _same_hits(got, want)
    assert sum(h is not None for h in got) >= 10
    assert {h.contig for h in got if h is not None} == {"contig0", "contig1"}


def test_map_reads_gotoh_and_contigs_kw_match_jax(case):
    reads = case["reads"][:16]
    kw = dict(min_score=10, traceback=True, gap_open=3, gap_extend=1, k=9,
              contig_names=["x", "y"])
    want = jm.map_reads(reads, contigs=case["contigs"], **kw)
    got = pm.map_reads(reads, contigs=case["contigs"], device="cpu", **kw)
    _same_hits(got, want)


def test_pipelined_matches_plain(case):
    reads = case["reads"]
    kw = dict(index=case["pidx"], min_score=20, both_strands=True, traceback=True,
              device="cpu")
    plain = pm.map_reads(reads, **kw)
    _same_hits(pm.map_reads_pipelined(reads, chunk_reads=16, **kw), plain)
    _same_hits(pm.map_reads_pipelined(reads, chunk_reads=64, **kw), plain)
    want = jm.map_reads_pipelined(reads, index=case["jidx"], chunk_reads=16,
                                  min_score=20, both_strands=True, traceback=True)
    _same_hits(plain, want)


def _window(idx, h, L, bw):
    return idx.ref[h.window_start: h.window_start + L + 2 * bw]


def _strand_read(reads, h):
    return revcomp(reads[h.read]) if h.strand == "-" else reads[h.read]


def _local_path(h, idx):
    """The hit's path in window coordinates."""
    local = h.window_start - int(idx.contig_starts[idx.contig_names.index(h.contig)])
    return [(y, x - local) for y, x in h.path]


@pytest.mark.parametrize("gaps", ["linear", "gotoh"])
def test_card_route_on_the_cpu_matches_the_oracles(case, gaps):
    """The card's route run on the plain tiers: screening scores per the
    fixed-corridor oracle (pads at matrix.min()), winners' scores and
    paths per the block oracle (linear) or the per-round affine oracle
    (Gotoh, which the block tier's walk does not take)."""
    idx, reads = case["pidx"], case["reads"]
    lens = np.full(len(reads), reads.shape[1])
    L, bw = reads.shape[1], 32
    g = dict(gap_open=3, gap_extend=1) if gaps == "gotoh" else {}
    params = ScoringParams(np.pad(dna_matrix(1, -1), ((0, 2), (0, 2)),
                                  constant_values=-1), g.get("gap_open", 1),
                           g.get("gap_extend", 1))
    # a batch with an in-length N goes on the raw wire, one without on the
    # 2-bit wire (8-aligned origins, windows widened to a multiple of 8)
    for rows, packed in ((reads, False), (reads[(reads < 4).all(axis=1)], True)):
        cands = pm.find_candidates(idx, rows, lens[: len(rows)])
        scores, tstart = pm.extend_candidates(idx, rows, lens[: len(rows)], cands,
                                              device="cpu", route="card", **g)
        span = -(-(L + 2 * bw + 8) // 8) * 8 if packed else L + 2 * bw
        assert len(scores) >= 5 and (not packed or (tstart % 8 == 0).all())
        for k in range(len(scores)):
            w = idx.ref[tstart[k]: tstart[k] + span]
            assert sw_banded_static_score(rows[cands.read[k]], w, params, bw) == scores[k]
    hits = pm.map_reads(reads, index=idx, min_score=20, traceback=True, device="cpu",
                        route="card", **g)
    n = 0
    for h in hits:
        if h is None:
            continue
        q, w = _strand_read(reads, h), _window(idx, h, L, bw)
        if gaps == "gotoh":
            want = banded_affine_xdrop(q, w, bandwidth=bw, **g)
        else:
            want = banded_xdrop_block(q, w, width=2 * bw, block=bw)
        assert (h.score, _local_path(h, idx)) == (want[0], want[1])
        n += 1
    assert n >= 10


@pytest.mark.parametrize("bandwidth,block_tier", [(32, True), (40, True), (48, False),
                                                  (20, False)])
def test_card_route_winner_rule(case, bandwidth, block_tier):
    """Linear winners walk on the block tier only where its geometry takes
    width 2W and block W (2W % 16 == 0, 3W <= 129), decided before any
    launch; the rest walk on the per-round band, on its oracle."""
    assert pm._route("cpu") == "cpu"
    assert pm._on_block_tier("card", None, bandwidth) == block_tier
    assert not pm._on_block_tier("cpu", None, bandwidth)
    assert not pm._on_block_tier("card", 3, bandwidth)
    idx, reads = case["pidx"], case["reads"][20:28]
    L = reads.shape[1]
    hits = pm.map_reads(reads, index=idx, min_score=20, traceback=True,
                        bandwidth=bandwidth, device="cpu", route="card")
    assert any(h is not None for h in hits)
    for h in hits:
        if h is None:
            continue
        q, w = _strand_read(reads, h), _window(idx, h, L, bandwidth)
        want = (banded_xdrop_block(q, w, width=2 * bandwidth, block=bandwidth)
                if block_tier else banded_xdrop(q, w, bandwidth=bandwidth))
        assert (h.score, _local_path(h, idx)) == (want[0], want[1])


def test_gap_open_equal_to_gap_extend_is_linear(case):
    """gap_open == gap_extend collapses to one linear gap: hits equal the
    linear call's and the per-round oracle's; JAX's off-TPU traceback
    passes ``gap`` twice there and raises TypeError."""
    idx, reads = case["pidx"], case["reads"][:24]
    L = reads.shape[1]
    with pytest.raises(TypeError, match="gap"):
        jm.map_reads(reads, index=case["jidx"], min_score=5, traceback=True,
                     gap_open=2, gap_extend=2)
    got = pm.map_reads(reads, index=idx, min_score=5, traceback=True, gap_open=2,
                       gap_extend=2, device="cpu")
    _same_hits(got, pm.map_reads(reads, index=idx, min_score=5, traceback=True,
                                 gap=2, device="cpu"))
    n = 0
    for h in got:
        if h is not None:
            want = banded_xdrop(_strand_read(reads, h), _window(idx, h, L, 32), gap=2)
            assert (h.score, _local_path(h, idx)) == (want[0], want[1])
            n += 1
    assert n >= 6


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def fasta(tmp_path_factory, case):
    d = tmp_path_factory.mktemp("map")
    reads, ref = str(d / "reads.fa"), str(d / "ref.fa")
    rows = case["reads"][:24].copy()
    write_fasta(reads, [(f"r{i}", decode_dna(x[: 100 - (i % 3)]))
                        for i, x in enumerate(rows)])
    write_fasta(ref, [(f"chr{i}", decode_dna(c)) for i, c in enumerate(case["contigs"])])
    return reads, ref


@pytest.mark.parametrize("flags", [
    "--random 20000x64x100",
    "--random 20000x64x100 --both-strands --k 11 --min-score 15",
    "FASTA --k 9 --traceback --both-strands",
    "FASTA --k 9 --cigar --gap-open 3 --gap-extend 1",
    "FASTA --k 9 --sam --both-strands",
])
def test_cli_map_matches_jax(flags, fasta):
    argv = ["map"] + flags.replace("FASTA", f"--reads {fasta[0]} --ref {fasta[1]}").split()
    want = _run(jax_cli, argv)
    got = _run(port_cli.main, argv + ["--device", "cpu"])
    assert got == want and len(got[0].splitlines()) >= 1
