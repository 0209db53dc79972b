"""The port's greedy assembler (``swtpu_torch/models/assembly.py``) and
``assemble`` CLI against the JAX package's on ``device="cpu"``: the reads
``make_reads`` tiles, the contig from clean reads, from mutated reads
with ``slack``, and from reads with in-length N (there also the screening
batch and its scores: JAX's XLA engine against the port's default
engine, ``best_engine`` on the CPU), and the CLI byte-equal to ``python
-m swtpu assemble`` on four flag sets. Seed 10000, tolerance 0."""

import contextlib
import io

import numpy as np
import pytest

from swtpu.cli import main as jax_cli
from swtpu.core.scoring import DNA_111 as JAX_111
from swtpu.kernels.xla import sw_batch_diag as jax_sw_batch_diag
from swtpu.models import assembly as jas
from swtpu_torch import cli as port_cli
from swtpu_torch.core.io import decode_dna, write_fasta
from swtpu_torch.core.scoring import DNA_111
from swtpu_torch.models import assembly as pas
from swtpu_torch.ops.variants import best_engine

SEED = 10000


def _sub_mutate(rng, seq, p):
    """Substitution-only errors (always to a different base)."""
    seq = seq.copy()
    flip = np.nonzero(rng.random(len(seq)) < p)[0]
    seq[flip] = (seq[flip] + rng.integers(1, 4, len(flip))) % 4
    return seq


def _reads(kind):
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, 900).astype(np.uint8)
    reads = pas.make_reads(rng, genome, read_len=150, step=50)
    if kind == "mutated":
        reads = [_sub_mutate(rng, r, 0.02) for r in reads]
    elif kind == "ambiguous":
        reads = [r.copy() for r in reads]
        for r in reads:
            r[rng.integers(0, len(r), 3)] = 4  # N inside every read
    return genome, reads


def test_make_reads_matches_jax():
    genome = np.random.default_rng(SEED).integers(0, 4, 1000).astype(np.uint8)
    for shuffle in (False, True):
        got = pas.make_reads(np.random.default_rng(1), genome, 120, 70, shuffle)
        want = jas.make_reads(np.random.default_rng(1), genome, 120, 70, shuffle)
        assert len(got) == len(want) and all(np.array_equal(a, b)
                                             for a, b in zip(got, want))


@pytest.mark.parametrize("kind,kw", [("clean", dict(min_overlap=30)),
                                     ("mutated", dict(min_overlap=30, slack=4)),
                                     ("ambiguous", dict(min_overlap=30, slack=4))])
def test_assemble_matches_jax(kind, kw):
    genome, reads = _reads(kind)
    want = jas.assemble_greedy(reads, **kw)
    got = pas.assemble_greedy(reads, device="cpu", **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if kind == "clean":
        assert np.array_equal(got, genome)
    assert len(got) == len(genome)


def test_screening_scores_with_n_match_jax():
    """In-length N: the screening batch (query pads 4, target pads 5) and
    its scores equal JAX's, not only the contig."""
    _, reads = _reads("ambiguous")
    seen = {}

    def jax_engine(q, t):
        seen["q"], seen["t"] = q, t
        return jax_sw_batch_diag(q, t, JAX_111)

    jas.assemble_greedy(reads, min_overlap=30, slack=4, engine=jax_engine)
    bq, bt, pairs = pas._screen_batch(reads)
    assert np.array_equal(bq, seen["q"]) and np.array_equal(bt, seen["t"])
    assert len(pairs) == len(reads) * (len(reads) - 1)
    got = best_engine(DNA_111, "cpu")(bq, bt).numpy()
    assert np.array_equal(got, np.asarray(jax_engine(bq, bt)))
    assert (bq[:, :150] == 4).any()


def test_single_and_empty():
    assert pas.assemble_greedy([], device="cpu").size == 0
    r = np.array([0, 1, 2, 3], np.uint8)
    assert np.array_equal(pas.assemble_greedy([r], device="cpu"), r)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("asm") / "reads.fa")
    _, reads = _reads("mutated")
    write_fasta(path, [(f"r{i}", decode_dna(x)) for i, x in enumerate(reads)])
    return path


@pytest.mark.parametrize("flags", [
    "--random 1000x80x30",
    "--random 1200x150x50 --min-overlap 30 --sam --scoring 2,-3 --gap 2",
    "--reads READS --slack 4 --min-overlap 30",
    "--reads READS --slack 4 --min-overlap 30 --sam",
])
def test_cli_assemble_matches_jax(flags, fasta):
    argv = ["assemble"] + flags.replace("READS", fasta).split()
    want = _run(jax_cli, argv)
    got = _run(port_cli.main, argv + ["--device", "cpu"])
    assert got == want and len(got[0].splitlines()) >= 3
