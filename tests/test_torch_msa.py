"""The port's center-star MSA (``swtpu_torch/models/msa.py``) and ``msa``
CLI against the JAX package's on ``device="cpu"``: the rows, the center,
the scores against the center and the sum-of-pairs score under linear,
Gotoh and protein BLOSUM62 scoring, the ``center=`` override, a single
sequence, the hand-checked tiny example, and the CLI's stdout and stderr
byte-equal to ``python -m swtpu msa`` on five flag sets. Seed 10000,
tolerance 0."""

import contextlib
import io

import numpy as np
import pytest

from swtpu.cli import main as jax_cli
from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu.models import msa as jmsa
from swtpu_torch import cli as port_cli
from swtpu_torch.core.encode import mutate
from swtpu_torch.core.io import decode_dna, encode_dna, write_fasta
from swtpu_torch.core.protein import BLOSUM62, decode_protein
from swtpu_torch.core.scoring import ScoringParams, dna_matrix
from swtpu_torch.models import msa as pmsa

SEED = 10000


def _same(got, want):
    assert got.center == want.center and got.sp == want.sp
    assert np.array_equal(got.scores, want.scores)
    assert len(got.rows) == len(want.rows)
    assert all(np.array_equal(a, b) for a, b in zip(got.rows, want.rows))


def _family(rng, n, L, letters=4):
    anc = rng.integers(0, letters, L).astype(np.uint8)
    if letters == 4:
        return [mutate(rng, anc) for _ in range(n)]
    out = []
    for _ in range(n):  # protein: substitutions and single deletions
        s = np.where(rng.random(L) < 0.15, rng.integers(0, letters, L), anc)
        out.append(np.delete(s, rng.integers(0, L, 2)).astype(np.uint8))
    return out


@pytest.mark.parametrize("scoring", ["linear", "gotoh", "blosum62", "blosum62_linear",
                                     "dna_general"])
def test_msa_matches_jax(scoring):
    rng = np.random.default_rng(SEED)
    protein = scoring.startswith("blosum")
    seqs = _family(rng, 7, 60, 20 if protein else 4)
    params = {
        "linear": ScoringParams.linear(dna_matrix(2, -3), 2),
        "gotoh": ScoringParams(dna_matrix(2, -3), gap_open=4, gap_extend=1),
        "blosum62": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1),
        "blosum62_linear": ScoringParams.linear(BLOSUM62, 4),
        "dna_general": ScoringParams.linear(
            np.array([[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2],
                      [-2, -1, -2, 3]]), 2),
    }[scoring]
    want = jmsa.msa_center_star(
        seqs, params=JaxScoring(params.matrix, params.gap_open, params.gap_extend))
    got = pmsa.msa_center_star(seqs, params=params, device="cpu")
    _same(got, want)
    alpha = "protein" if protein else "dna"
    assert (pmsa.msa_rows_to_strings(got.rows, alpha)
            == jmsa.msa_rows_to_strings(want.rows, alpha))
    if params.is_linear:
        assert pmsa.sp_score(got.rows, params) == got.sp


@pytest.mark.parametrize("kw", [dict(), dict(match=2, mismatch=3, gap=2),
                                dict(gap_open=3, gap_extend=1)])
def test_msa_keywords_match_jax(kw):
    rng = np.random.default_rng(SEED)
    seqs = _family(rng, 6, 48)
    _same(pmsa.msa_center_star(seqs, device="cpu", **kw), jmsa.msa_center_star(seqs, **kw))


def test_center_override_single_and_tiny():
    seqs = [encode_dna(s) for s in ["ACGT", "AGT", "ACT"]]
    got = pmsa.msa_center_star(seqs, device="cpu")
    _same(got, jmsa.msa_center_star(seqs))
    assert pmsa.msa_rows_to_strings(got.rows) == ["ACGT", "A-GT", "AC-T"]
    assert got.center == 0 and got.sp == 4
    for c in range(3):
        _same(pmsa.msa_center_star(seqs, center=c, device="cpu"),
              jmsa.msa_center_star(seqs, center=c))
    _same(pmsa.msa_center_star(seqs[:1], device="cpu"), jmsa.msa_center_star(seqs[:1]))
    with pytest.raises(ValueError, match="non-empty"):
        pmsa.msa_center_star([seqs[0], seqs[0][:0]], device="cpu")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("msa")
    rng = np.random.default_rng(SEED)
    dna, prot = str(d / "dna.fa"), str(d / "prot.fa")
    write_fasta(dna, [(f"s{i}", decode_dna(x)) for i, x in enumerate(_family(rng, 5, 40))])
    write_fasta(prot, [(f"p{i}", decode_protein(x))
                       for i, x in enumerate(_family(rng, 5, 40, 20))])
    return dna, prot


@pytest.mark.parametrize("flags", [
    "--random 6x50",
    "--random 5x40 --scoring 2,-3 --gap-open 4 --gap-extend 1",
    "--random 4x40 --alphabet protein --gap-open 11 --gap-extend 1",
    "--queries DNA --center s3 --gap 2",
    "--queries PROT --alphabet protein --gap 4",
])
def test_cli_msa_matches_jax(flags, fasta):
    argv = ["msa"] + flags.replace("DNA", fasta[0]).replace("PROT", fasta[1]).split()
    want = _run(jax_cli, argv)
    got = _run(port_cli.main, argv + ["--device", "cpu"])
    assert got == want and got[0].count(">") >= 4 and '"sp_score"' in got[1]
