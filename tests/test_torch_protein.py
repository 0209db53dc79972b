"""Protein in the port vs the JAX package: alphabet and BLOSUM62, FASTA,
SAM, alignment with traceback and ``align --alphabet protein``.

``swtpu_torch.core.protein`` / ``core.io`` / ``core.sam`` against their
``swtpu`` counterparts, ``swtpu_torch.batch.sw_align_batch``
(device="cpu") against ``swtpu.batch.sw_align_batch`` on related protein
pairs with pad tails, and ``python -m swtpu_torch align --alphabet
protein --device cpu`` against ``python -m swtpu align``. Same numpy
inputs (seed 10000), tolerance 0.
"""

import contextlib
import io

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from swtpu.batch import sw_align_batch as jax_align
from swtpu.cli import main as jax_cli
from swtpu.core import protein as jax_protein
from swtpu.core.io import load_fasta_batch as jax_load_fasta_batch
from swtpu.core.io import write_fasta
from swtpu.core.sam import sam_record as jax_sam_record
from swtpu.core.scoring import ScoringParams
from swtpu_torch.batch import sw_align_batch as port_align
from swtpu_torch.cli import main as port_cli
from swtpu_torch.core import io as port_io
from swtpu_torch.core import protein as port_protein
from swtpu_torch.core.cigar import cigar_stats, path_to_cigar
from swtpu_torch.core.sam import sam_record
from swtpu_torch.core.scoring import ScoringParams as PortParams
from swtpu_torch.core.scoring import scoring_from_numpy

BLOSUM62 = jax_protein.BLOSUM62
SCORINGS = {
    "linear11": ScoringParams.linear(BLOSUM62, 11),
    "gotoh11_1": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1),
    "tie_rich_linear1": ScoringParams.linear(BLOSUM62, 1),
    "dna_general_gotoh3_1": ScoringParams(
        np.array([[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2],
                  [-2, -1, -2, 3]]), gap_open=3, gap_extend=1,
    ),
}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def test_protein_module_equals_jax():
    assert port_protein.PROTEIN_ALPHABET == jax_protein.PROTEIN_ALPHABET
    assert (port_protein.PROTEIN_Q_PAD, port_protein.PROTEIN_T_PAD) == (
        jax_protein.PROTEIN_Q_PAD, jax_protein.PROTEIN_T_PAD) == (24, 25)
    np.testing.assert_array_equal(port_protein.BLOSUM62, jax_protein.BLOSUM62)
    assert port_protein.BLOSUM62.dtype == np.int32
    s = "ARNDCQEGHILKMFPSTWYVBZX*acdw"
    np.testing.assert_array_equal(port_protein.encode_protein(s),
                                  jax_protein.encode_protein(s))
    codes = jax_protein.encode_protein(s)
    assert port_protein.decode_protein(codes) == jax_protein.decode_protein(codes)
    np.testing.assert_array_equal(
        port_protein.random_protein(np.random.default_rng(10000), (3, 50)),
        jax_protein.random_protein(np.random.default_rng(10000), (3, 50)),
    )
    for args in ((), (10, 2)):
        got, want = port_protein.blosum62_params(*args), jax_protein.blosum62_params(*args)
        assert isinstance(got, PortParams)
        np.testing.assert_array_equal(got.matrix, want.matrix)
        assert (got.gap_open, got.gap_extend) == (want.gap_open, want.gap_extend)
    for fn in (port_protein.encode_protein, jax_protein.encode_protein):
        with pytest.raises(KeyError):
            fn("ACJ")


def test_protein_fasta_and_sam_equal_jax(tmp_path):
    p = tmp_path / "p.fa"
    write_fasta(p, [("sp1 desc", "MKTAYIAKQR"), ("sp2", "acdefghik"),
                    ("sp3", "WYVBZX*")])
    for args, kw in (((str(p), "protein"), {}),
                     ((str(p), "protein"), dict(pad_to=16, pad_code=25)),
                     ((str(p),), dict(alphabet="protein", pad_code=24))):
        got = port_io.load_fasta_batch(*args, **kw)
        want = jax_load_fasta_batch(*args, **kw)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    bad = tmp_path / "bad.fa"
    write_fasta(bad, [("x", "MKJ")])
    for fn in (port_io.load_fasta_batch, jax_load_fasta_batch):
        with pytest.raises(KeyError):
            fn(str(bad), "protein")
    q = jax_protein.encode_protein("MKTAYIAKQR")
    t = jax_protein.encode_protein("MKTAYLAKQR")
    path = [(2, 2), (3, 3), (4, 4), (5, 5), (6, 6)]
    for args, kw in (((), {}), (("protein",), dict(query_len=10)),
                     ((), dict(alphabet="protein", flag=16, mapq=7))):
        assert sam_record("q", "t", q, t, 21, path, *args, **kw) == (
            jax_sam_record("q", "t", q, t, 21, path, *args, **kw))
    assert sam_record("q", "t", q, t, 0, [], "protein").split("\t")[9] == (
        "MKTAYIAKQR")


def related_protein_batch(B=20, n=48, m=56):
    """Half related pairs (target = query with substitutions, a shift and
    a deletion), half random; query and target pad tails on some rows."""
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 20, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, 20, size=(B, m)).astype(np.uint8)
    for b in range(B // 2):
        t = np.concatenate([rng.integers(0, 20, 3).astype(np.uint8), qs[b]])
        sub = rng.random(len(t)) < 0.1
        t[sub] = rng.integers(0, 20, int(sub.sum()))
        t = np.delete(t, int(rng.integers(5, len(t) - 5)))
        ts[b, : min(m, len(t))] = t[:m]
    qs[-4:, n - 9:] = 24
    ts[-3:, m - 7:] = 25
    return qs, ts


@pytest.mark.parametrize("name", list(SCORINGS))
def test_sw_align_batch_equals_jax(name):
    p = SCORINGS[name]
    qs, ts = related_protein_batch()
    if p.alphabet_size == 4:
        qs, ts = qs % 4, ts % 4
        qs[-4:, -9:], ts[-3:, -7:] = 4, 5
    want = jax_align(qs, ts, p)
    got = port_align(qs, ts, port(p), device="cpu")
    assert got == want
    assert sum(s > 0 for s, _ in got) >= len(got) // 2
    for b, (score, path) in enumerate(got):
        if score:
            st = cigar_stats(path_to_cigar(path, qs[b], ts[b],
                                           query_len=qs.shape[1]))
            assert st["query_consumed"] == qs.shape[1]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


CLI_ARGS = {
    "scores": ["--random", "12x40x48", "--gap", "11"],
    "scores_gotoh": ["--random", "12x40x48", "--gap-open", "11",
                     "--gap-extend", "1"],
    "cigar": ["--random", "8x32x40", "--gap", "11", "--cigar"],
    "traceback_gotoh": ["--random", "8x32x40", "--gap-open", "11",
                        "--gap-extend", "1", "--traceback", "--cigar"],
    "sam_gotoh": ["--random", "8x32x40", "--gap-open", "11", "--gap-extend",
                  "1", "--sam"],
}


@pytest.mark.parametrize("mode", list(CLI_ARGS))
def test_cli_align_protein_equals_jax(mode):
    argv = ["align", "--alphabet", "protein"] + CLI_ARGS[mode]
    want = _run(jax_cli, argv)
    got = _run(port_cli, argv + ["--device", "cpu"])
    assert got == want and len(got) >= 8


def test_cli_align_protein_fasta_equals_jax(tmp_path):
    rng = np.random.default_rng(10000)
    q, t = tmp_path / "q.fa", tmp_path / "t.fa"
    dec = port_protein.decode_protein
    write_fasta(q, [(f"q{i}", dec(rng.integers(0, 24, 30 + i))) for i in range(4)])
    write_fasta(t, [(f"t{i}", dec(rng.integers(0, 24, 40 - 3 * i))) for i in range(4)])
    argv = ["align", "--alphabet", "protein", "--queries", str(q),
            "--targets", str(t), "--gap-open", "11", "--gap-extend", "1"]
    for extra in ([], ["--cigar"], ["--sam"]):
        got = _run(port_cli, argv + extra + ["--device", "cpu"])
        assert got == _run(jax_cli, argv + extra) and len(got) >= 4
