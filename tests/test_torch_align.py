"""Alignment with traceback, CIGAR/SAM and the align CLI: port vs JAX.

``swtpu_torch.batch.sw_align_batch`` (device="cpu") against
``swtpu.batch.sw_align_batch`` — identical (score, path) lists — and the
port's CIGAR/SAM strings and ``align --device cpu`` output against the
JAX package's for the same numpy inputs (seed 10000). Tolerance 0.
"""

import contextlib
import io
import json

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from swtpu.batch import sw_align_batch as jax_align
from swtpu.cli import main as jax_cli
from swtpu.core.cigar import path_to_cigar as jax_cigar
from swtpu.core.io import write_fasta
from swtpu.core.sam import sam_header as jax_sam_header
from swtpu.core.sam import sam_record as jax_sam_record
from swtpu.core.scoring import DNA_10_30_15, ScoringParams, dna_matrix
from swtpu_torch.batch import sw_align_batch as port_align
from swtpu_torch.cli import main as port_cli
from swtpu_torch.core import io as port_io
from swtpu_torch.core.cigar import cigar_stats, path_to_cigar
from swtpu_torch.core.sam import sam_header, sam_record
from swtpu_torch.core.scoring import scoring_from_numpy

SCORINGS = {
    "10_30_15": DNA_10_30_15,
    "tie_rich": ScoringParams.linear(dna_matrix(2, -1), 1),
    "affine_10_30_40_15": ScoringParams(dna_matrix(10, -30), 40, 15),
    "affine_tie_rich": ScoringParams(dna_matrix(2, -1), 3, 1),
}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def related_batch(B=24, n=48, m=56):
    """Half related pairs (target = query with substitutions and a shift),
    half random, with a query pad tail on a few rows."""
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(B, m)).astype(np.uint8)
    for b in range(B // 2):
        t = np.concatenate([rng.integers(0, 4, 3).astype(np.uint8), qs[b]])
        sub = rng.random(len(t)) < 0.1
        t[sub] = (t[sub] + 1) % 4
        ts[b, : min(m, len(t))] = t[:m]
    qs[-3:, n - 9 :] = 4
    return qs, ts


@pytest.mark.parametrize("name", list(SCORINGS))
def test_sw_align_batch_equals_jax(name):
    p = SCORINGS[name]
    qs, ts = related_batch()
    want = jax_align(qs, ts, p)
    got = port_align(qs, ts, port(p), device="cpu")
    assert got == want
    assert sum(s > 0 for s, _ in got) >= len(got) // 2


@pytest.mark.parametrize("name", ["10_30_15", "affine_10_30_40_15"])
def test_cigar_and_sam_equal_jax(name):
    p = SCORINGS[name]
    qs, ts = related_batch()
    res = port_align(qs, ts, port(p), device="cpu")
    n = qs.shape[1]
    assert sam_header([("t0", 56), ("t1", 56), ("t0", 56)]) == jax_sam_header(
        [("t0", 56), ("t1", 56), ("t0", 56)]
    )
    for b, (score, path) in enumerate(res):
        for kw in ({}, {"query_len": n}):
            assert path_to_cigar(path, qs[b], ts[b], **kw) == jax_cigar(
                path, qs[b], ts[b], **kw
            )
        assert path_to_cigar(path) == jax_cigar(path)
        assert sam_record(
            f"q{b}", f"t{b}", qs[b], ts[b], score, path, query_len=n
        ) == jax_sam_record(
            f"q{b}", f"t{b}", qs[b], ts[b], score, path, query_len=n
        )
        if score:
            st = cigar_stats(path_to_cigar(path, qs[b], ts[b], query_len=n))
            assert st["query_consumed"] == n


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


CLI_ARGS = {
    "scores": ["--random", "16x40x48", "--scoring", "10,-30", "--gap", "15"],
    "scores_affine": ["--random", "16x40x48", "--scoring", "10,-30",
                      "--gap-open", "40", "--gap-extend", "15"],
    "traceback": ["--random", "8x32x40", "--traceback"],
    "cigar": ["--random", "8x32x40", "--scoring", "2,-1", "--cigar",
              "--traceback"],
    "sam_affine": ["--random", "8x32x40", "--scoring", "10,-30",
                   "--gap-open", "40", "--gap-extend", "15", "--sam"],
}


@pytest.mark.parametrize("mode", list(CLI_ARGS))
def test_cli_align_output_equals_jax(mode):
    argv = ["align"] + CLI_ARGS[mode]
    want = _run(jax_cli, argv)
    got = _run(port_cli, argv + ["--device", "cpu"])
    assert got == want and len(got) >= 8


def test_cli_align_fasta_equals_jax(tmp_path):
    rng = np.random.default_rng(10000)
    q, t = tmp_path / "q.fa", tmp_path / "t.fa"
    write_fasta(q, [(f"q{i}", port_io.decode_dna(rng.integers(0, 4, 30 + i)))
                    for i in range(4)])
    write_fasta(t, [(f"t{i}", port_io.decode_dna(rng.integers(0, 4, 40 - i)))
                    for i in range(4)])
    argv = ["align", "--queries", str(q), "--targets", str(t),
            "--scoring", "10,-30", "--gap", "15", "--cigar"]
    assert _run(port_cli, argv + ["--device", "cpu"]) == _run(jax_cli, argv)
    assert _run(port_cli, argv[:-1] + ["--sam", "--device", "cpu"]) == _run(
        jax_cli, argv[:-1] + ["--sam"]
    )


@pytest.mark.parametrize("extra", [["q.npz", "t.fa"], ["q.npz", "t.npz"]])
def test_cli_rejects_unported_inputs(extra, tmp_path):
    extra = ["--queries", str(tmp_path / extra[0]),
             "--targets", str(tmp_path / extra[1])]
    with pytest.raises(SystemExit, match="not ported"):
        port_cli(["align", "--device", "cpu"] + extra)


def test_io_equals_jax(tmp_path):
    from swtpu.core.io import decode_dna, encode_dna, load_fasta_batch

    s = "ACGTNacgtRYacgt"
    np.testing.assert_array_equal(port_io.encode_dna(s), encode_dna(s))
    assert port_io.decode_dna(encode_dna(s)) == decode_dna(encode_dna(s))
    p = tmp_path / "x.fa"
    port_io.write_fasta(p, [("a b", "ACGTAC"), ("c", "GGNT"), ("d", "")])
    got = port_io.load_fasta_batch(str(p), pad_to=4, pad_code=5)
    want = load_fasta_batch(str(p), pad_to=4, pad_code=5)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
