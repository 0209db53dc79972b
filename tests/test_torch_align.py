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
    """The 2-bit .npz container is DNA-only: with --alphabet protein both
    CLIs exit with the same message before reading anything."""
    argv = ["align", "--alphabet", "protein",
            "--queries", str(tmp_path / extra[0]),
            "--targets", str(tmp_path / extra[1])]
    with pytest.raises(SystemExit) as want:
        jax_cli(argv)
    with pytest.raises(SystemExit, match="DNA-only") as got:
        port_cli(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def _reads(tmp_path, rng, prefix, lengths, with_n=True):
    """A DNA FASTA with lowercase letters and, ``with_n``, an N inside
    some reads."""
    path = tmp_path / f"{prefix}.fa"
    recs = []
    for i, n in enumerate(lengths):
        s = list(port_io.decode_dna(rng.integers(0, 4, n)))
        if with_n and i % 3 == 0:
            s[n // 2] = "N"
        if i % 4 == 1:
            s[0] = s[0].lower()
        recs.append((f"{prefix}{i}", "".join(s)))
    write_fasta(path, recs)
    return path


@pytest.fixture
def npz_inputs(tmp_path):
    """Queries and targets as FASTA and as .npz packed by the port's
    ``pack`` subcommand."""
    rng = np.random.default_rng(10000)
    out = {}
    for with_n in (True, False):
        q = _reads(tmp_path, rng, f"q{int(with_n)}", [30, 37, 41, 29, 33, 40],
                   with_n)
        t = _reads(tmp_path, rng, f"t{int(with_n)}", [45, 38, 52, 47, 31, 50],
                   with_n)
        for fa in (q, t):
            _run(port_cli, ["pack", str(fa), str(fa.with_suffix(".npz"))])
        out[with_n] = q, t
    return out


NPZ_MODES = {
    "scores": ["--scoring", "10,-30", "--gap", "15"],
    "cigar": ["--scoring", "2,-1", "--gap", "1", "--cigar"],
    "sam": ["--scoring", "10,-30", "--gap-open", "40", "--gap-extend", "15",
            "--sam"],
}


@pytest.mark.parametrize("inputs", ["npz_npz", "npz_fa"])
@pytest.mark.parametrize("mode", list(NPZ_MODES))
def test_cli_align_npz_equals_jax(npz_inputs, mode, inputs):
    # in-length N in the score-only mode; the host walkers of both packages
    # cannot index one (ROADMAP.md, queue C)
    q, t = npz_inputs[mode == "scores"]
    tq = t.with_suffix(".npz") if inputs == "npz_npz" else t
    argv = ["align", "--queries", str(q.with_suffix(".npz")),
            "--targets", str(tq)] + NPZ_MODES[mode]
    got = _run(port_cli, argv + ["--device", "cpu"])
    assert got == _run(jax_cli, argv) and len(got) >= 6
    # the container scores as its FASTA does
    fasta = ["align", "--queries", str(q), "--targets", str(t)] + NPZ_MODES[mode]
    assert got == _run(port_cli, fasta + ["--device", "cpu"])


def test_cli_pack_equals_jax(tmp_path):
    from swtpu.core.io import load_packed_batch as jax_load

    rng = np.random.default_rng(10000)
    fa = _reads(tmp_path, rng, "r", [9, 1, 30, 17, 64])
    out = str(tmp_path / "r.npz")
    want = _run(jax_cli, ["pack", str(fa), out])
    want_batch = jax_load(out)
    got = _run(port_cli, ["pack", str(fa), out])
    assert got == want and json.loads(got[0])["records"] == 5
    got_batch = jax_load(out)
    assert got_batch[0] == want_batch[0]
    for g, w in zip(got_batch[1:], want_batch[1:]):
        np.testing.assert_array_equal(g, w)
    back_port, back_jax = tmp_path / "port.fa", tmp_path / "jax.fa"
    got = _run(port_cli, ["pack", out, str(back_port), "--unpack"])
    want = _run(jax_cli, ["pack", out, str(back_jax), "--unpack"])
    assert [json.loads(x)["records"] for x in got] == [5]
    assert got[0].replace(str(back_port), "") == want[0].replace(str(back_jax), "")
    assert back_port.read_text() == back_jax.read_text()
    assert "N" in back_port.read_text()  # in-length N survives the round trip


ENGINES_AS_JAX = ["oracle", "xla_diag", "xla", "colscan", "no_such_engine"]
# JAX runs these as Pallas kernels, which need a TPU or interpret mode
ENGINES_AS_ORACLE = {
    "rowscan_bf16": ["--scoring", "10,-30", "--gap", "15"],
    "rowscan_bf16_outside_guard": ["--scoring", "3,-1", "--gap", "1"],
    "wavefront": ["--scoring", "10,-30", "--gap", "15"],
    "rowscan": ["--scoring", "2,-1", "--gap", "1"],
    "rowscan_prof": ["--scoring", "2,-1", "--gap", "1"],
}


@pytest.mark.parametrize("engine", ENGINES_AS_JAX)
def test_cli_engine_equals_jax(engine):
    argv = ["align", "--random", "12x40x48", "--scoring", "10,-30",
            "--gap", "15", "--engine", engine]
    got = _run(port_cli, argv + ["--device", "cpu"])
    assert got == _run(jax_cli, argv) and len(got) == 12


@pytest.mark.parametrize("case", list(ENGINES_AS_ORACLE))
def test_cli_engine_prints_the_oracle(case):
    from swtpu_torch.oracle import sw_score_batch

    argv = ["align", "--random", "12x90x96", "--engine", case.split("_outside")[0],
            "--device", "cpu"] + ENGINES_AS_ORACLE[case]
    recs = [json.loads(x) for x in _run(port_cli, argv)]
    rs = np.random.default_rng(10000)  # the CLI's default --seed
    qs = rs.integers(0, 4, size=(12, 90)).astype(np.uint8)
    ts = rs.integers(0, 4, size=(12, 96)).astype(np.uint8)
    match, mismatch = (int(x) for x in ENGINES_AS_ORACLE[case][1].split(","))
    want = sw_score_batch(qs, ts, port(ScoringParams.linear(
        dna_matrix(match, mismatch), int(ENGINES_AS_ORACLE[case][3]))))
    assert [r["score"] for r in recs] == want.tolist()


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
