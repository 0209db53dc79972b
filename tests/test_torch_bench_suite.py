"""The port's benchmark suite (``swtpu_torch.bench_suite``, ``python -m
swtpu_torch bench``) against the JAX package's (``swtpu.bench_suite``).

- ``_inputs`` is byte-equal to JAX's and ``variance_summary`` gives
  JAX's rows on the same numpy-made records;
- the suite's ``kernel`` names at full size are the names of JAX's TPU
  runs (``BENCHSUITE_r05_*.txt``) and cover every name in JAX's source;
- every section run on the CPU at the test's size table (``SIZES``
  shrunk), by both routes (the card's records through the plain
  versions, the CPU's records), emits the names the table predicts,
  JAX's record keys in JAX's order (those of the r05 runs) and a true
  parity field wherever it has one; the children (the 16K section, the
  ``torchrun`` worlds of the dist curve) run at the same table;
- ``bench`` parses as JAX's ``bench`` does and hands what follows it to
  ``bench_suite.main``; a failed child raises; without a card and
  without ``--device cpu`` the suite raises.

Seed 10000 (the suite's own), tolerance 0.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from swtpu import bench_suite as jax_bs
from swtpu import cli as jax_cli
from swtpu_torch import bench_suite as bs
from swtpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent
SEED = 10000

#: the test's size table: every section in a few seconds on the CPU
TINY = {
    "sw_len": 32, "sw_pairs": 16, "sw_oracle_pairs": 4, "sw_wavefront_pairs": 8,
    "band_len": 64, "band_pairs": 4, "block_wide_pairs": 6, "fixed_pairs": 2,
    "fixed_1m_pairs": 48, "fixed_1m_chunk": 32, "fixed_1m_len": 32, "l16_card": 192, "l16_cpu": 160,
    "b16": 2, "b16_wide": 3, "varlen_pairs": 64, "varlen_len": 60,
    "varlen_window": 64, "traceback_sample": 4, "unpack_seqs": 100, "unpack_reps": 2,
    "unpack_device_rows": 16, "unpack_device_len": 64, "swissprot_queries": 2,
    "swissprot_targets": 3, "swissprot_buckets": 2, "swissprot_qlen": 24,
    "search_chunk": 32, "search_targets": 96, "search_e2e_chunk": 32,
    "map_genome": 5000, "map_reads": 8, "msa_seqs": 4, "msa_len": 32, "msa_n256": 6,
    "dist_pairs": 8, "dist_targets": 16, "dist_qlen": 128, "dist_tlen": 128,
    "forever_pairs": 8,
}


def _jax_runs():
    """{kernel: [its record's keys]} of JAX's TPU runs (r05)."""
    keys = {}
    for name in ("BENCHSUITE_r05_all.txt", "BENCHSUITE_r05_dist.txt"):
        for line in (ROOT / name).read_text().splitlines():
            if line.startswith("JSON: "):
                rec = json.loads(line[len("JSON: "):])
                keys.setdefault(rec["kernel"], list(rec))
    return keys


JAX_RUNS = _jax_runs()
#: a name of JAX's r05 run its source no longer emits (a one-off row)
NOT_IN_JAX_SOURCE = {"search_e2e_wall_c32k"}


def _jax_keys(kernel):
    """JAX's keys for a record: by name, with a batch in the name taken
    as any batch; JAX's CPU-only tier row has its loop's keys."""
    for name, keys in JAX_RUNS.items():
        if re.sub(r"_b\d+$", "_b", name) == re.sub(r"_b\d+$", "_b", kernel):
            return keys
    if kernel == "banded_affine_xdrop_32_70_xla":
        return JAX_RUNS["banded_xdrop_32_70_xla"]
    raise KeyError(kernel)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(bs, "SIZES", {k: (v, v) for k, v in TINY.items()})
    assert set(TINY) == set(bs.SIZES)


def _check(recs, section, card, **kw):
    names = [r["kernel"] for r in recs]
    assert names == bs.expected_kernels(section, card=card, **kw)
    for r in recs:
        assert list(r) == _jax_keys(r["kernel"]), r["kernel"]
        assert all(r.get(f) is not False for f in bs.PARITY_FIELDS), r
        if "device" in r:
            assert r["device"] == "cpu"


@pytest.mark.parametrize("shape", [(4, 8, 12), (64, 128, 128)])
def test_inputs_match_jax(shape):
    for got, want in zip(bs._inputs(*shape), jax_bs._inputs(*shape)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_variance_summary_matches_jax(capsys):
    rng = np.random.default_rng(SEED)
    runs = [[dict(kernel=k, wall_ms=float(rng.integers(1, 100)),
                  gcups=float(rng.random()), batch=8, parity=True,
                  ms_per_1m=int(rng.integers(0, 3)))
             for k in ("a", "b", "c")] for _ in range(3)]
    got = bs.variance_summary(runs)
    want = jax_bs.variance_summary(runs)
    assert got == want
    out = capsys.readouterr().out.splitlines()
    assert out[: len(got)] == out[len(got):]


def test_full_size_names_are_jax_run_names():
    """The card's names at full size are those of JAX's TPU runs; every
    literal name in JAX's source is a name of one route or the other."""
    card = bs.expected_kernels("all", card=True)
    assert len(card) == len(set(card)) == 58
    assert set(card) == {k for k in JAX_RUNS if not k.startswith("dist_")} - NOT_IN_JAX_SOURCE
    dist = bs.expected_kernels("dist", cpu_mesh=8)
    assert len(dist) == 3 * 5 + 2
    assert set(dist) == {k for k in JAX_RUNS if k.startswith("dist_")}
    source = (ROOT / "swtpu" / "bench_suite.py").read_text()
    literal = set(re.findall(
        r'(?<![\w{])"((?:sw|banded|affine|semiglobal|protein|varlen|search|map|msa|'
        r'unpack|dist)_[a-z0-9_\-]*)"', source))
    literal -= {"semiglobal_full"}  # a suite's name, not a record's
    ours = set(card) | set(bs.expected_kernels("all", card=False)) | set(dist)
    assert literal and literal <= ours
    quick = bs.expected_kernels("all", card=True, quick=True)
    assert "banded_fixed_1m_128x128_w32" not in quick
    assert "msa_center_star_n256" not in quick
    assert "banded_block_16k_traceback_e2e_b128" not in quick


FAST = ("sw", "semiglobal_full", "affine", "protein", "swissprot", "varlen", "search",
        "map", "msa", "unpack")


@pytest.mark.parametrize("route", ["card", "cpu"])
def test_sections_emit_jax_names_and_keys(tiny, route, capsys):
    card = route == "card"
    for section in FAST:
        recs = bs.BENCHES[section](False, "cpu", route)
        _check(recs, section, card)
    out = capsys.readouterr().out
    assert out.count("JSON: ") == len(bs.expected_kernels("all", card=card)) - len(
        bs.expected_kernels("semiglobal", card=card))


@pytest.mark.parametrize("route", ["card", "cpu"])
def test_banded_section_and_its_16k_child(tiny, route, monkeypatch):
    """The banded section, with the 16K tracebacks in a fresh process at
    this size table (the CPU's route; the card's route runs them here: a
    child picks its route from its device)."""
    card = route == "card"
    if card:
        monkeypatch.setattr(bs, "_subprocess_records", lambda argv, **kw: (
            bs.bench_semiglobal_16k("--quick" in argv, "cpu", "card")))
    recs = bs.bench_semiglobal(False, "cpu", route)
    _check(recs, "semiglobal", card)
    by = {r["kernel"]: r for r in recs}
    assert by["banded_16k_traceback_e2e"]["seq_len"] == TINY["l16_card" if card else "l16_cpu"]
    assert by["banded_16k_traceback_e2e"]["decode_mode"] == "native"


def test_dist_anchor_and_torchrun_curve(tiny):
    """The anchor in a world of one started and ended here, the curve in
    torchrun gloo worlds of 1 and 2 ranks; efficiencies from the 1-rank
    world, the fixed-work pair from the two worlds."""
    import torch.distributed as dist

    recs = bs.bench_dist(False, "cpu", "card", cpu_mesh=2)
    assert not dist.is_initialized()
    _check(recs, "dist", True, cpu_mesh=2)
    assert [r["virtual"] for r in recs] == [False] * 3 + [True] * 8
    assert [r["devices"] for r in recs[3:9]] == [1, 1, 1, 2, 2, 2]
    assert all(r["efficiency_vs_1dev"] == 1.0 for r in recs[3:6])
    assert all(isinstance(r["efficiency_vs_1dev"], float) for r in recs[6:9])
    assert recs[8]["shape"] == f"{2 * TINY['dist_qlen']}x{TINY['dist_tlen']}"
    for r in recs[9:]:
        assert abs(r["ratio"] - r["wall_ddev_ms"] / r["wall_1dev_ms"]) < 0.01


def test_bench_parses_as_jax_bench(monkeypatch):
    """``bench --quick`` means what JAX's does; ``bench`` takes the
    suite's flags (JAX's plus ``--device``) and hands them on as given."""
    assert jax_cli.build_parser().parse_args(["bench", "--quick"]).quick is True
    got = cli.build_parser().parse_args(["bench", "--quick"])
    assert got.quick is True and got.suite == "all" and got.device == "cuda"
    seen = []
    monkeypatch.setattr(bs, "main", lambda argv=None: seen.append(argv))
    argv = ["--device", "cpu", "--quick", "--suite", "dist", "--cpu-mesh", "2",
            "--runs", "3"]
    cli.main(["bench"] + argv)
    assert seen == [argv]
    # JAX's --suite choices and flags, plus --device
    source = (ROOT / "swtpu" / "bench_suite.py").read_text()
    main = source[source.index("def main("):]
    block = main[main.index('"--suite"'):main.index('"--cpu-mesh"')]
    assert re.findall(r'"(\w+)"', block.split("choices=")[1]) == list(bs.SUITES)
    jax_flags = set(re.findall(r'add_argument\(\s*"(--[\w-]+)"', source))
    ours = {a for act in bs.build_parser()._actions for a in act.option_strings
            if a.startswith("--")}
    assert jax_flags | {"--device", "--launches", "--help"} == ours


def test_main_on_the_cpu_writes_records_and_launches(tiny, tmp_path, capsys):
    path = tmp_path / "launches.json"
    bs.main(["--device", "cpu", "--suite", "unpack", "--runs", "2",
             "--launches", str(path)])
    out = capsys.readouterr().out
    final = json.loads(out[out.index("\n[") + 1:])
    assert [r["kernel"] for r in final] == ["unpack_2bit_host", "unpack_2bit_device"] * 2 + [
        "unpack_2bit_host", "unpack_2bit_device"]
    assert final[-1]["runs"] == 2
    assert json.loads(path.read_text()) == {"by_record": {}}  # no kernel on the CPU
    counts = bs.launch_counts()
    assert {"sw_batch.sw_batch.launches", "banded_batch.banded_batch.launches_w32_w64",
            "device_walk.xdrop_walk.launches",
            "longpair_strip.tile_strip_linear.launches"} <= set(counts)


def test_failed_child_raises(tiny):
    with pytest.raises(RuntimeError, match="failed"):
        bs._subprocess_records(["--suite", "no-such-section"])


def test_without_a_card_the_suite_raises(tiny, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    for argv in (["--suite", "affine"], ["--suite", "dist"], ["--forever", "rowscan"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            bs.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["bench", "--quick"])
    for fn in list(bs.BENCHES.values()) + [bs.bench_semiglobal_16k, bs.bench_dist]:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(True)
    assert capsys.readouterr().out == ""
