"""swtpu_torch stands alone and runs on the card unless asked otherwise.

- importing every port module loads neither JAX nor the JAX package;
- no port source (nor chip_smoke.py) imports jax, swtpu or swtpu.*;
- without a card, every public entry called without ``device`` raises
  instead of running on the CPU, and launches nothing;
- on a CUDA device the dispatch picks a kernel wrapper (row-scan for a
  uniform matrix, profile for any other), never the plain tier, and
  scoring no kernel takes raises; ``align --engine`` picks its engine
  from the guard predicates (checked with the card's presence faked and
  the wrappers replaced, so nothing runs);
- on a CUDA device semi-global and global alignment (the entry points,
  the wrappers and the ``semiglobal`` / ``global`` CLI) launch the
  semi-global kernel, uniform for scalars and profile for ``params=``,
  never the plain tier, and scoring it does not take raises (checked
  with the card faked and the launch replaced by a recorder);
- likewise banded alignment: ``banded_static_align_batch`` and ``banded
  --fixed`` launch the fixed-band kernel (uniform form for a uniform
  matrix, profile form for any other), ``banded_forward_batch``,
  ``banded_align_batch`` and ``banded`` the per-round kernel at every
  bandwidth up to 128, never the plain tiers; scoring or widths the
  kernels do not take raise; the block tier's entry points and
  ``banded --block-adaptive`` raise without a card too;
- likewise long pairs and the wavefront: ``longpair_sw_score`` /
  ``_ends`` / ``_align`` and the ``longpair`` CLI sweep through the strip
  tile's kernel wrappers, never the plain tile, and ``sw_wavefront`` and
  ``align --engine wavefront`` launch the wavefront kernel; ``colscan``
  (a plain tier) runs ``best_engine``'s kernel there;
- likewise search and its statistics: ``all_vs_all_topk``,
  ``calibrate_stats``, ``resolve_stats`` and the ``search`` CLI raise
  without a card;
- likewise the mesh and the harnesses: ``make_mesh``,
  ``init_distributed``, ``data_parallel_scores``,
  ``sharded_all_vs_all_topk``, ``run_fuzz``, ``run_selftest``,
  ``profile_trace``, the benchmark suite (``bench_suite.main``,
  ``bench_dist``) and ``longpair --devices 1`` / ``selftest`` / ``fuzz`` /
  ``bench`` raise without a card (the mesh worker script of the tests imports
  neither jax nor swtpu either);
- likewise the models: ``map_reads``, ``extend_candidates``,
  ``msa_center_star``, ``assemble_greedy`` and the ``map`` / ``msa`` /
  ``assemble`` CLI raise without a card; on a CUDA device the mapper's
  raw-wire screening launches the fixed-band kernel and its adaptive
  screening the per-round kernel, never the plain tiers;
- the package-level names of the JAX package's ``__init__`` files are
  exported by the port's, and importing them loads neither JAX nor the
  JAX package.
"""

import json
import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu_torch import bench, bench_suite, cli, fuzz, selftest
from swtpu_torch.batch import bucketing, promote
from swtpu_torch.batch import traceback as port_traceback
from swtpu_torch.core import io as port_io
from swtpu_torch.core import stats
from swtpu_torch.core.scoring import DNA_10_30_15, ScoringParams, dna_matrix
from swtpu_torch.kernels import (
    _build,
    affine_scan,
    banded_batch,
    banded_block,
    banded_scan,
    colscan,
    device_walk,
    longpair_strip,
    semiglobal_batch,
    semiglobal_profile,
    semiglobal_scan,
    sw_affine,
    sw_banded,
    sw_batch,
    sw_bf16,
    sw_profile,
    sw_scan,
    sw_wavefront,
)
from swtpu_torch.models import assembly as port_assembly
from swtpu_torch.models import mapper as port_mapper
from swtpu_torch.models import msa as port_msa
from swtpu_torch.ops import variants
from swtpu_torch.parallel import longpair, search
from swtpu_torch.parallel import mesh as port_mesh
from swtpu_torch.utils import device as port_device
from swtpu_torch.utils import obs
from swtpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "swtpu_torch"
AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
GENERAL = ScoringParams.linear(np.arange(16).reshape(4, 4) - 8, 2)
GENERAL_AFF = ScoringParams(np.arange(16).reshape(4, 4) - 8, 3, 1)
WRAPPERS = [sw_batch.sw_batch, sw_batch.sw_batch_ends,
            sw_affine.sw_affine, sw_affine.sw_affine_ends,
            sw_profile.sw_profile, sw_profile.sw_profile_ends,
            sw_bf16.sw_bf16, semiglobal_batch.semiglobal_batch,
            semiglobal_profile.semiglobal_profile, sw_banded.sw_banded_static,
            sw_banded.sw_banded_profile, banded_batch.banded_batch,
            banded_block.block_gather, banded_block.block_rows,
            banded_block.block_forward, device_walk.block_walk, device_walk.xdrop_walk,
            longpair_strip.tile_strip_linear, longpair_strip.tile_strip_affine,
            sw_wavefront.sw_wavefront]
STRIP_WRAPPERS = (longpair_strip.tile_strip_linear, longpair_strip.tile_strip_affine)


def _module_names():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], "swtpu_torch.")
    )


def test_importing_every_module_loads_no_jax_and_no_swtpu():
    code = (
        "import importlib, json, sys\n"
        f"names = {json.dumps(_module_names())}\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'swtpu' or m.startswith('swtpu.')]\n"
        "print(json.dumps([len(names), bad]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300, check=True,
    ).stdout
    n_mods, bad = json.loads(out.strip().splitlines()[-1])
    assert n_mods >= 20
    assert bad == []


_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|swtpu)(?:[.\s,]|$)|from\s+(?:jax|swtpu)(?:[.\s]))"
    r"|import_module\(\s*['\"](?:jax|swtpu)(?:[.'\"])"
    r"|__import__\(\s*['\"](?:jax|swtpu)(?:[.'\"])",
    re.M,
)


def test_sources_import_no_jax_and_no_swtpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "_torch_mesh_worker.py"]
    assert len(files) >= 20
    hits = []
    for f in files:
        for m in _FORBIDDEN.finditer(f.read_text()):
            hits.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert hits == []
    # the pattern matches the full names, not the swtpu_torch prefix
    assert _FORBIDDEN.search("from swtpu.core import x")
    assert _FORBIDDEN.search("import swtpu\n")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from swtpu_torch.core import x")
    assert not _FORBIDDEN.search("import swtpu_torch")


Q = np.zeros((2, 8), np.uint8)

NO_DEVICE_CALLS = {
    "sw_batch_diag": lambda: sw_scan.sw_batch_diag(Q, Q, DNA_10_30_15),
    "sw_batch_diag_ends": lambda: sw_scan.sw_batch_diag_ends(Q, Q, DNA_10_30_15),
    "sw_affine_batch_diag": lambda: affine_scan.sw_affine_batch_diag(Q, Q, AFF),
    "sw_affine_batch_diag_ends":
        lambda: affine_scan.sw_affine_batch_diag_ends(Q, Q, AFF),
    "sw_batch": lambda: sw_batch.sw_batch(Q, Q, DNA_10_30_15),
    "sw_batch_ends": lambda: sw_batch.sw_batch_ends(Q, Q, DNA_10_30_15),
    "sw_batch_plain": lambda: sw_batch.sw_batch_plain(Q, Q, DNA_10_30_15),
    "sw_affine": lambda: sw_affine.sw_affine(Q, Q, AFF),
    "sw_affine_ends": lambda: sw_affine.sw_affine_ends(Q, Q, AFF),
    "sw_affine_ends_plain": lambda: sw_affine.sw_affine_ends_plain(Q, Q, AFF),
    "sw_profile": lambda: sw_profile.sw_profile(Q, Q, GENERAL),
    "sw_profile_ends": lambda: sw_profile.sw_profile_ends(Q, Q, GENERAL_AFF),
    "best_engine": lambda: variants.best_engine(DNA_10_30_15),
    "best_ends_engine": lambda: variants.best_ends_engine(AFF),
    "resolve_engine": lambda: variants.resolve_engine(DNA_10_30_15),
    "sw_align_batch": lambda: port_traceback.sw_align_batch(Q, Q, DNA_10_30_15),
    "cpu_tensor_input": lambda: sw_batch.sw_batch(
        torch.zeros((2, 8), dtype=torch.uint8), Q, DNA_10_30_15
    ),
    "time_kernel": lambda: timing.time_kernel(lambda: None, ()),
    "sw_bf16": lambda: sw_bf16.sw_bf16(Q, Q, DNA_10_30_15),
    "sw_scores_varlen": lambda: bucketing.sw_scores_varlen(Q, Q, DNA_10_30_15),
    "sw_scores_promoted_device":
        lambda: promote.sw_scores_promoted_device(Q, Q, DNA_10_30_15),
    "load_packed_batch_device":
        lambda: port_io.load_packed_batch("reads.npz", device=True),
    "semiglobal_batch": lambda: semiglobal_batch.semiglobal_batch(Q, Q),
    "semiglobal_profile":
        lambda: semiglobal_profile.semiglobal_profile(Q, Q, GENERAL_AFF),
    "semiglobal_batch_diag": lambda: semiglobal_scan.semiglobal_batch_diag(Q, Q),
    "nw_batch_general": lambda: semiglobal_scan.nw_batch_general(Q, Q, GENERAL),
    "semiglobal_align_batch":
        lambda: port_traceback.semiglobal_align_batch(Q, Q, gap_open=3),
    "nw_align_batch": lambda: port_traceback.nw_align_batch(Q, Q, params=GENERAL),
    "sw_banded_static": lambda: sw_banded.sw_banded_static(Q, Q, DNA_10_30_15, 4),
    "sw_banded_profile": lambda: sw_banded.sw_banded_profile(Q, Q, GENERAL_AFF, 4),
    "sw_banded_plain": lambda: sw_banded.sw_banded_plain(Q, Q, AFF, 4),
    "banded_static_align_batch":
        lambda: port_traceback.banded_static_align_batch(Q, Q, GENERAL, 4),
    "banded_xdrop_batch": lambda: banded_scan.banded_xdrop_batch(Q, Q),
    "banded_batch": lambda: banded_batch.banded_batch(Q, Q, bandwidth=64),
    "banded_forward_batch": lambda: port_traceback.banded_forward_batch(Q, Q),
    "banded_align_batch":
        lambda: port_traceback.banded_align_batch(Q, Q, gap_open=3, gap_extend=1),
    "banded_block_batch":
        lambda: banded_block.banded_block_batch(Q, Q, width=16, block=8),
    "banded_block_align_device":
        lambda: banded_block.banded_block_align_device(Q, Q, width=16, block=8),
    "banded_xdrop_align_device": lambda: banded_scan.banded_xdrop_align_device(Q, Q),
    "longpair_sw_score": lambda: longpair.longpair_sw_score(Q[0], Q[0], DNA_10_30_15),
    "longpair_sw_ends": lambda: longpair.longpair_sw_ends(Q[0], Q[0], AFF),
    "longpair_sw_align": lambda: longpair.longpair_sw_align(Q[0], Q[0], GENERAL),
    "strip_tile": lambda: longpair_strip.strip_tile(Q[0], Q[0], Q[0], Q[0], 0,
                                                    DNA_10_30_15),
    "strip_tile_affine": lambda: longpair_strip.strip_tile_affine(
        Q[0], Q[0], Q[0], Q[0], Q[0], Q[0], 0, AFF),
    "sw_wavefront": lambda: sw_wavefront.sw_wavefront(Q, Q, DNA_10_30_15),
    "sw_wavefront_plain": lambda: sw_wavefront.sw_wavefront_plain(Q, Q, GENERAL),
    "sw_batch_colscan": lambda: colscan.sw_batch_colscan(Q, Q, DNA_10_30_15),
    "all_vs_all_topk": lambda: search.all_vs_all_topk(Q, Q, DNA_10_30_15, k=1),
    "calibrate_stats": lambda: stats.calibrate_stats(DNA_10_30_15, m=8, pairs=16),
    "resolve_stats": lambda: stats.resolve_stats(DNA_10_30_15, "dna", m=8,
                                                 calibrate_pairs=16),
    "map_reads": lambda: port_mapper.map_reads(Q, contigs=[np.arange(40) % 4], k=4),
    "map_reads_pipelined":
        lambda: port_mapper.map_reads_pipelined(Q, contigs=[np.arange(40) % 4], k=4),
    "extend_candidates": lambda: port_mapper.extend_candidates(
        port_mapper.build_index([np.arange(40) % 4], k=4), Q, np.full(2, 8),
        port_mapper.Candidates(np.zeros(1, np.int64), np.zeros(1, np.int64),
                               np.ones(1, np.int64))),
    "msa_center_star": lambda: port_msa.msa_center_star([Q[0], Q[1]]),
    "assemble_greedy": lambda: port_assembly.assemble_greedy([Q[0], Q[1]]),
    "make_mesh": lambda: port_mesh.make_mesh(),
    "init_distributed": lambda: port_mesh.init_distributed("localhost:1", 2, 0),
    "data_parallel_scores": lambda: port_mesh.data_parallel_scores(Q, Q, DNA_10_30_15, None),
    "sharded_all_vs_all_topk":
        lambda: search.sharded_all_vs_all_topk(Q, Q, DNA_10_30_15, None, k=1),
    "run_fuzz": lambda: fuzz.run_fuzz(max_rounds=1, log=None),
    "run_selftest": lambda: selftest.run_selftest(),
    "profile_trace": lambda: obs.profile_trace("unused").__enter__(),
    "bench_suite.main": lambda: bench_suite.main(["--suite", "affine"]),
    "bench_suite.bench_dist": lambda: bench_suite.bench_dist(True),
}


@pytest.mark.parametrize("entry", list(NO_DEVICE_CALLS))
def test_no_card_entry_without_device_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    counts = [fn.launches for fn in WRAPPERS]
    with pytest.raises(RuntimeError, match="CUDA"):
        NO_DEVICE_CALLS[entry]()
    assert [fn.launches for fn in WRAPPERS] == counts


@pytest.mark.parametrize("argv", [
    ["align", "--random", "2x8x8"],
    ["align", "--random", "2x8x8", "--cigar"],
    ["semiglobal", "--random", "2x8x8", "--traceback"],
    ["global", "--alphabet", "protein", "--random", "2x8x8", "--sam"],
    ["banded", "--random", "2x8x8", "--cigar"],
    ["banded", "--fixed", "--random", "2x8x8"],
    ["banded", "--fixed", "--alphabet", "protein", "--random", "2x8x8", "--sam"],
    ["banded", "--block-adaptive", "--random", "2x8x8", "--bandwidth", "8"],
    ["banded", "--block-adaptive", "--random", "2x8x8", "--bandwidth", "8", "--cigar"],
    ["longpair", "--random", "1x40x40"],
    ["longpair", "--random", "1x40x40", "--cigar"],
    ["align", "--random", "2x8x8", "--engine", "wavefront"],
    ["search", "--random", "2x4x8"],
    ["search", "--random", "2x4x8", "--tsv", "--stats", "calibrate"],
    ["map", "--random", "2000x4x50"],
    ["msa", "--random", "3x20"],
    ["assemble", "--random", "300x60x30"],
    ["longpair", "--random", "1x40x40", "--devices", "1"],
    ["selftest"],
    ["fuzz", "--rounds", "1"],
    ["bench", "--quick"],
    ["bench", "--suite", "dist", "--cpu-mesh", "2"],
])
def test_no_card_cli_raises_without_output(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    assert capsys.readouterr().out == ""


#: the JAX package's package-level names (``swtpu/__init__.py``, the
#: ``__init__`` files of core, ops, oracle and models) and the port's
#: package that exports each
EXPORTS = {
    "swtpu_torch": ["ScoringParams", "DNA_111", "dna_matrix", "pack_2bit",
                    "unpack_2bit", "random_dna", "mutate", "revcomp"],
    "swtpu_torch.core": ["path_to_cigar", "cigar_stats"],
    "swtpu_torch.ops": ["VARIANTS", "get_variant"],
    "swtpu_torch.oracle": ["sw_affine_score_batch"],
    "swtpu_torch.parallel": ["make_mesh", "shard_batch", "data_parallel_scores",
                             "init_distributed", "sharded_all_vs_all_topk",
                             "all_vs_all_topk", "SearchCheckpoint", "longpair_sw_align",
                             "longpair_sw_score"],
    "swtpu_torch.models": ["assemble_greedy", "make_reads", "msa_center_star",
                           "msa_rows_to_strings", "sp_score", "build_index",
                           "find_candidates", "extend_candidates", "map_reads",
                           "map_reads_pipelined"],
}


@pytest.mark.parametrize("package", list(EXPORTS))
def test_package_exports_load_no_jax_and_no_swtpu(package):
    code = (
        "import importlib, json, sys\n"
        f"mod = importlib.import_module({package!r})\n"
        f"missing = [n for n in {EXPORTS[package]!r} if not hasattr(mod, n)]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'swtpu' or m.startswith('swtpu.')]\n"
        "print(json.dumps([missing, bad]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300, check=True,
    ).stdout
    assert json.loads(out.strip().splitlines()[-1]) == [[], []]
    # and the JAX package exports the same names
    import importlib

    ref = importlib.import_module(package.replace("swtpu_torch", "swtpu"))
    assert all(hasattr(ref, n) for n in EXPORTS[package]
               if not (package.endswith("models") and n in (
                   "build_index", "find_candidates", "extend_candidates",
                   "map_reads", "map_reads_pipelined")))


def test_no_card_bench_refuses(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_no_nvcc_build_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("nvcc is present; this checks the missing-compiler case")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("sw_rowscan.cu")


def test_device_resolution():
    assert port_device.resolve_device("cpu").type == "cpu"
    t = port_device.as_codes(np.array([[0, 3, 4, 300]]), torch.device("cpu"))
    assert t.dtype == torch.uint8 and t.tolist() == [[0, 3, 4, 255]]
    with pytest.raises(TypeError):
        port_device.as_codes(np.zeros((1, 2), np.float32), torch.device("cpu"))


@pytest.fixture
def fake_card(monkeypatch):
    """Pretend a card exists and record which wrapper the dispatch calls."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    for name in ("sw_batch", "sw_batch_ends", "sw_affine", "sw_affine_ends",
                 "sw_profile", "sw_profile_ends", "sw_general", "sw_general_ends"):
        monkeypatch.setattr(
            variants, name,
            lambda q, t, p, d, _n=name: calls.append((_n, d.type)) or _n,
        )
    monkeypatch.setattr(
        variants, "sw_bf16",
        lambda q, t, p, allow_overflow=False, device=None:
            calls.append(("sw_bf16", device.type)) or "sw_bf16",
    )
    monkeypatch.setattr(
        variants, "sw_wavefront",
        lambda q, t, p, d: calls.append(("sw_wavefront", d.type)) or "sw_wavefront",
    )
    for name in ("sw_batch_diag", "sw_batch_diag_ends", "sw_affine_batch_diag",
                 "sw_affine_batch_diag_ends", "sw_batch_colscan"):
        monkeypatch.setattr(
            variants, name,
            lambda *a, _n=name: pytest.fail(f"plain tier {_n} ran on CUDA"),
        )
    return calls


@pytest.mark.parametrize("engine,params,kernel", [
    ("best_engine", DNA_10_30_15, "sw_batch"),
    ("best_ends_engine", DNA_10_30_15, "sw_batch_ends"),
    ("best_engine", AFF, "sw_affine"),
    ("best_ends_engine", AFF, "sw_affine_ends"),
    ("best_engine", GENERAL, "sw_profile"),
    ("best_ends_engine", GENERAL, "sw_profile_ends"),
    ("best_engine", GENERAL_AFF, "sw_profile"),
    ("best_ends_engine", GENERAL_AFF, "sw_profile_ends"),
])
def test_cuda_dispatch_picks_the_kernel(fake_card, engine, params, kernel):
    fn = getattr(variants, engine)(params)
    assert fn(Q, Q) == kernel
    assert fake_card == [(kernel, "cuda")]


@pytest.mark.parametrize("params", [
    ScoringParams.linear(np.where(np.arange(16).reshape(4, 4) == 0, 200,
                                  np.arange(16).reshape(4, 4) - 8), 2),
    ScoringParams.linear(dna_matrix(1, -1), 0),
    ScoringParams(dna_matrix(1, -1), gap_open=3, gap_extend=0),
    ScoringParams(np.arange(16).reshape(4, 4) - 8, gap_open=0, gap_extend=1),
])
def test_cuda_dispatch_raises_without_a_kernel(fake_card, params):
    """Scorings the row-scan and profile guards refuse run the general
    kernel on the card (JAX's TPU dispatch: its XLA tier); only an
    alphabet past 30 letters, which no kernel and no plain tier takes,
    raises, when the engine is built."""
    for engine, kernel in ((variants.best_engine, "sw_general"),
                           (variants.best_ends_engine, "sw_general_ends")):
        assert engine(params)(Q, Q) == kernel
    assert fake_card == [("sw_general", "cuda"), ("sw_general_ends", "cuda")]
    wide = ScoringParams.linear(np.eye(31, dtype=np.int32), 2)
    for engine in (variants.best_engine, variants.best_ends_engine):
        with pytest.raises(NotImplementedError, match="30 letters"):
            engine(wide)
    assert len(fake_card) == 2


@pytest.mark.parametrize("engine,params,n,kernel", [
    # inside the bf16 predicate: 128 * 10 / 5 = 256
    ("rowscan_bf16", DNA_10_30_15, 128, "sw_bf16"),
    # outside it, on padded n: 129 pads to 136, 136 * 2 > 256
    ("rowscan_bf16", DNA_10_30_15, 129, "sw_batch"),
    ("rowscan_bf16", ScoringParams.linear(dna_matrix(3, -1), 1), 85, "sw_batch"),
    ("rowscan_bf16", ScoringParams.linear(dna_matrix(1, 1), 1), 8, "sw_batch"),
    ("rowscan_bf16", GENERAL, 8, "sw_profile"),
    ("rowscan", DNA_10_30_15, 128, "sw_batch"),
    ("rowscan_prof", DNA_10_30_15, 128, "sw_profile"),
    ("xla_diag", DNA_10_30_15, 128, "sw_batch"),
    ("wavefront", DNA_10_30_15, 128, "sw_wavefront"),
    ("wavefront", GENERAL, 200, "sw_wavefront"),
    ("colscan", DNA_10_30_15, 128, "sw_batch"),
    ("colscan", GENERAL, 128, "sw_profile"),
    ("no_such_engine", GENERAL, 128, "sw_profile"),
])
def test_cuda_engine_option_picks_by_predicate(fake_card, engine, params, n,
                                               kernel):
    """``align --engine``: a name whose guard passes runs its kernel; the
    plain tiers' names (xla_diag, colscan), an unknown name and a failed
    guard run best_engine's kernel. Decided before anything runs, so exactly one
    wrapper is called and none raises."""
    fn = variants.variant_engine(engine, params, n)
    assert fake_card == []
    assert fn(Q, Q) == kernel
    assert fake_card == [(kernel, "cuda")]


def test_variant_registry_holds_the_ported_names():
    assert sorted(variants.VARIANTS) == [
        "colscan", "oracle", "rowscan", "rowscan_bf16", "rowscan_prof", "wavefront",
        "xla_diag"]
    for name in ("nope", "wavefronts"):
        with pytest.raises(KeyError, match="unknown variant"):
            variants.get_variant(name)


@pytest.fixture
def fake_sg_card(monkeypatch):
    """Pretend a card exists for the semi-global wrappers: the codes and
    lengths stay on the CPU, and the kernel launch is a recorder that
    returns the plain tier's result, computed apart; the plain tier as the
    wrappers see it fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls, seen = [], {}
    cpu = torch.device("cpu")
    lens_tensor = semiglobal_batch.lens_tensor

    def as_codes(x, device):
        assert device.type == "cuda"
        return port_device.as_codes(x, cpu)

    def lens(x, B, device):
        assert device.type == "cuda"
        return lens_tensor(x, B, cpu)

    def table(params, device):
        assert device.type == "cuda"
        seen["params"] = params
        return torch.as_tensor(sw_scan._extended_table(params))

    def launch(q, t, match, mismatch, go, ge, affine, pin_end, lens_q=None,
               lens_t=None, table=None, n_codes=None):
        calls.append(("profile" if table is not None else "uniform", affine,
                      pin_end, lens_q is not None))
        kw = dict(lens_q=lens_q, lens_t=lens_t, pin_end=pin_end, device="cpu")
        if table is not None:
            return semiglobal_scan.semiglobal_batch_general(
                q, t, seen["params"], **kw)
        return semiglobal_scan.semiglobal_batch_diag(
            q, t, match, -mismatch, gap_open=go, gap_extend=ge, **kw)

    monkeypatch.setattr(semiglobal_batch, "as_codes", as_codes)
    for mod in (semiglobal_batch, semiglobal_profile):
        monkeypatch.setattr(mod, "lens_tensor", lens)
        monkeypatch.setattr(mod, "semiglobal_launch_t", launch)
    monkeypatch.setattr(semiglobal_profile, "profile_table", table)
    for mod, name in ((semiglobal_batch, "semiglobal_batch_diag"),
                      (semiglobal_batch, "semiglobal_batch_plain"),
                      (semiglobal_profile, "semiglobal_batch_general"),
                      (semiglobal_profile, "semiglobal_profile_plain")):
        monkeypatch.setattr(
            mod, name,
            lambda *a, _n=name, **k: pytest.fail(f"plain tier {_n} ran on CUDA"))
    return calls


def _sg_pairs(B=6, n=10, m=12):
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    ts = np.concatenate([qs[:, 1:], rng.integers(0, 4, size=(B, m - n + 1))],
                        axis=1).astype(np.uint8)
    return qs, ts, rng.integers(0, n + 1, B), rng.integers(0, m + 1, B)


@pytest.mark.parametrize("entry,kw,varlen,call", [
    ("semiglobal", dict(match=2, mismatch=1, gap=1), False,
     ("uniform", False, False, False)),
    ("semiglobal", dict(match=2, mismatch=3, gap_open=5, gap_extend=1), True,
     ("uniform", True, False, True)),
    # gap_open == gap_extend collapses to linear, as in JAX
    ("global", dict(match=2, mismatch=3, gap_open=2, gap_extend=2), False,
     ("uniform", False, True, False)),
    ("global", dict(match=1, mismatch=1, gap=1), True,
     ("uniform", False, True, True)),
    ("semiglobal", dict(params=GENERAL), False, ("profile", False, False, False)),
    # a uniform matrix under params= goes to the profile kernel too
    ("semiglobal", dict(params=ScoringParams.linear(dna_matrix(1, -1), 1)), True,
     ("profile", False, False, True)),
    ("global", dict(params=GENERAL_AFF), True, ("profile", True, True, True)),
])
def test_cuda_semiglobal_dispatch_runs_the_kernel(fake_sg_card, entry, kw,
                                                  varlen, call):
    qs, ts, lq, lt = _sg_pairs()
    lens = dict(lens_q=lq, lens_t=lt) if varlen else {}
    fn = (port_traceback.semiglobal_align_batch if entry == "semiglobal"
          else port_traceback.nw_align_batch)
    wrapper = (semiglobal_profile.semiglobal_profile if "params" in kw
               else semiglobal_batch.semiglobal_batch)
    before = (wrapper.launches, wrapper.launches_affine, wrapper.launches_pinned)
    got = fn(qs, ts, **kw, **lens)
    assert fake_sg_card == [call]
    assert (wrapper.launches, wrapper.launches_affine, wrapper.launches_pinned) == (
        before[0] + 1, before[1] + call[1], before[2] + call[2])
    # the walk held each path to the recorded device scores and endpoints
    assert len(got) == len(qs)
    if entry == "global":
        assert [path[-1] for _, path in got] == [
            (lq[b], lt[b]) if varlen else (10, 12) for b in range(len(qs))]


@pytest.mark.parametrize("call,launch", [
    (lambda: semiglobal_batch.semiglobal_batch(Q, Q, gap=0),
     ("uniform", False, False, False)),
    (lambda: semiglobal_batch.semiglobal_batch(Q, Q, gap_open=3, gap_extend=0),
     ("uniform", True, False, False)),
    (lambda: port_traceback.nw_align_batch(Q, Q, match=1, mismatch=1, gap=-1),
     ("uniform", False, True, False)),
    (lambda: semiglobal_profile.semiglobal_profile(
        Q, Q, ScoringParams.linear(dna_matrix(1, -1), 0)),
     ("profile", False, False, False)),
    (lambda: port_traceback.semiglobal_align_batch(
        Q, Q, params=ScoringParams.linear(
            np.where(np.eye(4, dtype=bool), 200, -1), 2)),
     ("profile", False, False, False)),
])
def test_cuda_semiglobal_raises_without_a_kernel(fake_sg_card, call, launch):
    """No longer raises: a gap of 0 or below and matrix entries past
    +-127, which the card refused before the semi-global kernel tracked
    the boundary and took the matrix's own range, now launch the kernel
    once, as every other scoring does."""
    call()
    assert fake_sg_card == [launch]


@pytest.mark.parametrize("argv,call", [
    (["semiglobal", "--random", "4x10x12", "--scoring", "2,-1", "--cigar"],
     ("uniform", False, False, False)),
    (["global", "--alphabet", "protein", "--random", "4x10x12", "--gap-open",
      "11", "--gap-extend", "1", "--sam"], ("profile", True, True, False)),
])
def test_cuda_semiglobal_cli_runs_the_kernel(fake_sg_card, argv, call, capsys):
    from swtpu.cli import main as jax_cli

    cli.main(argv)
    on_card = capsys.readouterr().out
    assert fake_sg_card == [call]
    jax_cli(argv)
    assert capsys.readouterr().out == on_card and len(on_card.splitlines()) >= 4


@pytest.fixture
def fake_banded_card(monkeypatch):
    """Pretend a card exists for the banded wrappers: inputs stay on the
    CPU, and each kernel launch is a recorder that returns its plain
    version's result, computed apart; the plain tiers as the wrappers see
    them fail."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls, seen = [], {}
    cpu = torch.device("cpu")
    fixed_plain = sw_banded.sw_banded_plain
    lens_tensor = semiglobal_batch.lens_tensor
    stage = banded_batch.stage
    xdrop_plain = banded_scan.banded_xdrop_batch

    def as_codes(x, device):
        assert device.type == "cuda"
        return port_device.as_codes(x, cpu)

    def lens(x, B, device):
        assert device.type == "cuda"
        return lens_tensor(x, B, cpu)

    def table(matrix, device):
        assert device.type == "cuda"
        seen["matrix"] = matrix
        return torch.as_tensor(banded_scan._banded_ext_table(matrix))

    def fixed_launch(q, t, params, bandwidth, table=None, lens_q=None, lens_t=None):
        calls.append(("fixed", "profile" if table is not None else "uniform",
                      not params.is_linear))
        return fixed_plain(q, t, params, bandwidth, lens_q, lens_t, device="cpu")

    def prep(qs, ts, lens_q, lens_t, device):
        assert device.type == "cuda"
        seen["args"] = (qs, ts, lens_q, lens_t)
        return stage(qs, ts, lens_q, lens_t, cpu)

    def xdrop_launch(qp, tp, lens_q, lens_t, bandwidth, x_threshold, match, mismatch,
                     gap, gap_open=None, gap_extend=None, table=None,
                     with_history=True, compress_history=False):
        calls.append(("xdrop", bandwidth, gap_open is not None, table is not None,
                      compress_history))
        res = xdrop_plain(*seen["args"], match, mismatch, gap, bandwidth, x_threshold,
                          compress_history, with_history, gap_open, gap_extend,
                          None if table is None else seen["matrix"], device="cpu")
        return (res.score, res.max_round, res.n_rounds, res.band_history, res.pos_y,
                res.offsets)

    monkeypatch.setattr(semiglobal_batch, "as_codes", as_codes)
    monkeypatch.setattr(sw_banded, "lens_tensor", lens)
    monkeypatch.setattr(sw_banded, "banded_table", table)
    monkeypatch.setattr(sw_banded, "banded_launch_t", fixed_launch)
    monkeypatch.setattr(banded_batch, "banded_table", table)
    monkeypatch.setattr(banded_batch, "stage", prep)
    monkeypatch.setattr(banded_batch, "xdrop_launch_t", xdrop_launch)
    monkeypatch.setattr(banded_batch, "xdrop_wide_launch_t",
                        lambda *a, **k: ("wide", xdrop_launch(*a, **k))[1])
    monkeypatch.setattr(banded_batch, "xdrop_wide_warp_launch_t",
                        lambda *a, **k: ("wide_warp", xdrop_launch(*a, **k))[1])
    for mod, name in ((sw_banded, "sw_banded_plain"),
                      (port_traceback, "sw_banded_plain"),
                      (banded_batch, "banded_xdrop_batch"),
                      (banded_batch, "banded_batch_plain")):
        monkeypatch.setattr(
            mod, name,
            lambda *a, _n=name, **k: pytest.fail(f"plain tier {_n} ran on CUDA"))
    return calls


def _banded_pairs(B=5, n=24):
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    ts = qs.copy()
    ts[:, ::5] = rng.integers(0, 4, size=ts[:, ::5].shape)
    return qs, ts, rng.integers(n // 2, n + 1, B), rng.integers(n // 2, n + 1, B)


@pytest.mark.parametrize("params,call", [
    (ScoringParams.linear(dna_matrix(2, -1), 1), ("fixed", "uniform", False)),
    (AFF, ("fixed", "uniform", True)),
    (GENERAL, ("fixed", "profile", False)),
    (GENERAL_AFF, ("fixed", "profile", True)),
])
def test_cuda_fixed_band_runs_the_kernel(fake_banded_card, params, call):
    qs, ts, _, _ = _banded_pairs()
    wrapper = (sw_banded.sw_banded_static if call[1] == "uniform"
               else sw_banded.sw_banded_profile)
    before = (wrapper.launches, wrapper.launches_affine)
    got = port_traceback.banded_static_align_batch(qs, ts, params, 6)
    assert fake_banded_card == [call]
    assert (wrapper.launches, wrapper.launches_affine) == (
        before[0] + 1, before[1] + call[2])
    assert len(got) == len(qs) and max(s for s, _ in got) > 0


@pytest.mark.parametrize("W,kw,call", [
    (32, dict(), ("xdrop", 32, False, False, False)),
    (64, dict(gap_open=3, gap_extend=1), ("xdrop", 64, True, False, False)),
    (8, dict(compress_history=True), ("xdrop", 8, False, False, True)),
    (96, dict(matrix=np.arange(16).reshape(4, 4) % 5 - 2), ("xdrop", 96, False, True,
                                                          False)),
    (128, dict(gap_open=2, gap_extend=2), ("xdrop", 128, False, False, False)),
])
def test_cuda_banded_forward_runs_the_kernel(fake_banded_card, W, kw, call):
    qs, ts, lq, lt = _banded_pairs()
    before = (banded_batch.banded_batch.launches,
              banded_batch.banded_batch.launches_w32_w64)
    got = port_traceback.banded_align_batch(qs, ts, lq, lt, bandwidth=W,
                                            x_threshold=20, **kw)
    assert fake_banded_card == [call]
    assert (banded_batch.banded_batch.launches,
            banded_batch.banded_batch.launches_w32_w64) == (
        before[0] + 1, before[1] + (W in (32, 64)))
    assert len(got) == len(qs) and all(path[0] == (0, 0) for _, path in got)


@pytest.mark.parametrize("W", [129, 1024])
def test_cuda_banded_forward_runs_the_wide_kernel(fake_banded_card, W):
    """Past 128 the card's forward is the wide band (its one-warp form up
    to 256, its CTA past it), counted apart."""
    qs, ts, lq, lt = _banded_pairs()
    kern = banded_batch.banded_batch
    before = (kern.launches, kern.launches_wide)
    got = port_traceback.banded_align_batch(qs, ts, lq, lt, bandwidth=W, x_threshold=20)
    assert fake_banded_card == [("xdrop", W, False, False, False)]
    assert (kern.launches, kern.launches_wide) == (before[0], before[1] + 1)
    assert len(got) == len(qs) and all(path[0] == (0, 0) for _, path in got)


@pytest.mark.parametrize("call", [
    lambda: banded_batch.banded_batch(Q, Q, bandwidth=banded_batch.MAX_WIDTH + 1),
    lambda: port_traceback.banded_forward_batch(Q, Q, bandwidth=2000),
    lambda: sw_banded.sw_banded_static(Q, Q, ScoringParams.linear(dna_matrix(1, 1), 1)),
    lambda: sw_banded.sw_banded_static(Q, Q, GENERAL),
    lambda: port_traceback.banded_static_align_batch(
        Q, Q, ScoringParams.linear(dna_matrix(1, -1), 0)),
])
def test_cuda_banded_raises_without_a_kernel(fake_banded_card, call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call()
    assert fake_banded_card == []


@pytest.mark.parametrize("extend,call", [
    ("fixed", ("fixed", "uniform", False)),
    ("adaptive", ("xdrop", 32, False, False, False)),
])
def test_cuda_mapper_screening_runs_the_kernel(fake_banded_card, extend, call):
    """The mapper's screening on a CUDA device: reads with an in-length N
    go on the raw wire to the fixed-band kernel (extend "fixed"), or to
    the per-round kernel (extend "adaptive"), one launch for every
    candidate; the scores equal the CPU's."""
    rng = np.random.default_rng(10000)
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    reads = np.stack([genome[s: s + 40].copy() for s in (10, 200, 430)])
    reads[:, 20] = 4
    lens = np.full(3, 40)
    idx = port_mapper.build_index([genome], k=9)
    cands = port_mapper.find_candidates(idx, reads, lens)
    got = port_mapper.extend_candidates(idx, reads, lens, cands, extend=extend,
                                        device="cuda")
    assert fake_banded_card == [call]
    from swtpu_torch.oracle.banded_static import sw_banded_static_score
    from swtpu_torch.oracle.semiglobal import banded_xdrop

    ext = ScoringParams.linear(np.pad(dna_matrix(1, -1), ((0, 2), (0, 2)),
                                      constant_values=-1), 1)
    for k, r in enumerate(cands.read):
        w = idx.ref[got[1][k]: got[1][k] + 40 + 64]
        want = (sw_banded_static_score(reads[r], w, ext, 32) if extend == "fixed"
                else banded_xdrop(reads[r], w)[0])
        assert got[0][k] == want
    assert len(got[0]) >= 3 and got[0].min() > 0


@pytest.mark.parametrize("argv,call", [
    (["banded", "--fixed", "--random", "4x20x20", "--bandwidth", "6", "--cigar"],
     ("fixed", "uniform", False)),
    (["banded", "--fixed", "--alphabet", "protein", "--random", "4x20x20",
      "--gap-open", "11", "--gap-extend", "1"], ("fixed", "profile", True)),
    (["banded", "--random", "4x30x30", "--x-drop", "20", "--traceback"],
     ("xdrop", 32, False, False, False)),
    (["banded", "--alphabet", "protein", "--random", "4x30x30", "--gap-open", "11",
      "--gap-extend", "1", "--bandwidth", "64", "--sam"],
     ("xdrop", 64, True, True, False)),
])
def test_cuda_banded_cli_runs_the_kernel(fake_banded_card, argv, call, capsys):
    from swtpu.cli import main as jax_cli

    cli.main(argv)
    on_card = capsys.readouterr().out
    assert fake_banded_card == [call]
    jax_cli(argv)
    assert capsys.readouterr().out == on_card and len(on_card.splitlines()) >= 4


@pytest.fixture
def fake_strip_card(monkeypatch):
    """Pretend a card exists for the long-pair sweep and the wavefront:
    codes and tables stay on the CPU, the strip tile's kernel wrappers
    and the wavefront launch are recorders that return the plain
    versions' results, computed apart; the plain versions as the sweep
    and the wrapper see them fail."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    cpu = torch.device("cpu")
    stage = longpair_strip.stage_codes
    tile, tile_affine = longpair_strip.tile_strip_linear, longpair_strip.tile_strip_affine
    as_codes = sw_wavefront.as_codes
    plain_wave = sw_wavefront.sw_wavefront_plain

    def strip(*a, table=None, _affine=False):
        calls.append(("strip", _affine))
        assert table is not None and table.device == cpu
        fn = (tile_affine if _affine else tile)
        fn.launches += 1
        return fn(*a)

    def wave_launch(qs, ts, table, params):
        calls.append(("wavefront",))
        return plain_wave(qs, ts, params, cpu)

    monkeypatch.setattr(longpair_strip, "stage_codes",
                        lambda x, p, d: stage(x, p, cpu))
    monkeypatch.setattr(sw_profile, "profile_table",
                        lambda p, d: torch.as_tensor(sw_scan._extended_table(p)))
    monkeypatch.setattr(longpair_strip, "tile_strip_linear", strip)
    monkeypatch.setattr(longpair_strip, "tile_strip_affine",
                        lambda *a, table=None: strip(*a, table=table, _affine=True))
    monkeypatch.setattr(sw_wavefront, "as_codes", lambda x, d: as_codes(x, cpu))
    monkeypatch.setattr(sw_wavefront, "wavefront_table",
                        lambda p, d: torch.as_tensor(sw_wavefront._profile_table(p)))
    monkeypatch.setattr(sw_wavefront, "wavefront_launch_t", wave_launch)
    for mod, name in ((longpair, "_tile_colscan"), (longpair, "_tile_colscan_affine"),
                      (sw_wavefront, "sw_wavefront_plain")):
        monkeypatch.setattr(
            mod, name,
            lambda *a, _n=name, **k: pytest.fail(f"plain tier {_n} ran on CUDA"))
    return calls


def _long_pair(n=150, m=120):
    rng = np.random.default_rng(10000)
    q = rng.integers(0, 4, n).astype(np.uint8)
    t = np.concatenate([rng.integers(0, 4, 5), q])[:m].astype(np.uint8)
    t[::9] = rng.integers(0, 4, t[::9].shape)
    return q, t


@pytest.mark.parametrize("entry,params,block,tiles", [
    ("score", DNA_10_30_15, None, 1),
    ("ends", AFF, 40, 3),
    ("align", ScoringParams.linear(dna_matrix(2, -1), 1), 30, 4),
    ("align", GENERAL_AFF, None, 1),
])
def test_cuda_longpair_sweeps_through_the_strip_kernel(fake_strip_card, entry, params,
                                                       block, tiles):
    from swtpu_torch.oracle.affine import sw_affine_traceback
    from swtpu_torch.oracle.sw import sw_traceback

    q, t = _long_pair()
    affine = not params.is_linear
    before = [w.launches for w in STRIP_WRAPPERS]
    fn = getattr(longpair, f"longpair_sw_{entry}")
    got = fn(q, t, params, block=block)
    assert fake_strip_card == [("strip", affine)] * tiles
    assert [w.launches for w in STRIP_WRAPPERS] == [
        before[0] + tiles * (not affine), before[1] + tiles * affine]
    m = t.shape[0] // (block or t.shape[0]) * (block or t.shape[0])
    score, path = (sw_affine_traceback if affine else sw_traceback)(q, t[:m], params)
    want = {"score": score, "ends": (score, *path[-1]), "align": (score, path)}[entry]
    assert got == want


@pytest.mark.parametrize("params", [DNA_10_30_15, GENERAL])
def test_cuda_wavefront_runs_the_kernel(fake_strip_card, params):
    qs = np.random.default_rng(10000).integers(0, 4, (6, 100)).astype(np.uint8)
    ts = np.roll(qs, 3, axis=1)
    before = sw_wavefront.sw_wavefront.launches
    got = sw_wavefront.sw_wavefront(qs, ts, params)
    assert fake_strip_card == [("wavefront",)]
    assert sw_wavefront.sw_wavefront.launches == before + 1
    assert np.array_equal(got.numpy(), sw_scan.sw_batch_diag(qs, ts, params, "cpu").numpy())
    with pytest.raises(NotImplementedError, match="affine wavefront"):
        sw_wavefront.sw_wavefront(qs, ts, AFF)


@pytest.mark.parametrize("argv,call", [
    (["longpair", "--random", "2x150x120", "--block", "40", "--cigar"],
     [("strip", False)] * 6),
    (["longpair", "--alphabet", "protein", "--random", "1x80x64", "--gap-open", "11",
      "--gap-extend", "1"], [("strip", True)]),
    (["align", "--random", "4x100x120", "--scoring", "2,-1", "--engine", "wavefront"],
     [("wavefront",)]),
])
def test_cuda_longpair_and_wavefront_cli_run_the_kernels(fake_strip_card, argv, call,
                                                         capsys):
    from jax.experimental.pallas import tpu as pltpu

    from swtpu.cli import main as jax_cli

    cli.main(argv)
    on_card = capsys.readouterr().out
    assert fake_strip_card == call
    with pltpu.force_tpu_interpret_mode():  # JAX's wavefront is a Pallas kernel
        jax_cli(argv + (["--devices", "1"] if argv[0] == "longpair" else []))
    assert capsys.readouterr().out == on_card and len(on_card.splitlines()) >= 1
