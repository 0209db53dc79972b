"""swtpu_torch stands alone and runs on the card unless asked otherwise.

- importing every port module loads neither JAX nor the JAX package;
- no port source (nor chip_smoke.py) imports jax, swtpu or swtpu.*;
- without a card, every public entry called without ``device`` raises
  instead of running on the CPU, and launches nothing;
- on a CUDA device the dispatch picks a kernel wrapper, never the plain
  tier, and scoring no kernel takes raises (checked with the card's
  presence faked and the wrappers replaced, so nothing runs).
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

from swtpu_torch import bench, cli
from swtpu_torch.batch import traceback as port_traceback
from swtpu_torch.core.scoring import DNA_10_30_15, ScoringParams, dna_matrix
from swtpu_torch.kernels import _build, affine_scan, sw_affine, sw_batch, sw_scan
from swtpu_torch.ops import variants
from swtpu_torch.utils import device as port_device
from swtpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "swtpu_torch"
AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
WRAPPERS = [sw_batch.sw_batch, sw_batch.sw_batch_ends,
            sw_affine.sw_affine, sw_affine.sw_affine_ends]


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
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    "best_engine": lambda: variants.best_engine(DNA_10_30_15),
    "best_ends_engine": lambda: variants.best_ends_engine(AFF),
    "resolve_engine": lambda: variants.resolve_engine(DNA_10_30_15),
    "sw_align_batch": lambda: port_traceback.sw_align_batch(Q, Q, DNA_10_30_15),
    "cpu_tensor_input": lambda: sw_batch.sw_batch(
        torch.zeros((2, 8), dtype=torch.uint8), Q, DNA_10_30_15
    ),
    "time_kernel": lambda: timing.time_kernel(lambda: None, ()),
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
])
def test_no_card_cli_raises_without_output(argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    assert capsys.readouterr().out == ""


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
    for name in ("sw_batch", "sw_batch_ends", "sw_affine", "sw_affine_ends"):
        monkeypatch.setattr(
            variants, name,
            lambda q, t, p, d, _n=name: calls.append((_n, d.type)) or _n,
        )
    for name in ("sw_batch_diag", "sw_batch_diag_ends", "sw_affine_batch_diag",
                 "sw_affine_batch_diag_ends"):
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
])
def test_cuda_dispatch_picks_the_kernel(fake_card, engine, params, kernel):
    fn = getattr(variants, engine)(params)
    assert fn(Q, Q) == kernel
    assert fake_card == [(kernel, "cuda")]


@pytest.mark.parametrize("params", [
    ScoringParams.linear(np.arange(16).reshape(4, 4) - 8, 2),
    ScoringParams.linear(dna_matrix(1, -1), 0),
    ScoringParams(dna_matrix(1, -1), gap_open=3, gap_extend=0),
])
def test_cuda_dispatch_raises_without_a_kernel(fake_card, params):
    for engine in (variants.best_engine, variants.best_ends_engine):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            engine(params)
    assert fake_card == []
