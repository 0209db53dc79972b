"""The harnesses on the CPU: ``fuzz``, ``selftest`` and ``profile_trace``
against the JAX package (seed 10000).

- ``run_fuzz(max_rounds=11, use_cuda=False, device="cpu")`` (every family
  once) gives the JAX package's ``run_fuzz(use_pallas=False)`` stats:
  rounds, pairs, cells and 0 mismatches; a planted mismatch saves an
  ``.npz`` repro, logs JAX's failure text and raises at the end, as in
  JAX; the ``fuzz`` CLI prints what ``python -m swtpu fuzz`` prints;
- ``selftest --device cpu`` prints the JAX package's CPU records line for
  line (JAX's own run is made once here and reused); the port's check
  names, the card's included, are JAX's in JAX's order;
- ``profile_trace`` writes one Chrome trace on the CPU, and
  ``trace_busy`` reads it.
"""

import contextlib
import dataclasses
import io
import json
import re
from pathlib import Path

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

from swtpu import fuzz as jfuzz
from swtpu.cli import main as jax_cli
from swtpu_torch import cli, fuzz
from swtpu_torch.core.scoring import DNA_10_30_15
from swtpu_torch.utils.obs import profile_trace, trace_busy

ROOT = Path(__file__).resolve().parent.parent


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
            rc = 0
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def jax_selftest():
    """JAX's CPU selftest, run once (it ends with a 10-round fuzz soak)."""
    return _run(jax_cli, ["selftest"])


def test_selftest_records_match_jax(jax_selftest):
    rc, out = _run(cli.main, ["selftest", "--device", "cpu"])
    assert (rc, out) == jax_selftest
    recs = [json.loads(x) for x in out.splitlines()]
    assert [r["selftest"] for r in recs] == [
        "xla_vs_oracle", "nw_vs_oracle", "banded_16k_e2e_vs_scalar_oracle",
        "msa_center_star_projection", "fuzz_soak_short"]
    assert all(r["ok"] for r in recs)


def _names(src):
    """Check names in the order of the source (the fuzz soak's two
    outcomes are one name)."""
    return list(dict.fromkeys(re.findall(r'checks\.append\(\s*\(\s*"(\w+)"', src)))


def test_selftest_check_names_follow_jax():
    """The card's checks stand where JAX's TPU branch does, by name and
    order: the port's run = its two plain checks, the card's checks, then
    the checks JAX runs after its TPU branch."""
    jax_names = _names((ROOT / "swtpu" / "cli.py").read_text())
    src = (ROOT / "swtpu_torch" / "selftest.py").read_text()
    card_src, run_src = src.split("def run_selftest(")
    card, run = _names(card_src), _names(run_src)
    assert len(jax_names) == 23 and len(card) == 18
    assert jax_names == run[:2] + card + run[2:]


def test_run_fuzz_matches_jax():
    ours = fuzz.run_fuzz(max_rounds=11, pairs_per_round=64, use_cuda=False,
                         save_dir=None, log=None, minutes=30, device="cpu")
    theirs = jfuzz.run_fuzz(max_rounds=11, pairs_per_round=64, use_pallas=False,
                            save_dir=None, log=None, minutes=30)
    assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
    assert (ours.rounds, ours.mismatches) == (11, 0) and ours.pairs > 0
    assert fuzz.FAMILIES == ["uniform", "tie_rich", "general4", "affine", "protein",
                             "semiglobal", "banded", "fixed_band", "search", "cigar",
                             "banded_block"]


def test_fuzz_mismatch_saves_a_repro_and_raises(monkeypatch, tmp_path):
    """A planted oracle fault (+1 on every score): both packages record
    the same failures, save the batch and raise once the loop ends."""
    logs = {}
    for name, mod in (("port", fuzz), ("jax", jfuzz)):
        real = mod._oracle_local
        monkeypatch.setattr(mod, "_oracle_local", lambda q, t, p, real=real: real(q, t, p) + 1)
        lines = []
        kw = dict(max_rounds=2, pairs_per_round=16, families=["uniform", "protein"],
                  save_dir=str(tmp_path / name), log=lines.append, minutes=30)
        kw.update(device="cpu") if mod is fuzz else kw.update(use_pallas=False)
        with pytest.raises(AssertionError, match="fuzz found 3 mismatches"):
            mod.run_fuzz(**kw)
        logs[name] = [x.replace(str(tmp_path / name), "DIR") for x in lines]
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == [
            "fuzz_r0_uniform.npz", "fuzz_r1_protein.npz"]
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 4
    with pytest.raises(ValueError, match="card"):
        fuzz.run_fuzz(max_rounds=1, use_cuda=True, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        fuzz.run_fuzz(max_rounds=1, families=["bogus"], device="cpu")


def test_fuzz_cli_matches_jax(tmp_path):
    argv = ["fuzz", "--rounds", "3", "--pairs", "32", "--families", "uniform,search,cigar",
            "--save-dir", str(tmp_path)]
    assert _run(cli.main, argv + ["--device", "cpu"]) == _run(jax_cli, argv)


def test_profile_trace_writes_a_trace(tmp_path):
    from swtpu_torch.ops import best_engine

    q = np.random.default_rng(10000).integers(0, 4, (32, 48)).astype(np.uint8)
    with profile_trace(str(tmp_path / "trace"), device="cpu") as prof:
        best_engine(DNA_10_30_15, "cpu")(q, q)
    files = list((tmp_path / "trace").iterdir())
    assert files == [Path(prof.trace_path)] and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    busy, window = trace_busy(prof.trace_path)
    assert busy == 0.0 < window  # no device kernels on the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile_trace(str(tmp_path / "card")):
            pass
