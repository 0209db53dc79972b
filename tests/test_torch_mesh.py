"""The mesh on torch.distributed, on the CPU: gloo worlds of 2 and 4
processes against the JAX package on the conftest's virtual CPU mesh of
the same size (seed 10000, tolerance 0).

One spawn a world (``tests/_torch_mesh_worker.py``, which imports
neither jax nor swtpu; its ranks get ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` as torchrun gives them and meet at a file store in the
test's tmp dir), every check inside it. Held equal to JAX:

- ``data_parallel_scores`` (linear and Gotoh): the gathered DTensor;
  ``shard_batch``'s local shard is the rank's slice;
- ``sharded_all_vs_all_topk``: DNA, Gotoh on an uneven DB, BLOSUM62, an
  uneven DNA DB, tie-rich (2,-1,1) and a DB smaller than k, hits with
  their tie order;
- the sharded long-pair sweep at 512 x 384 (linear, Gotoh, a general 4 x
  4 matrix; an explicit block and ``block=None``, sub-strips of 48 rows
  on each rank): each rank's (best, end_i, end_j) row equals JAX's
  per-device row of ``_run_longpair``, and the merged ``longpair_sw_ends``
  and ``longpair_sw_align`` equal JAX's, on every rank;
- ``longpair --device cpu`` in the world (``--devices N`` and the
  world's default): rank 0's stdout and stderr equal ``python -m swtpu
  longpair --devices N``'s; the other ranks print nothing.

In process: ``_auto_block``, ``_merge_device_ends``, ``_tile_scan`` and
``_tile_scan_affine`` against JAX's; ``make_mesh`` at a world of one and
its refusals; a JAX mesh passed to the port raises.

Each test walks its cases in a loop: the cost is the spawned worlds,
one a world, not the assertions.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.cli import main as jax_cli
from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu.kernels.xla.sw_scan import _extended_table as jax_table
from swtpu.parallel import data_parallel_scores as jax_dp
from swtpu.parallel import longpair as jlp
from swtpu.parallel import make_mesh as jax_mesh
from swtpu.parallel import sharded_all_vs_all_topk as jax_topk
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_10_30_15, DNA_111, ScoringParams
from swtpu_torch.kernels import longpair_strip as kls
from swtpu_torch.parallel import longpair as plp

WORKER = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
_spec = importlib.util.spec_from_file_location("_torch_mesh_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)  # the worker's inputs and cases: one source
SEED, SCORINGS, TOPK = W.SEED, W.SCORINGS, W.TOPK


def _jp(p):
    return JaxScoring(p.matrix, p.gap_open, p.gap_extend)


@pytest.fixture(scope="module")
def inputs():
    return W.inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    """Spawn a gloo world of n ranks once; its results (rank 0's JSON)."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"world{n}")
    out = tmp / "out.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(WORKER)))
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(tmp / "store"), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=root))
    logs = []
    for r, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for x in procs:
                x.kill()
            raise
        logs.append((r, p.returncode, so, se))
    for r, rc, so, se in logs:
        assert rc == 0 and f"MESH_OK {r}" in so, f"rank {r} rc={rc}\n{so}\n{se}"
    with open(out) as fh:
        res = json.load(fh)
    assert res["world"] == n
    return n, res


def test_data_parallel_scores_match_jax(world, inputs):
    n, res = world
    for key in W.DP:
        want = jax_dp(inputs["dp_q"], inputs["dp_t"], _jp(SCORINGS[key]), jax_mesh(n))
        assert res["dp_" + key] == np.asarray(want).tolist(), key


def test_sharded_topk_matches_jax(world, inputs):
    n, res = world
    for case, (key, *_, k) in TOPK.items():
        s, i = jax_topk(*inputs[case], _jp(SCORINGS[key]), jax_mesh(n), k=k)
        assert res["topk_" + case] == [s.tolist(), i.tolist()], case


def test_sharded_longpair_matches_jax(world, inputs):
    """Per-rank rows, merged ends at each block, and the walk, under
    every scoring; sub-strips of 48 rows on each rank."""
    n, res = world
    q, t = inputs["lp"]
    mesh = jax_mesh(n, axis="sp")
    for key in W.LP:
        p = _jp(SCORINGS[key])
        for block in W.BLOCKS:
            blk = None if block == "auto" else int(block)
            rows = np.asarray(jlp._run_longpair(q, t, p, mesh, "sp", blk, engine="xla"))
            got_rows, got_ends = res[f"lp_{key}_{block}"]
            assert got_rows == rows.tolist(), (key, block)
            assert tuple(got_ends) == jlp._merge_device_ends(rows) and got_ends[0] > 0
        score, path = jlp.longpair_sw_align(q, t, p, mesh, engine="xla")
        assert res[f"lp_{key}_align"] == [score, [list(x) for x in path]], key
    want = jlp._run_longpair(q, t, _jp(SCORINGS["dna"]), mesh, "sp", 64, engine="xla")
    assert res["lp_dna_substrips"] == np.asarray(want).tolist()


def test_cli_longpair_in_a_world_matches_jax(world, capsys):
    n, res = world
    for k, argv in enumerate(W.CLI):
        jax_cli(argv + ["--devices", str(n)])
        theirs = capsys.readouterr()
        assert res[f"cli_{k}"] == [theirs.out, theirs.err] and theirs.out, argv
    assert "query trimmed 301" in res["cli_0"][1] and "target trimmed 250" in res["cli_0"][1]


def test_auto_block_and_merge_match_jax():
    """The divisor search (XLA route, and the strip route's rows and cap)
    and the row-major-first merge of per-device rows."""
    for Lq, Lt, n_dev in [(512, 384, 1), (512, 384, 2), (512, 384, 4), (16384, 16384, 1),
                          (16384, 16384, 2), (100, 97, 2), (64, 60, 4), (60, 50, 1),
                          (4096, 4096 * 3, 8), (1 << 20, 1 << 20, 4)]:
        assert plp._auto_block(Lq, Lt, n_dev) == jlp._auto_block(Lq, Lt, n_dev)
        assert (plp._auto_block(Lq, Lt, n_dev, rows=Lq // 16, cap=4096)
                == jlp._auto_block(Lq, Lt, n_dev, rows=Lq // 16, cap=4096))
    rng = np.random.default_rng(SEED)
    for _ in range(20):
        rows = rng.integers(0, 4, (4, 3)).astype(np.int32)
        rows[:, 0] = rng.integers(0, 3, 4)
        assert plp._merge_device_ends(rows) == jlp._merge_device_ends(rows)
    assert plp._merge_device_ends(np.zeros((2, 3), np.int32)) == (0, 0, 0)


_jax_scan = jax.jit(jlp._tile_scan, static_argnums=(6,))
_jax_scan_affine = jax.jit(jlp._tile_scan_affine, static_argnums=(8,))


def test_tile_scan_matches_jax():
    """The older anti-diagonal tiles on non-zero boundaries, every return:
    uniform DNA, a 4x4 matrix, BLOSUM62, linear and Gotoh."""
    for name, R, C in [("dna", 7, 40), ("g4", 33, 13), ("blosum", 20, 31), ("lp_gotoh", 9, 40),
                       ("blosum_gotoh", 17, 11)]:
        p = ScoringParams(BLOSUM62, 11, 1) if name == "blosum_gotoh" else SCORINGS[name]
        rng = np.random.default_rng(SEED + R)
        letters = p.alphabet_size
        q, t = rng.integers(0, letters, R), rng.integers(0, letters, C)
        top, left = rng.integers(0, 30, C), rng.integers(0, 30, R)
        corner = int(rng.integers(0, 30))
        table = jnp.asarray(jax_table(_jp(p)))
        i32 = lambda x: jnp.asarray(x, jnp.int32)  # noqa: E731
        tt = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64)  # noqa: E731
        ptable = torch.as_tensor(kls._extended_table(p))
        if p.is_linear:
            want = _jax_scan(i32(q), i32(t), i32(top), i32(left), i32(corner), table,
                             letters, i32(p.gap))
            got = kls._tile_scan(tt(q), tt(t), tt(top), tt(left), tt(corner), ptable, letters,
                                 p.gap)
        else:
            topf, lefte = rng.integers(-20, 30, C), rng.integers(-20, 30, R)
            want = _jax_scan_affine(i32(q), i32(t), i32(top), i32(topf), i32(left),
                                    i32(lefte), i32(corner), table, letters, i32(p.gap_open),
                                    i32(p.gap_extend))
            got = kls._tile_scan_affine(tt(q), tt(t), tt(top), tt(topf), tt(left), tt(lefte),
                                        tt(corner), ptable, letters, p.gap_open, p.gap_extend)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_make_mesh_world_of_one(world_of_one):
    """With no process group, make_mesh starts a world of one on an
    in-memory store; any other size names torchrun; JAX's guard on the
    batch holds; the sweep at one rank is the one-device sweep."""
    from swtpu_torch.parallel import data_parallel_scores, make_mesh, shard_batch

    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2, device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("pairs",)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(4, device="cpu")
    rng = np.random.default_rng(SEED)
    qs, ts = rng.integers(0, 4, (6, 32)).astype(np.uint8), rng.integers(0, 4, (6, 40)).astype(np.uint8)
    want = np.asarray(jax_dp(qs, ts, _jp(DNA_10_30_15), jax_mesh(1)))
    got = data_parallel_scores(qs, ts, DNA_10_30_15, mesh, device="cpu")
    assert got.full_tensor().tolist() == want.tolist()
    assert shard_batch(qs, mesh).full_tensor().numpy().tobytes() == qs.tobytes()
    with pytest.raises(ValueError, match="axes"):
        data_parallel_scores(qs, ts, DNA_10_30_15, mesh, axis="sp", device="cpu")
    q, t = W.related(rng, 300, 240)
    sp = make_mesh(1, axis="sp", device="cpu")
    assert (plp.longpair_sw_ends(q, t, DNA_111, sp, device="cpu")
            == plp.longpair_sw_ends(q, t, DNA_111, device="cpu")
            == jlp.longpair_sw_ends(q, t, _jp(DNA_111), jax_mesh(1, axis="sp"), engine="xla"))
    with pytest.raises(ValueError, match="axes"):
        plp.longpair_sw_ends(q, t, DNA_111, sp, axis="pairs", device="cpu")


def test_a_jax_mesh_is_refused():
    q = np.zeros(64, np.uint8)
    with pytest.raises(TypeError, match="swtpu_torch.parallel.make_mesh"):
        plp.longpair_sw_ends(q, q, DNA_111, jax_mesh(2, axis="sp"), device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        plp.longpair_sw_score(q, q, DNA_111, 2, device="cpu")
