"""One rank of a gloo world for tests/test_torch_mesh.py (the CPU) and
tests/test_torch_cuda.py (ranks sharing the card).

Imports neither jax nor swtpu: the port alone. Every rank draws the same
inputs (``inputs()``, seed 10000, which the tests import from here too),
runs every sharded entry point on them as torchrun would start it
(``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in the environment), checks
that every rank got the same results, and rank 0 writes them as JSON.

Usage: python tests/_torch_mesh_worker.py INIT_FILE OUT.json [cpu|cuda]
"""

import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from swtpu_torch import cli  # noqa: E402
from swtpu_torch.core.protein import blosum62_params, random_protein  # noqa: E402
from swtpu_torch.core.scoring import (  # noqa: E402
    DNA_10_30_15,
    DNA_111,
    ScoringParams,
    dna_matrix,
)
from swtpu_torch.parallel import (  # noqa: E402
    data_parallel_scores,
    init_distributed,
    longpair_sw_align,
    longpair_sw_ends,
    make_mesh,
    shard_batch,
    sharded_all_vs_all_topk,
)
from swtpu_torch.parallel import longpair as plp  # noqa: E402

SEED = 10000
G4 = np.array([[5, -4, -2, -4], [-4, 5, -4, -2], [-2, -4, 5, -4], [-4, -2, -4, 5]])
SCORINGS = {
    "lin": DNA_10_30_15,
    "gotoh": ScoringParams(dna_matrix(10, -30), 40, 15),
    "dna": DNA_111,
    "lp_gotoh": ScoringParams(dna_matrix(2, -3), 5, 1),
    "g4": ScoringParams.linear(G4, 3),
    "blosum": blosum62_params(),
    "tie": ScoringParams.linear(dna_matrix(2, -1), 1),
}
DP = ["lin", "gotoh"]
TOPK = {  # case: (scoring, Nq, Nt, L, k)
    "dna": ("dna", 4, 64, 64, 5),
    "gotoh_uneven": ("gotoh", 3, 53, 48, 5),
    "blosum": ("blosum", 2, 19, 32, 4),
    "dna_uneven": ("dna", 3, 29, 40, 6),
    "tie": ("tie", 4, 37, 24, 8),
    "small_db": ("dna", 2, 5, 16, 8),
}
LP = ["dna", "lp_gotoh", "g4"]
BLOCKS = ["64", "auto"]
SUBSTRIPS = 48  # rows of a sub-strip in the sub-strip case
CLI = [
    ["longpair", "--random", "1x301x250", "--block", "64", "--traceback"],
    ["longpair", "--random", "2x200x160", "--gap-open", "5", "--gap-extend", "1",
     "--scoring", "2,-3", "--cigar"],
]


def related(rng, n, m):
    """A homologous pair: ~85% identity, an offset at the start."""
    q = rng.integers(0, 4, n)
    t = q[:m].copy()
    sub = rng.random(m) < 0.15
    t[sub] = rng.integers(0, 4, int(sub.sum()))
    t = np.concatenate([rng.integers(0, 4, 9), t])[:m]
    return q.astype(np.uint8), t.astype(np.uint8)


def inputs():
    """Every case's codes, drawn from seed 10000."""
    rng = np.random.default_rng(SEED)
    z = {"dp_q": rng.integers(0, 4, (16, 48)).astype(np.uint8),
         "dp_t": rng.integers(0, 4, (16, 56)).astype(np.uint8)}
    for case, (key, nq, nt, L, k) in TOPK.items():
        if key == "blosum":
            z[case] = random_protein(rng, (nq, L)), random_protein(rng, (nt, L))
        elif key == "tie":  # two letters: many equal scores at the k boundary
            z[case] = (rng.integers(0, 2, (nq, L)).astype(np.uint8),
                       rng.integers(0, 2, (nt, L)).astype(np.uint8))
        else:
            z[case] = (rng.integers(0, 4, (nq, L)).astype(np.uint8),
                       rng.integers(0, 4, (nt, L)).astype(np.uint8))
    z["lp"] = related(rng, 512, 384)
    return z


def main():
    init_file, out_path = sys.argv[1:3]
    device = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    init_distributed(coordinator="file://" + init_file, backend="gloo", device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    engine = "xla" if device == "cpu" else "pallas"
    z = inputs()
    out = {"world": world}

    mesh = make_mesh(world, device=device)
    assert mesh.size() == world and mesh.get_local_rank("pairs") == rank
    qs, ts = z["dp_q"], z["dp_t"]
    B = len(qs) // world
    assert np.array_equal(shard_batch(qs, mesh).to_local().numpy(),
                          qs[rank * B:(rank + 1) * B])
    for key in DP:
        d = data_parallel_scores(qs, ts, SCORINGS[key], mesh, device=device)
        assert d.to_local().shape == (B,)
        out["dp_" + key] = d.full_tensor().tolist()

    for case, (key, *_, k) in TOPK.items():
        s, i = sharded_all_vs_all_topk(*z[case], SCORINGS[key], mesh, k=k, device=device)
        out["topk_" + case] = [s.tolist(), i.tolist()]

    sp = make_mesh(world, axis="sp", device=device)
    q, t = z["lp"]
    for key in LP:
        p = SCORINGS[key]
        for block in BLOCKS:
            blk = None if block == "auto" else int(block)
            rows = plp._run_longpair(q, t, p, sp, "sp", blk, engine, device).cpu()
            ends = longpair_sw_ends(q, t, p, sp, block=blk, device=device)
            out[f"lp_{key}_{block}"] = [rows.tolist(), list(ends)]
        score, path = longpair_sw_align(q, t, p, sp, device=device)
        out[f"lp_{key}_align"] = [score, [list(x) for x in path]]
    saved = plp.STRIP_ROWS  # a strip in sub-strips on every rank
    plp.STRIP_ROWS = SUBSTRIPS
    out["lp_dna_substrips"] = plp._run_longpair(q, t, DNA_111, sp, "sp", 64, engine,
                                                device).cpu().tolist()
    plp.STRIP_ROWS = saved
    try:  # the strips must divide the query (checked before any exchange)
        longpair_sw_ends(q[:-1], t, DNA_111, sp, device=device)
        raise AssertionError("an uneven query was swept")
    except ValueError as e:
        assert "divide" in str(e), e

    for n, argv in enumerate(CLI):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            cli.main(argv + ["--device", device, "--backend", "gloo"])
        out[f"cli_{n}"] = [buf.getvalue(), err.getvalue()]
        if rank:  # the other ranks sweep and print nothing
            assert buf.getvalue() == "" and err.getvalue() == "", (buf.getvalue(), err.getvalue())

    # every rank returns the same results; rank 0 writes them
    mine = json.dumps({k: v for k, v in out.items() if not k.startswith("cli_")},
                      sort_keys=True)
    every = [None] * world
    dist.all_gather_object(every, mine)
    assert all(x == mine for x in every), "the ranks' results differ"
    if rank == 0:
        with open(out_path, "w") as fh:
            json.dump(out, fh)
    dist.destroy_process_group()
    print(f"MESH_OK {rank}")


if __name__ == "__main__":
    main()
