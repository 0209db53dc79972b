"""The port's database search (``swtpu_torch/parallel/search.py``) and
``search`` CLI against the JAX package's, on ``device="cpu"``: the cases
of ``tests/test_parallel.py`` for ``all_vs_all_topk`` (determinism, the
tail chunk, checkpoint resume across the two packages, retry of a
transient fault and no retry of a deterministic error, Gotoh and protein,
the packed wire, the resident database and the fused sweep), a brute-force
top-k by ``np.lexsort((ids, -scores))`` over the oracle copy's scores, an
in-place change to the database (the port searches afresh; the JAX
package's caches key on the held reference and would not), and the CLI's
output byte-equal to ``python -m swtpu search`` on six flag sets. Seed
10000, tolerance 0."""

import contextlib
import io

import numpy as np
import pytest

from swtpu.cli import main as jax_cli
from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu.parallel import search as jsearch
from swtpu_torch import cli as port_cli
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_10_30_15, DNA_111, ScoringParams, dna_matrix
from swtpu_torch.kernels.sw_scan import sw_batch_diag
from swtpu_torch.oracle.affine import sw_affine_score_batch
from swtpu_torch.parallel import search as psearch

SEED = 10000
GOTOH = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
PROTEIN = ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)


def _jp(p):
    return JaxScoring(p.matrix, p.gap_open, p.gap_extend)


def _codes(rng, shape, letters=4):
    return rng.integers(0, letters, shape).astype(np.uint8)


def _brute_topk(Q, T, params, k):
    """(scores, ids) of the top k by (score desc, id asc) over the oracle
    copy's scores of every pair."""
    ref = np.stack([sw_affine_score_batch(np.repeat(Q[i : i + 1], len(T), 0), T, params)
                    for i in range(len(Q))])
    ids = np.arange(len(T))[None, :].repeat(len(Q), 0)
    order = np.lexsort((ids, -ref), axis=1)[:, :k]
    return np.take_along_axis(ref, order, axis=1).astype(np.int32), order


def _same(got, want):
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def modes_case():
    """JAX's streaming search of 3 x 24 queries against 50 x 26 targets,
    k = 4, chunks of 16 (a tail of 2)."""
    rng = np.random.default_rng(SEED)
    qs, ts = _codes(rng, (3, 24)), _codes(rng, (50, 26))
    want = jsearch.all_vs_all_topk(qs, ts, _jp(DNA_10_30_15), k=4, chunk_size=16,
                                   resident=False, packed=False)
    return qs, ts, want


@pytest.mark.parametrize("packed,resident,max_retries", [
    (False, False, 2), (True, False, 2), (False, True, 2), (True, True, 2),
    (True, True, 0), (False, True, 0), ("auto", "auto", 2),
])
def test_search_modes_equal_jax_streaming(modes_case, packed, resident, max_retries):
    qs, ts, want = modes_case
    got = psearch.all_vs_all_topk(qs, ts, DNA_10_30_15, k=4, chunk_size=16,
                                  packed=packed, resident=resident,
                                  max_retries=max_retries, device="cpu")
    _same(got, want)
    _same(got, _brute_topk(qs, ts, DNA_10_30_15, 4))


def test_search_deterministic_with_a_caller_engine():
    rng = np.random.default_rng(SEED)
    Q, T = _codes(rng, (4, 64)), _codes(rng, (48, 64))
    engine = lambda q, t: sw_batch_diag(q, t, DNA_111, "cpu")  # noqa: E731
    got = psearch.all_vs_all_topk(Q, T, DNA_111, k=5, chunk_size=16, engine=engine,
                                  device="cpu")
    _same(got, jsearch.all_vs_all_topk(Q, T, _jp(DNA_111), k=5, chunk_size=16))
    _same(got, _brute_topk(Q, T, DNA_111, 5))
    _same(got, psearch.all_vs_all_topk(Q, T, DNA_111, k=5, chunk_size=16, device="cpu"))


def test_search_tail_chunk_and_k_past_the_database():
    rng = np.random.default_rng(SEED)
    Q, T = _codes(rng, (3, 56)), _codes(rng, (21, 56))  # 8 + 8 + a tail of 5
    got = psearch.all_vs_all_topk(Q, T, DNA_111, k=6, chunk_size=8, device="cpu")
    _same(got, jsearch.all_vs_all_topk(Q, T, _jp(DNA_111), k=6, chunk_size=8))
    _same(got, _brute_topk(Q, T, DNA_111, 6))
    assert (got[1] < len(T)).all()
    # more hits asked than targets: the state's sentinels fill the rest
    s, i = psearch.all_vs_all_topk(Q, T[:3], DNA_111, k=6, chunk_size=8, device="cpu")
    assert (s[:, 3:] == -1).all() and (i[:, 3:] == np.iinfo(np.int32).max).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_search_checkpoint_resume(tmp_path, writer):
    rng = np.random.default_rng(SEED)
    Q, T = _codes(rng, (2, 48)), _codes(rng, (32, 48))
    full = psearch.all_vs_all_topk(Q, T, DNA_111, k=4, chunk_size=8, device="cpu")
    path = str(tmp_path / "cursor.npz")
    # chunks 0..1 by one package, then a "crash" and the port resumes
    if writer == "port":
        psearch.all_vs_all_topk(Q, T[:16], DNA_111, k=4, chunk_size=8, device="cpu",
                                checkpoint=psearch.SearchCheckpoint(path))
    else:
        jsearch.all_vs_all_topk(Q, T[:16], _jp(DNA_111), k=4, chunk_size=8,
                                checkpoint=jsearch.SearchCheckpoint(path))
    assert psearch.SearchCheckpoint(path).load()["cursor"] == 16
    got = psearch.all_vs_all_topk(Q, T, DNA_111, k=4, chunk_size=8, device="cpu",
                                  checkpoint=psearch.SearchCheckpoint(path))
    _same(got, full)
    if writer == "port":  # and the JAX package resumes the port's file
        _same(jsearch.all_vs_all_topk(Q, T, _jp(DNA_111), k=4, chunk_size=8,
                                      checkpoint=jsearch.SearchCheckpoint(path)), full)


def test_search_retries_a_transient_fault():
    rng = np.random.default_rng(SEED)
    Q, T = _codes(rng, (2, 48)), _codes(rng, (16, 48))
    calls = {"n": 0}

    def flaky(q, t):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected fault")
        return sw_batch_diag(q, t, DNA_111, "cpu")

    logged = []
    got = psearch.all_vs_all_topk(Q, T, DNA_111, k=3, chunk_size=8, engine=flaky,
                                  device="cpu", log=logged.append)
    # chunk 1 ok, chunk 2 faulted; the window replays from its start: 1, 2
    assert calls["n"] == 4
    assert sum('"search_chunk_retry"' in x for x in logged) == 1
    _same(got, psearch.all_vs_all_topk(Q, T, DNA_111, k=3, chunk_size=8, device="cpu"))

    def broken(q, t):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="always"):
        psearch.all_vs_all_topk(Q, T, DNA_111, k=3, chunk_size=8, engine=broken,
                                device="cpu", max_retries=0, resident=False)


def test_search_deterministic_error_not_retried():
    rng = np.random.default_rng(SEED)
    Q, T = _codes(rng, (2, 48)), _codes(rng, (16, 48))
    calls = {"n": 0}

    def broken(q, t):
        calls["n"] += 1
        raise ValueError("deterministic config error")

    with pytest.raises(ValueError, match="deterministic"):
        psearch.all_vs_all_topk(Q, T, DNA_111, k=3, chunk_size=8, engine=broken,
                                device="cpu")
    assert calls["n"] == 1


@pytest.mark.parametrize("name", ["gotoh", "protein"])
def test_search_gotoh_and_protein_equal_jax(name):
    rng = np.random.default_rng(SEED)
    if name == "gotoh":
        p, Q, T, k = GOTOH, _codes(rng, (4, 40)), _codes(rng, (16, 40)), 3
    else:
        p, Q, T, k = PROTEIN, _codes(rng, (2, 32), 20), _codes(rng, (19, 32), 20), 4
    got = psearch.all_vs_all_topk(Q, T, p, k=k, chunk_size=8, device="cpu")
    _same(got, jsearch.all_vs_all_topk(Q, T, _jp(p), k=k, chunk_size=8))
    _same(got, _brute_topk(Q, T, p, k))
    # the 2-bit wire takes DNA codes only
    with pytest.raises(ValueError, match="2-bit"):
        psearch.all_vs_all_topk(Q, T if name == "protein" else T + 4, p, k=k,
                                chunk_size=8, device="cpu", packed=True)


@pytest.mark.parametrize("packed", [False, True])
def test_search_after_an_in_place_change_is_fresh(packed):
    rng = np.random.default_rng(SEED)
    Q, T = _codes(rng, (3, 24)), _codes(rng, (40, 24))
    first = psearch.all_vs_all_topk(Q, T, DNA_10_30_15, k=4, chunk_size=16,
                                    resident=True, packed=packed, device="cpu")
    T[7] = Q[0]  # the same array object, one row changed in place
    T[30] = Q[2]
    got = psearch.all_vs_all_topk(Q, T, DNA_10_30_15, k=4, chunk_size=16,
                                  resident=True, packed=packed, device="cpu")
    fresh = psearch.all_vs_all_topk(Q, T.copy(), DNA_10_30_15, k=4, chunk_size=16,
                                    resident=False, packed=False, device="cpu")
    _same(got, fresh)
    assert got[1][0, 0] == 7 and got[1][2, 0] == 30 and not np.array_equal(got[1], first[1])


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


CLI_ARGS = {
    "json": ["--random", "4x40x48", "--topk", "3", "--chunk", "16"],
    "tsv": ["--random", "4x40x48", "--topk", "3", "--chunk", "16", "--tsv"],
    "tsv_preset_protein": ["--alphabet", "protein", "--random", "4x24x32", "--topk", "3",
                           "--chunk", "16", "--gap-open", "11", "--gap-extend", "1",
                           "--tsv", "--stats", "preset"],
    "tsv_calibrate": ["--random", "4x40x48", "--topk", "3", "--chunk", "16", "--tsv",
                      "--stats", "calibrate", "--calibrate-pairs", "256"],
    "both_strands_tsv": ["--random", "4x40x48", "--topk", "3", "--chunk", "16",
                         "--both-strands", "--tsv"],
    "sam": ["--random", "4x40x48", "--topk", "3", "--chunk", "16", "--sam"],
}


@pytest.mark.parametrize("mode", list(CLI_ARGS))
def test_cli_search_output_equals_jax(mode):
    argv = ["search"] + CLI_ARGS[mode]
    want, want_err = _run(jax_cli, argv)
    got, got_err = _run(port_cli.main, argv + ["--device", "cpu"])
    assert got == want and len(got.splitlines()) >= 4
    assert got_err == want_err  # the karlin-altschul line under --stats
    if mode == "tsv_preset_protein":  # E-values fall as bit scores rise
        rows = [r.split("\t") for r in got.splitlines()]
        assert rows and all(len(r) == 12 for r in rows)
        for q in {r[0] for r in rows}:
            pairs = sorted((float(r[11]), float(r[10])) for r in rows if r[0] == q)
            assert all(a[1] >= b[1] for a, b in zip(pairs, pairs[1:]))
