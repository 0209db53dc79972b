"""Block-adaptive banded X-drop alignment (the block tier) and the banded
device walkers: port vs JAX.

The same numpy inputs (seed 10000) go through the JAX package and the
port, tolerance 0:

- the oracle copy (``oracle.banded_block``) against ``swtpu``'s on every
  function: both forwards' returned state, ``reconstruct_block_ef`` and
  both walkers;
- the port's ``banded_block_batch(device="cpu")`` (the plain B9 and B10
  under the host loop) against ``swtpu``'s oracle field by field: score,
  endpoint, n_rows, bases and deltas up to n_rows, the history, and the
  host-walked paths; homologous, random, a tail block with early death,
  tie-rich (2,1,1), BLOSUM62, batches past 128 pairs, an all-dead start,
  Gotoh, open == extend routed to linear, per-pair lengths with pairs
  that end inside a block, an explicit dmax, negative gap penalties (the
  plain tier's serial chain);
- the plain mirror of the one-launch forward's schedule
  (``block_forward`` on CPU tensors: per-pair early stop, the corridor
  window read in place, each row as a warp computes it) against the plain
  loop in every field, whole (history, bases and deltas past each pair's
  end, the carry and state), and against ``swtpu``'s oracle pair by pair,
  at W in {16, 64, 128} with K = 1 and 129 - W, early death, per-pair
  lengths, Gotoh (open below extend too) and BLOSUM62, both early-exit
  modes; the route by gap sign on a faked card (negative penalties take
  the per-block kernels);
- one interpret-mode call of ``banded_block_batch_pallas`` (about 13 s),
  equal to the port field for field below each pair's n_rows; the JAX
  device walk takes about 26 s in interpret mode, so the port's walk is
  held against the oracle instead;
- ``banded_block_align_device(device="cpu")`` (lengths included) against
  the oracle's (score, path); the port's ``decode_device_walk`` against
  ``swtpu``'s on the same wire bytes;
- ``banded_xdrop_align_device(device="cpu")`` against JAX's XLA
  ``banded_xdrop_align_device`` and against ``banded_align_batch``;
- the guards; the ``banded --block-adaptive`` CLI (DNA, protein, Gotoh,
  per-pair lengths, ``--traceback``, ``--cigar``) against records built
  from ``swtpu``'s oracle (JAX runs the tier only on a TPU), and its two
  refusals.

The CUDA kernels are held against their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import contextlib
import io
import types

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.core.encode import mutate
from swtpu.core.protein import BLOSUM62
from swtpu.kernels.pallas.banded_block import banded_block_batch_pallas
from swtpu.kernels.xla import banded_scan as jax_scan
from swtpu.oracle import banded_block as jax_block
from swtpu_torch.batch import banded_align_batch
from swtpu_torch.cli import main as port_cli
from swtpu_torch.core.io import write_fasta
from swtpu_torch.kernels import banded_block, banded_scan, device_walk
from swtpu_torch.oracle import banded_block as port_block

SEED = 10000


def dna_set(B=6, n=100, m=100, homologous=True, seed=SEED):
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    if homologous:
        ts = np.stack([mutate(rng, q, out_len=m) for q in qs])
    else:
        ts = rng.integers(0, 4, size=(B, m)).astype(np.uint8)
    return qs, ts, rng


def protein_set(B=5, n=90, seed=SEED):
    rng = np.random.default_rng(seed)
    pq = rng.integers(0, 20, size=(B, n)).astype(np.uint8)
    pt = pq.copy()
    for b in range(B):
        idx = rng.integers(0, n, n // 3)
        pt[b, idx] = rng.integers(0, 20, n // 3)
    return pq, pt, rng


def jax_oracle(q, t, kw):
    """swtpu's oracle on one pair with a forward's keyword arguments."""
    okw = {k: kw[k] for k in ("match", "mismatch", "width", "block", "x_threshold",
                              "dmax", "matrix") if k in kw}
    go, ge = kw.get("gap_open"), kw.get("gap_extend")
    if go is not None and go != ge:
        return jax_block.banded_xdrop_block_affine(
            q, t, gap_open=go, gap_extend=ge, return_state=True, **okw)
    gap = go if go is not None else kw.get("gap", 1)
    return jax_block.banded_xdrop_block(q, t, gap=gap, return_state=True, **okw)


def assert_pair(res, paths, p, ora, K):
    """One pair of a batched forward result (host arrays) against an oracle
    state, field by field."""
    nr = ora.n_rows
    assert int(res.score[p]) == ora.score, p
    assert (int(res.end_y[p]), int(res.end_j[p])) == ora.end, p
    assert int(res.n_rows[p]) == nr, p
    nb = -(-nr // K)
    np.testing.assert_array_equal(res.bases[:nb, p], ora.bases[:nb], err_msg=str(p))
    np.testing.assert_array_equal(res.deltas[:nb, p], ora.deltas[:nb], err_msg=str(p))
    np.testing.assert_array_equal(res.band_history[:nr, :, p], ora.band_history,
                                  err_msg=str(p))
    assert paths[p] == ora.path, p


def lens_with_enders(rng, B, n, m, K):
    """Per-pair lengths, most of them ending inside a block, one of 0."""
    lq = rng.integers(n // 3, n + 1, B)
    lq[lq % K == 0] -= 1
    lq[0] = 0
    return lq, rng.integers(m // 3, m + 1, B)


# case -> (set, forward keyword arguments, use lengths)
CASES = {
    "homologous_w32_k16": ("dna", dict(width=32, block=16), False),
    "random_w16_k8": ("random", dict(width=16, block=8), False),
    "tie_rich_211_w32_k8": ("dna", dict(width=32, block=8, match=2), False),
    "harsh_tail_w16_k16": ("tail", dict(width=16, block=16, mismatch=3, gap=2,
                                        x_threshold=12), False),
    "blosum62_w32_k16": ("protein", dict(width=32, block=16, matrix=BLOSUM62,
                                         x_threshold=60), False),
    "blosum62_gotoh_w16_k8": ("protein", dict(width=16, block=8, matrix=BLOSUM62,
                                              gap_open=11, gap_extend=1,
                                              x_threshold=60), False),
    "gotoh_31_w32_k16": ("dna", dict(width=32, block=16, gap_open=3, gap_extend=1),
                         False),
    "gotoh_open_lt_extend_w16_k8": ("dna", dict(width=16, block=8, gap_open=1,
                                                gap_extend=2), False),
    "open_eq_extend_is_linear": ("dna", dict(width=32, block=8, gap=5, gap_open=2,
                                             gap_extend=2), False),
    "varlen_w32_k16": ("dna", dict(width=32, block=16, x_threshold=30), True),
    "varlen_blosum62_w16_k8": ("protein", dict(width=16, block=8, matrix=BLOSUM62,
                                               x_threshold=40), True),
    "dmax_16_w32_k8": ("dna", dict(width=32, block=8, dmax=16), False),
    "negative_gap_w16_k8": ("dna", dict(width=16, block=8, gap=-1, x_threshold=20),
                            False),
    "gotoh_negative_extend_w16_k8": ("dna", dict(width=16, block=8, gap_open=2,
                                                 gap_extend=-1, x_threshold=20), False),
    "batch_130_w16_k16": ("wide", dict(width=16, block=16, x_threshold=20), False),
}


def case_inputs(case):
    kind, kw, lens = CASES[case]
    kw = dict(kw)
    if kind == "protein":
        qs, ts, rng = protein_set()
    elif kind == "wide":
        qs, ts, rng = dna_set(B=130, n=40, m=48, homologous=False)
    elif kind == "tail":  # n % K != 0; the random last pair dies early
        qs, ts, rng = dna_set(n=77, m=90)
        ts[-1] = rng.integers(0, 4, size=90)
    else:
        qs, ts, rng = dna_set(homologous=kind == "dna")
    if lens:
        kw["lens_q"], kw["lens_t"] = lens_with_enders(rng, len(qs), qs.shape[1],
                                                      ts.shape[1], kw["block"])
    return qs, ts, kw


def oracle_pairs(qs, ts, kw):
    lq, lt = kw.get("lens_q"), kw.get("lens_t")
    for p in range(len(qs)):
        yield p, jax_oracle(qs[p, : qs.shape[1] if lq is None else lq[p]],
                            ts[p, : ts.shape[1] if lt is None else lt[p]], kw)


# -- the oracle copy ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["linear", "matrix", "affine", "affine_matrix",
                                  "varlen_tail"])
def test_oracle_copy_equals_jax(mode):
    qs, ts, rng = protein_set(B=3, n=70) if "matrix" in mode else dna_set(B=3, n=70)
    kw = dict(width=16, block=8, x_threshold=40,
              matrix=BLOSUM62 if "matrix" in mode else None)
    if mode == "varlen_tail":
        qs, ts = qs[:, :61], ts[:, :53]
    for q, t in zip(qs, ts):
        if mode.startswith("affine"):
            args = (q, t)
            akw = dict(kw, gap_open=5, gap_extend=1, return_state=True)
            got = port_block.banded_xdrop_block_affine(*args, **akw)
            want = jax_block.banded_xdrop_block_affine(*args, **akw)
        else:
            got = port_block.banded_xdrop_block(q, t, return_state=True, **kw)
            want = jax_block.banded_xdrop_block(q, t, return_state=True, **kw)
        assert (got.score, got.path, got.end, got.n_rows) == (
            want.score, want.path, want.end, want.n_rows)
        for f in ("band_history", "row_base", "bases", "deltas"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        # the walkers and the E/F reconstruction on the same state
        h, rb, end = want.band_history, want.row_base, want.end
        wkw = dict(x_threshold=40, matrix=kw["matrix"])
        if mode.startswith("affine"):
            for g, w in zip(port_block.reconstruct_block_ef(h, rb, 5, 1, 40),
                            jax_block.reconstruct_block_ef(h, rb, 5, 1, 40)):
                np.testing.assert_array_equal(g, w)
            assert port_block.walk_block_history_affine(
                h, rb, end, q, t, gap_open=5, gap_extend=1, **wkw
            ) == jax_block.walk_block_history_affine(
                h, rb, end, q, t, gap_open=5, gap_extend=1, **wkw) == want.path
        else:
            assert port_block.walk_block_history(h, rb, end, q, t, **wkw) == (
                jax_block.walk_block_history(h, rb, end, q, t, **wkw)) == want.path


# -- the plain tier against the oracle ----------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_forward_equals_oracle(case):
    qs, ts, kw = case_inputs(case)
    res = banded_block.banded_block_batch(qs, ts, with_history=True, with_meta=True,
                                          device="cpu", **kw)
    assert res.score.device.type == "cpu"
    res = res.numpy()
    walk_kw = {k: v for k, v in kw.items()
               if k in ("match", "mismatch", "gap", "x_threshold", "matrix",
                        "gap_open", "gap_extend")}
    K = kw["block"]
    lq, lt = kw.get("lens_q"), kw.get("lens_t")
    trim = (lambda x, ls: x if ls is None else  # noqa: E731
            [x[p, : ls[p]] for p in range(len(x))])
    paths = banded_block.banded_block_traceback_host(
        res, trim(qs, lq), trim(ts, lt), block=K, **walk_kw)
    deaths = 0
    for p, ora in oracle_pairs(qs, ts, kw):
        assert_pair(res, paths, p, ora, K)
        deaths += ora.n_rows < (qs.shape[1] if lq is None else lq[p])
    if case == "harsh_tail_w16_k16":
        assert deaths >= 1 and qs.shape[1] % K
    if case.startswith("varlen"):
        assert ((lq % K) != 0).sum() >= len(qs) - 1


def test_all_dead_start():
    """Every cell dies at once: score 0, end (0, 0), path [(0, 0)]."""
    z, o = np.zeros((3, 40), np.uint8), np.ones((3, 40), np.uint8)
    kw = dict(width=16, block=8, x_threshold=1, mismatch=5, gap=5)
    res = banded_block.banded_block_batch(z, o, with_history=True, with_meta=True,
                                          device="cpu", **kw).numpy()
    paths = banded_block.banded_block_traceback_host(res, z, o, block=8, mismatch=5,
                                                     gap=5, x_threshold=1)
    for p, ora in oracle_pairs(z, o, kw):
        assert ora.end == (0, 0) and ora.path == [(0, 0)]
        assert_pair(res, paths, p, ora, 8)
    assert banded_block.banded_block_align_device(z, o, device="cpu", **kw) == [
        (0, [(0, 0)])] * 3


def test_wrapper_equals_pallas():
    """One interpret-mode Pallas call: every field below n_rows."""
    qs, ts, _ = dna_set(B=4, n=64, m=64)
    ts[-1] = np.random.default_rng(SEED + 1).integers(0, 4, size=64)
    kw = dict(width=32, block=16, with_history=True, with_meta=True)
    with pltpu.force_tpu_interpret_mode():
        want = banded_block_batch_pallas(qs, ts, **kw)
    got = banded_block.banded_block_batch(qs, ts, device="cpu", **kw).numpy()
    for f in ("score", "end_y", "end_j", "n_rows"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for p in range(4):
        nr = int(got.n_rows[p])
        nb = -(-nr // 16)
        np.testing.assert_array_equal(got.band_history[:nr, :, p],
                                      want.band_history[:nr, :, p])
        np.testing.assert_array_equal(got.bases[:nb, p], want.bases[:nb, p])
        np.testing.assert_array_equal(got.deltas[:nb, p], want.deltas[:nb, p])


# -- the one-launch forward's schedule ------------------------------------------

# case -> (set, forward keyword arguments, use lengths)
SCHEDULE_CASES = {
    "w16_k1": ("dna", dict(width=16, block=1), False),
    "w16_k113_tail_only": ("tail", dict(width=16, block=113, mismatch=3, gap=2,
                                        x_threshold=12), False),
    "w16_k8_early_death": ("random", dict(width=16, block=8, mismatch=3, gap=2,
                                          x_threshold=10), False),
    "w64_k1": ("dna", dict(width=64, block=1, match=2), False),
    "w64_k65_gotoh": ("dna", dict(width=64, block=65, gap_open=3, gap_extend=1),
                      False),
    "w64_k65_varlen": ("dna", dict(width=64, block=65, x_threshold=30), True),
    "w128_k1_blosum62": ("protein", dict(width=128, block=1, matrix=BLOSUM62,
                                         x_threshold=60), False),
    "w128_k1_gotoh_open_lt_extend": ("dna", dict(width=128, block=1, gap_open=1,
                                                 gap_extend=2), False),
    "w48_k16_dmax_past_block": ("dna", dict(width=48, block=16, dmax=20,
                                            x_threshold=25), False),
}


def schedule_inputs(case):
    kind, kw, lens = SCHEDULE_CASES[case]
    kw = dict(kw)
    if kind == "protein":
        qs, ts, rng = protein_set()
    elif kind == "tail":
        qs, ts, rng = dna_set(n=77, m=90)
        ts[-1] = rng.integers(0, 4, size=90)
    else:
        qs, ts, rng = dna_set(homologous=kind == "dna")
    if lens:
        kw["lens_q"], kw["lens_t"] = lens_with_enders(rng, len(qs), qs.shape[1],
                                                      ts.shape[1], kw["block"])
    return qs, ts, kw


def run_of(qs, ts, kw, with_history=True):
    """A forward's device state on the CPU (``banded_block._Run``)."""
    g = kw.get
    return banded_block._setup(
        qs, ts, g("match", 1), g("mismatch", 1), g("gap", 1), kw["width"], kw["block"],
        g("x_threshold", 70), g("dmax"), g("matrix"), with_history, g("gap_open"),
        g("gap_extend"), g("lens_q"), g("lens_t"), "cpu")


RUN_FIELDS = ("state", "n_rows", "bases", "deltas", "hist", "carried", "done")


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_forward_schedule_mirror(case, early_exit):
    qs, ts, kw = schedule_inputs(case)
    mirror, loop = run_of(qs, ts, kw), run_of(qs, ts, kw)
    before = banded_block.block_forward.launches
    banded_block.block_forward(mirror, early_exit)  # CPU tensors: the mirror
    assert banded_block.block_forward.launches == before
    banded_block._forward(loop, early_exit)  # the plain loop
    for f in RUN_FIELDS:
        assert torch.equal(getattr(mirror, f), getattr(loop, f)), f
    K = kw["block"]
    res = banded_block._result(mirror, True).numpy()
    walk_kw = {k: v for k, v in kw.items()
               if k in ("match", "mismatch", "gap", "x_threshold", "matrix",
                        "gap_open", "gap_extend")}
    lq, lt = kw.get("lens_q"), kw.get("lens_t")
    trim = (lambda x, ls: x if ls is None else  # noqa: E731
            [x[p, : ls[p]] for p in range(len(x))])
    paths = banded_block.banded_block_traceback_host(
        res, trim(qs, lq), trim(ts, lt), block=K, **walk_kw)
    deaths = 0
    for p, ora in oracle_pairs(qs, ts, kw):
        assert_pair(res, paths, p, ora, K)
        deaths += ora.n_rows < (qs.shape[1] if lq is None else lq[p])
    if case == "w16_k8_early_death":
        assert deaths == len(qs) and max(res.n_rows) <= 4 * K  # all done before a poll


def test_forward_schedule_mirror_refuses_negative_gaps():
    qs, ts, _ = dna_set(B=2, n=30, m=30)
    for kw in (dict(gap=-1), dict(gap_open=2, gap_extend=-1)):
        with pytest.raises(ValueError, match=">= 0"):
            banded_block.block_forward(run_of(qs, ts, dict(kw, width=16, block=8)))


@pytest.mark.parametrize("kw,route", [
    (dict(), "one launch"), (dict(gap=0), "one launch"),
    (dict(gap_open=3, gap_extend=1), "one launch"),
    (dict(gap=-1), "per block"), (dict(gap_open=2, gap_extend=-1), "per block"),
    (dict(gap_open=-1, gap_extend=1), "per block"),
])
def test_forward_routes_by_gap_sign_on_a_faked_card(monkeypatch, kw, route):
    """On the card, gap penalties >= 0 run the one-launch forward; a
    negative penalty (the oracle's serial chain) the per-block kernels."""
    qs, ts, _ = dna_set(B=2, n=30, m=30)
    run = run_of(qs, ts, dict(kw, width=16, block=8))
    calls = []
    monkeypatch.setattr(banded_block, "block_forward",
                        lambda r, early_exit=True: calls.append("one launch") or r)
    monkeypatch.setattr(banded_block, "block_loop",
                        lambda r, early_exit=True, *a: calls.append("per block") or r)
    run.qT = types.SimpleNamespace(device=torch.device("cuda"))
    banded_block._forward(run)
    assert calls == [route]


# -- B10 -----------------------------------------------------------------------


def test_gather_plain_window():
    """win[c, b] = t[b, base_b + c - 1], -1 outside the target, at bases
    below the front guard and past the end."""
    rng = np.random.default_rng(SEED)
    t = rng.integers(0, 4, size=(5, 30)).astype(np.int16)
    t[2, 20:] = -1  # a pair's length
    bases = np.array([-70, -3, 1, 25, 40], np.int32)
    win = banded_block.block_gather_plain(torch.from_numpy(t), torch.from_numpy(bases),
                                          9).numpy()
    for b in range(5):
        for c in range(9):
            pos = bases[b] + c - 1
            assert win[c, b] == (t[b, pos] if 0 <= pos < 30 else -1)


# -- device walks --------------------------------------------------------------


@pytest.mark.parametrize("case", ["homologous_w32_k16", "varlen_w32_k16",
                                  "blosum62_w32_k16", "tie_rich_211_w32_k8"])
def test_align_device_equals_oracle(case):
    qs, ts, kw = case_inputs(case)
    got = banded_block.banded_block_align_device(qs, ts, device="cpu", **kw)
    assert got == [(ora.score, ora.path) for _, ora in oracle_pairs(qs, ts, kw)]


def test_decode_equals_jax_on_the_same_wire():
    qs, ts, kw = case_inputs("varlen_w32_k16")
    run = banded_block._setup(qs, ts, 1, 1, 1, 32, 16, 30, None, None, True, None,
                              None, kw["lens_q"], kw["lens_t"], "cpu")
    wire = device_walk.block_walk(banded_block._forward(run)).numpy()
    assert wire.shape == (6, 20 + 256 // 4)  # 201 steps padded to 256
    got = banded_scan.decode_device_walk(wire)
    assert got == jax_scan.decode_device_walk(wire)
    gs, gl, gp = banded_scan.decode_device_walk(wire, as_arrays=True)
    ws, wl, wp = jax_scan.decode_device_walk(wire, as_arrays=True)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gl, wl)
    for b in range(len(gl)):  # past each path's length the buffers are unspecified
        np.testing.assert_array_equal(gp[b, : gl[b]], wp[b, : wl[b]])
    bad = wire.copy()
    bad[3, 16] = 0  # ok = 0: a stalled walk
    with pytest.raises(AssertionError, match="pair 3"):
        banded_scan.decode_device_walk(bad)


def test_xdrop_align_device_equals_jax():
    qs, ts, rng = dna_set(B=5, n=90, m=90)
    lq, lt = rng.integers(40, 91, 5), rng.integers(40, 91, 5)
    kw = dict(bandwidth=16, x_threshold=40)
    got = banded_scan.banded_xdrop_align_device(qs, ts, lq, lt, device="cpu", **kw)
    assert got == jax_scan.banded_xdrop_align_device(qs, ts, lq, lt, **kw)
    assert got == banded_align_batch(qs, ts, lq, lt, device="cpu", **kw)


# -- guards --------------------------------------------------------------------


@pytest.mark.parametrize("kw,err,match", [
    (dict(width=40), ValueError, "multiple of 16"),
    (dict(width=32, dmax=0), ValueError, "dmax"),
    (dict(width=64, block=66), ValueError, "129"),
    (dict(gap_open=3, gap_extend=1, lens_q=[5, 5]), NotImplementedError, "lens"),
])
def test_guards(kw, err, match):
    q = np.zeros((2, 20), np.uint8)
    with pytest.raises(err, match=match):
        banded_block.banded_block_batch(q, q, device="cpu", **kw)


def test_align_device_guards():
    q = np.zeros((2, 20), np.uint8)
    with pytest.raises(ValueError, match="129"):  # JAX checks this only in the forward
        banded_block.banded_block_align_device(q, q, width=96, block=48, device="cpu")
    run = banded_block._setup(q, q, 1, 1, 1, 16, 8, 30, None, None, True, 3, 1, None,
                              None, "cpu")
    with pytest.raises(NotImplementedError, match="linear-gap"):
        device_walk.block_walk(run)


# -- the CLI -------------------------------------------------------------------


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_cli(argv + ["--device", "cpu"])
    return buf.getvalue().splitlines()


def _random(spec, alphabet="dna", seed=SEED):
    b, n, m = (int(x) for x in spec.split("x"))
    rng = np.random.default_rng(seed)
    hi = 4 if alphabet == "dna" else 20
    return (rng.integers(0, hi, size=(b, n)).astype(np.uint8),
            rng.integers(0, hi, size=(b, m)).astype(np.uint8))


@pytest.mark.parametrize("argv,kw", [
    (["--random", "5x90x100", "--bandwidth", "16"], dict()),
    (["--random", "4x90x90", "--bandwidth", "16", "--gap-open", "3", "--gap-extend",
      "1", "--scoring", "2,-1"], dict(match=2, gap_open=3, gap_extend=1)),
    (["--alphabet", "protein", "--random", "4x80x80", "--bandwidth", "8",
      "--x-drop", "120"], dict(matrix=BLOSUM62, x_threshold=120)),
    (["--random", "5x90x100", "--bandwidth", "16", "--traceback", "--cigar"],
     dict()),
])
def test_cli_equals_oracle(argv, kw):
    from swtpu.core.cigar import path_to_cigar

    alphabet = "protein" if "protein" in argv else "dna"
    qs, ts = _random(argv[argv.index("--random") + 1], alphabet)
    bw = int(argv[argv.index("--bandwidth") + 1])
    kw = dict(kw, width=2 * bw, block=bw)
    lines = [json_load(x) for x in _run(["banded", "--block-adaptive"] + argv)]
    assert len(lines) == len(qs)
    for rec, (p, ora) in zip(lines, oracle_pairs(qs, ts, kw)):
        want = dict(pair=f"pair{p}", score=ora.score)
        if "--traceback" in argv or "--cigar" in argv:
            want.update(start=list(ora.path[0]), end=list(ora.path[-1]))
            if "--traceback" in argv:
                want["path"] = [list(x) for x in ora.path]
            if "--cigar" in argv:
                want["cigar"] = path_to_cigar(ora.path, qs[p], ts[p])
        else:
            want["end"] = list(ora.end)
        assert rec == want


def json_load(line):
    import json

    return json.loads(line)


@pytest.mark.parametrize("extra", [[], ["--cigar"]])
def test_cli_varlen_equals_oracle(tmp_path, extra):
    from swtpu.core.cigar import path_to_cigar

    qs, ts, rng = dna_set(B=5, n=90, m=100)
    lq, lt = lens_with_enders(rng, 5, 90, 100, 16)
    lq[0] = 7
    dec = "ACGT"
    write_fasta(str(tmp_path / "q.fa"), [(f"q{p}", "".join(dec[c] for c in qs[p, :lq[p]]))
                                         for p in range(5)])
    write_fasta(str(tmp_path / "t.fa"), [(f"t{p}", "".join(dec[c] for c in ts[p, :lt[p]]))
                                         for p in range(5)])
    lines = [json_load(x) for x in _run(
        ["banded", "--block-adaptive", "--queries", str(tmp_path / "q.fa"), "--targets",
         str(tmp_path / "t.fa"), "--bandwidth", "16", "--x-drop", "30"] + extra)]
    kw = dict(width=32, block=16, x_threshold=30, lens_q=lq, lens_t=lt)
    for rec, (p, ora) in zip(lines, oracle_pairs(qs, ts, kw)):
        assert rec["pair"] == f"q{p}|t{p}" and rec["score"] == ora.score
        if extra:
            assert rec["start"] == [0, 0] and rec["end"] == list(ora.path[-1])
            assert rec["cigar"] == path_to_cigar(ora.path, qs[p, :lq[p]], ts[p, :lt[p]])
        else:
            assert rec["end"] == list(ora.end)


def test_cli_refusals(tmp_path):
    with pytest.raises(SystemExit, match="affine traceback"):
        _run(["banded", "--block-adaptive", "--random", "2x40x40", "--gap-open", "3",
              "--cigar"])
    write_fasta(str(tmp_path / "q.fa"), [("a", "ACGTACGT"), ("b", "ACG")])
    write_fasta(str(tmp_path / "t.fa"), [("a", "ACGTACGT"), ("b", "ACGTA")])
    with pytest.raises(SystemExit, match="uniform lengths"):
        _run(["banded", "--block-adaptive", "--queries", str(tmp_path / "q.fa"),
              "--targets", str(tmp_path / "t.fa"), "--gap-open", "3"])
