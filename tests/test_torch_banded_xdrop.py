"""Adaptive-banded X-drop semi-global alignment (per-round band): port vs
JAX.

The same numpy inputs (seed 10000) go through the JAX package and the
port, tolerance 0:

- the oracle copies (``banded_xdrop``, ``banded_affine_xdrop``) against
  ``swtpu``'s, every field of their returned state and the paths;
- the plain tier (``kernels.banded_scan.banded_xdrop_batch``) against the
  XLA tier ``swtpu.kernels.xla.banded_scan.banded_xdrop_batch`` in every
  field (scores, max rounds, round counts, the whole history, pos_y and
  offsets): linear, Gotoh, BLOSUM62 11/1 at X = 120, per-pair lengths,
  the 8-bit history, a dissimilar pair, harsh scoring where bands die
  early, W in {8, 32, 64, 96} and W = 100;
- ``reconstruct_affine_bands``, ``banded_walk_batch`` and
  ``banded_align_batch(device="cpu")`` against JAX's;
- the kernel wrapper at ``device="cpu"`` against one interpret-mode call
  of ``banded_xdrop_batch_pallas`` (about 11 s). The packed kernel
  ``banded_xdrop_batch_packed`` takes about 65 s in interpret mode, so it
  is not called here: JAX's own tests hold it equal to the oracle;
- the ``banded`` CLI against ``swtpu banded``.

The CUDA kernel itself is held against the plain tier on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import contextlib
import io

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from swtpu.batch import banded_align_batch as jax_align
from swtpu.batch import banded_walk_batch as jax_walk
from swtpu.batch.traceback import reconstruct_affine_bands as jax_reconstruct
from swtpu.cli import main as jax_cli
from swtpu.core.encode import mutate
from swtpu.core.protein import BLOSUM62
from swtpu.kernels.pallas.banded_batch import banded_xdrop_batch_pallas
from swtpu.kernels.xla import banded_scan as jax_scan
from swtpu.oracle import banded_affine as jax_affine
from swtpu.oracle import semiglobal as jax_oracle
from swtpu_torch.batch import (
    banded_align_batch,
    banded_forward_batch,
    banded_walk_batch,
    reconstruct_affine_bands,
)
from swtpu_torch.cli import main as port_cli
from swtpu_torch.kernels import banded_batch, banded_scan
from swtpu_torch.oracle import banded_affine, semiglobal

L, B = 120, 8


def dna_set(seed=10000, n=L, m=L, B=B):
    """B related pairs (about 70% identity, the reference's generator),
    the last one dissimilar, and per-pair lengths."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    ts = np.stack([mutate(rng, qs[b], out_len=m) for b in range(B)])
    ts[-1] = rng.integers(0, 4, size=m)
    lq, lt = rng.integers(n // 2, n + 1, B), rng.integers(m // 2, m + 1, B)
    return qs, ts, lq, lt


def protein_set(seed=10000, n=L, B=B):
    """~70%-identity protein pairs (bench_suite's protein X-drop set)."""
    rng = np.random.default_rng(seed)
    pq = rng.integers(0, 24, size=(B, n)).astype(np.uint8)
    pt = pq.copy()
    for b in range(B):
        idx = rng.integers(0, n, n // 3)
        pt[b, idx] = rng.integers(0, 24, n // 3)
    return pq, pt, rng.integers(n // 2, n + 1, B), rng.integers(n // 2, n + 1, B)


# case -> (inputs, keyword arguments); each is one XLA compile on the JAX side
CASES = {
    "linear_w32_varlen": ("dna", dict(lens=True)),
    "gotoh_w32_compressed": ("dna", dict(gap_open=3, gap_extend=1,
                                         compress_history=True)),
    "blosum62_gotoh_x120_varlen": ("protein", dict(
        matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120, lens=True)),
    "harsh_w8_x40": ("dna", dict(mismatch=3, gap=2, x_threshold=40, bandwidth=8)),
    "w64_x100": ("dna", dict(bandwidth=64, x_threshold=100)),
    "w96_gotoh_2351": ("dna", dict(bandwidth=96, match=2, mismatch=3, gap_open=5,
                                   gap_extend=1, lens=True)),
    "w100": ("dna", dict(bandwidth=100)),
}


def case_inputs(case):
    kind, kw = CASES[case]
    kw = dict(kw)
    qs, ts, lq, lt = dna_set() if kind == "dna" else protein_set()
    if kw.pop("lens", False):
        kw.update(lens_q=lq, lens_t=lt)
    return qs, ts, kw


def assert_same(port_res, jax_res):
    port_res = port_res.numpy()
    for f in ("score", "max_round", "n_rounds", "band_history", "pos_y", "offsets"):
        want, got = getattr(jax_res, f), getattr(port_res, f)
        if want is None:
            assert got is None, f
            continue
        want = np.asarray(want)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


# -- the oracle copies --------------------------------------------------


@pytest.mark.parametrize("mode", ["linear", "harsh", "matrix", "affine",
                                  "affine_matrix"])
def test_oracle_copies_equal_jax(mode):
    qs, ts, lq, lt = dna_set(n=60, m=64, B=4)
    kw = dict(bandwidth=16, x_threshold=30)
    if mode == "harsh":
        kw.update(match=1, mismatch=3, x_threshold=15)
    if mode.endswith("matrix"):
        qs, ts, lq, lt = protein_set(n=60, B=4)
        kw.update(matrix=BLOSUM62, x_threshold=60)
    for b in range(len(qs)):
        q, t = qs[b, : lq[b]], ts[b, : lt[b]]
        if mode.startswith("affine"):
            got = banded_affine.banded_affine_xdrop(q, t, gap_open=4, gap_extend=1,
                                                    return_state=True, **kw)
            want = jax_affine.banded_affine_xdrop(q, t, gap_open=4, gap_extend=1,
                                                  return_state=True, **kw)
            fields = ("h_hist", "e_hist", "f_hist", "pos_y")
        else:
            gap = 2 if mode == "harsh" else 1
            got = semiglobal.banded_xdrop(q, t, gap=gap, return_state=True, **kw)
            want = jax_oracle.banded_xdrop(q, t, gap=gap, return_state=True, **kw)
            fields = ("band_history", "pos_y", "pos_x")
        assert (got.score, got.path, got.n_rounds, got.max_round) == (
            want.score, want.path, want.n_rounds, want.max_round)
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# -- the plain tier against the XLA tier --------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_xla(case):
    qs, ts, kw = case_inputs(case)
    want = jax_scan.banded_xdrop_batch(qs, ts, **kw)
    got = banded_scan.banded_xdrop_batch(qs, ts, device="cpu", **kw)
    assert got.score.device.type == "cpu"
    assert_same(got, want)
    if case == "harsh_w8_x40":  # the dissimilar pair's band dies early
        rounds = got.n_rounds.numpy()
        assert rounds[-1] < rounds[:-1].min()


def test_plain_without_history_equals_xla():
    qs, ts, kw = case_inputs("gotoh_w32_compressed")
    kw["compress_history"] = False
    want = jax_scan.banded_xdrop_batch(qs, ts, with_history=False, **kw)
    got = banded_scan.banded_xdrop_batch(qs, ts, with_history=False, device="cpu",
                                         **kw)
    assert_same(got, want)


def test_compressed_history_round_trips():
    qs, ts, kw = case_inputs("linear_w32_varlen")
    full = banded_scan.banded_xdrop_batch(qs, ts, device="cpu", **kw)
    comp = banded_scan.banded_xdrop_batch(qs, ts, compress_history=True,
                                          device="cpu", **kw)
    assert comp.band_history.dtype == torch.uint8
    for b in range(B):
        np.testing.assert_array_equal(full.history_for(b), comp.history_for(b))
    with pytest.raises(ValueError, match="254"):
        banded_scan.banded_xdrop_batch(qs, ts, compress_history=True,
                                       x_threshold=255, device="cpu")


def test_forward_auto_compresses_large_histories():
    """compress_history=None picks the 8-bit history past ~8 MB of int32."""
    qs, ts, lq, lt = dna_set(n=600, m=600, B=64)
    small = banded_forward_batch(qs[:4, :100], ts[:4, :100], device="cpu")
    assert small.offsets is None and small.band_history.dtype == np.int32
    big = banded_forward_batch(qs, ts, lq, lt, mismatch=3, gap=2, x_threshold=30,
                               device="cpu")
    assert big.band_history.dtype == np.uint8 and big.offsets is not None
    ref = banded_scan.banded_xdrop_batch(qs, ts, lq, lt, mismatch=3, gap=2,
                                         x_threshold=30, device="cpu")
    for b in range(0, 64, 9):
        np.testing.assert_array_equal(big.history_for(b), ref.history_for(b))


# -- the kernel wrapper against the Pallas kernel (interpret mode) ------


def test_wrapper_equals_pallas():
    qs, ts, lq, lt = dna_set(n=96, m=96, B=9)
    with pltpu.force_tpu_interpret_mode():
        want = banded_xdrop_batch_pallas(qs, ts, lq, lt)
    got = banded_batch.banded_batch(qs, ts, lq, lt, device="cpu").numpy()
    for f in ("score", "max_round", "n_rounds"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for b in range(9):
        nr = int(got.n_rounds[b])
        np.testing.assert_array_equal(got.band_history[:nr, b],
                                      want.band_history[:nr, b])
        np.testing.assert_array_equal(got.pos_y[:nr, b], want.pos_y[:nr, b])


def test_wrapper_rules_go_eq_ge_linear_and_early_exit_changes_nothing():
    qs, ts, kw = case_inputs("linear_w32_varlen")
    a = banded_batch.banded_batch(qs, ts, gap=7, gap_open=2, gap_extend=2,
                                  device="cpu", **kw)
    b = banded_batch.banded_batch(qs, ts, gap=2, early_exit=True, device="cpu",
                                  **kw)
    assert_same(a, b.numpy())


# -- the walkers and the alignment entry points -------------------------


def test_reconstruct_affine_bands_equals_jax():
    qs, ts, kw = case_inputs("w96_gotoh_2351")
    res = banded_scan.banded_xdrop_batch(qs, ts, device="cpu", **kw).numpy()
    for b in range(B):
        nr = int(res.n_rounds[b])
        got = reconstruct_affine_bands(res.history_for(b), res.pos_y[:, b], nr, 5, 1)
        want = jax_reconstruct(res.history_for(b), res.pos_y[:, b], nr, 5, 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        st = banded_affine.banded_affine_xdrop(
            qs[b, : kw["lens_q"][b]], ts[b, : kw["lens_t"][b]], 2, 3, 5, 1,
            bandwidth=96, return_state=True)
        np.testing.assert_array_equal(got[0][:nr], st.e_hist)
        np.testing.assert_array_equal(got[1][:nr], st.f_hist)


@pytest.mark.parametrize("case", ["linear_w32_varlen", "gotoh_w32_compressed",
                                  "blosum62_gotoh_x120_varlen", "harsh_w8_x40"])
def test_walk_batch_equals_jax(case):
    qs, ts, kw = case_inputs(case)
    walk_kw = {k: v for k, v in kw.items() if k != "compress_history"}
    port_res = banded_scan.banded_xdrop_batch(qs, ts, device="cpu", **kw)
    got = banded_walk_batch(qs, ts, port_res, **walk_kw)
    want = jax_walk(qs, ts, jax_scan.banded_xdrop_batch(qs, ts, **kw), **walk_kw)
    assert got == want
    assert sum(len(p) > 20 for _, p in got) >= B // 2 or case == "harsh_w8_x40"


@pytest.mark.parametrize("case", ["linear_w32_varlen", "blosum62_gotoh_x120_varlen",
                                  "w96_gotoh_2351"])
def test_align_batch_equals_jax(case):
    qs, ts, kw = case_inputs(case)
    got = banded_align_batch(qs, ts, device="cpu", **kw)
    assert got == jax_align(qs, ts, **kw)
    # and the oracle copy, pair by pair
    for b, (score, path) in enumerate(got):
        lq, lt = kw.get("lens_q", [L] * B)[b], kw.get("lens_t", [L] * B)[b]
        if "gap_open" in kw:
            ref = banded_affine.banded_affine_xdrop(
                qs[b, :lq], ts[b, :lt], kw.get("match", 1), kw.get("mismatch", 1),
                kw["gap_open"], kw["gap_extend"], kw.get("bandwidth", 32),
                kw.get("x_threshold", 70), matrix=kw.get("matrix"))
        else:
            ref = semiglobal.banded_xdrop(qs[b, :lq], ts[b, :lt])
        assert (score, path) == ref


# -- the CLI ---------------------------------------------------------------


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["banded", "--random", "6x80x80", "--traceback", "--cigar"],
    ["banded", "--alphabet", "protein", "--random", "4x60x60", "--gap-open", "11",
     "--gap-extend", "1", "--x-drop", "120", "--sam"],
])
def test_cli_equals_jax(argv):
    out = _run(port_cli, argv + ["--device", "cpu"])
    assert out == _run(jax_cli, argv) and len(out.splitlines()) >= 4
