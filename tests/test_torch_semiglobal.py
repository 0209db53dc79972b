"""Semi-global and global (Needleman-Wunsch) alignment: port vs JAX.

The same numpy inputs (seed 10000) go through the JAX package and the
port, tolerance 0:

- the port's oracle copy against ``swtpu.oracle.semiglobal`` (scores and
  paths, linear and affine, uniform and matrix, argmax and pinned);
- the plain tier (``swtpu_torch.kernels.semiglobal_scan``) against the
  XLA tier (``semiglobal_batch_diag`` / ``semiglobal_batch_general`` /
  ``nw_batch_*``), with per-pair lengths down to 0, the empty pair, odd
  shapes, internal pads and every scoring of the slice;
- the XLA tier's pad rule (an equal ``N`` on both sides scores
  -mismatch), which the port keeps and the oracle does not;
- the endpoint tie rule on pairs whose first maximum in row-major order
  is not the first in column order;
- the kernel wrappers at ``device="cpu"`` against the Pallas kernels in
  interpret mode, on pad-free codes with n % 8 == 0 and m % 16 == 0;
- ``semiglobal_align_batch`` / ``nw_align_batch`` and the ``semiglobal``
  / ``global`` CLI against JAX's.

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

from swtpu.batch import nw_align_batch as jax_nw_align
from swtpu.batch import semiglobal_align_batch as jax_sg_align
from swtpu.cli import main as jax_cli
from swtpu.core.io import write_fasta
from swtpu.core.protein import BLOSUM62
from swtpu.core.scoring import ScoringParams
from swtpu.kernels.pallas.semiglobal_batch import semiglobal_batch_pallas
from swtpu.kernels.pallas.semiglobal_profile import (
    semiglobal_batch_profile_pallas,
)
from swtpu.kernels.xla import semiglobal_scan as jax_scan
from swtpu.oracle import semiglobal as jax_oracle
from swtpu_torch.batch import nw_align_batch, semiglobal_align_batch
from swtpu_torch.cli import main as port_cli
from swtpu_torch.core import io as port_io
from swtpu_torch.core.scoring import scoring_from_numpy
from swtpu_torch.kernels import semiglobal_batch as sb
from swtpu_torch.kernels import semiglobal_profile as sp
from swtpu_torch.kernels import semiglobal_scan as scan
from swtpu_torch.oracle import semiglobal as oracle

DNA_MATRIX = np.array(
    [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]
)
# uniform scorings as (match, mismatch penalty, gap arguments); general
# matrices as JAX ScoringParams
SCORINGS = {
    "111": dict(match=1, mismatch=1, gap=1),
    "tie_rich_211": dict(match=2, mismatch=1, gap=1),
    "affine_2351": dict(match=2, mismatch=3, gap_open=5, gap_extend=1),
    "go_eq_ge": dict(match=2, mismatch=3, gap_open=2, gap_extend=2),
    "gap0": dict(match=1, mismatch=1, gap=0),  # no kernel; the CPU takes it
    "blosum62_linear11": ScoringParams.linear(BLOSUM62, 11),
    "blosum62_gotoh11_1": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1),
    "dna_general_linear2": ScoringParams.linear(DNA_MATRIX, 2),
    "dna_general_gotoh3_1": ScoringParams(DNA_MATRIX, gap_open=3, gap_extend=1),
}


def port(p):
    return scoring_from_numpy(p.matrix, p.gap_open, p.gap_extend)


def letters(scoring):
    s = SCORINGS[scoring]
    return 4 if isinstance(s, dict) or s.alphabet_size == 4 else 20


def pairs(rng, B, n, m, A, pads=0.0, pad_codes=(4, 5)):
    """B pairs, the first half related (the target is the query with ~15%
    substitutions behind a short random head), the rest random; ``pads``
    sets that share of codes to the pad codes, inside the sequences."""
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, A, size=(B, m)).astype(np.uint8)
    for b in range(B // 2):
        t = np.concatenate([rng.integers(0, A, 2).astype(np.uint8), qs[b]])
        sub = rng.random(len(t)) < 0.15
        t[sub] = rng.integers(0, A, int(sub.sum()))
        ts[b, : min(m, len(t))] = t[:m]
    if pads:
        qs[rng.random(qs.shape) < pads] = pad_codes[0]
        ts[rng.random(ts.shape) < pads] = pad_codes[1]
    return qs, ts


def equal(got, want):
    got, want = tuple(got), tuple(want)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the oracle copy ----------------------------------------------------


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("mode", ["linear", "affine", "linear_matrix",
                                  "affine_matrix"])
def test_oracle_copy_equals_jax(mode, pinned):
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, 8, 11, 14, 4)
    qs[0, 3] = ts[0, 5] = 4  # an equal pad code: a match to both oracles
    fn_name = ("nw" if pinned else "semiglobal") + (
        "_affine" if mode.startswith("affine") else "") + "_full"
    kw = {"matrix": DNA_MATRIX} if mode.endswith("matrix") else {
        "match": 2, "mismatch": 1}
    if mode.startswith("affine"):
        kw.update(gap_open=3, gap_extend=1)
    else:
        kw.update(gap=1)
    for b in range(len(qs)):
        q, t = (qs[b] % 4, ts[b] % 4) if "matrix" in kw else (qs[b], ts[b])
        for lq, lt in ((11, 14), (0, 5), (4, 0), (0, 0)):
            got = getattr(oracle, fn_name)(q[:lq], t[:lt], **kw)
            assert got == getattr(jax_oracle, fn_name)(q[:lq], t[:lt], **kw)
    assert oracle.MINUS_INF == jax_oracle.MINUS_INF


# -- the plain tier against the XLA tier ----------------------------------


def plain_and_xla(scoring, qs, ts, lens, pin):
    s = SCORINGS[scoring]
    if isinstance(s, dict):
        got = scan.semiglobal_batch_diag(qs, ts, **s, **lens, pin_end=pin,
                                         device="cpu")
        want = jax_scan.semiglobal_batch_diag(qs, ts, **s, **lens, pin_end=pin)
        nw = (scan.nw_batch_diag(qs, ts, **s, **lens, device="cpu"),
              jax_scan.nw_batch_diag(qs, ts, **s, **lens))
    else:
        got = scan.semiglobal_batch_general(qs, ts, port(s), **lens,
                                            pin_end=pin, device="cpu")
        want = jax_scan.semiglobal_batch_general(qs, ts, s, **lens, pin_end=pin)
        nw = (scan.nw_batch_general(qs, ts, port(s), **lens, device="cpu"),
              jax_scan.nw_batch_general(qs, ts, s, **lens))
    return got, want, nw


@pytest.mark.parametrize("pin", [False, True])
@pytest.mark.parametrize("scoring", list(SCORINGS))
def test_plain_equals_xla(scoring, pin):
    """16 pairs of 7 x 9 (odd widths) with internal pads; per-pair
    lengths with lq = 0, lt = 0, the empty pair and full pairs, then the
    same codes without lengths."""
    A = letters(scoring)
    rng = np.random.default_rng(10000)
    pad_codes = (4, 5) if A == 4 else (24, 25)
    qs, ts = pairs(rng, 16, 7, 9, A, pads=0.05, pad_codes=pad_codes)
    ts[1, 2] = 255  # a code past every table
    lq = rng.integers(0, 8, 16)
    lt = rng.integers(0, 10, 16)
    lq[:4], lt[:4] = (0, 3, 0, 7), (5, 0, 0, 9)
    for lens in (dict(lens_q=lq, lens_t=lt), {}):
        got, want, nw = plain_and_xla(scoring, qs, ts, lens, pin)
        equal(got, want)
        np.testing.assert_array_equal(nw[0].numpy(), np.asarray(nw[1]))
    if pin:  # global reads the corner, boundary corners included
        assert got[1].tolist() == [7] * 16 and got[2].tolist() == [9] * 16


@pytest.mark.parametrize("scoring", ["tie_rich_211", "blosum62_gotoh11_1"])
def test_plain_single_pair_equals_xla(scoring):
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, 2, 12, 10, letters(scoring))
    for pin in (False, True):
        got, want, _ = plain_and_xla(scoring, qs[:1], ts[:1], {}, pin)
        equal(got, want)


def test_pad_rule_is_the_xla_tiers():
    """8 identical random 16-mers with N (code 4) at position 5 of query
    and target: under (1, 1, 1) the XLA tier (and the port) score 14 —
    the N scores -mismatch against itself — where the oracle and the TPU
    kernel score 16."""
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 4, size=(8, 16)).astype(np.uint8)
    qs[:, 5] = 4
    ts = qs.copy()
    kw = SCORINGS["111"]
    want = jax_scan.semiglobal_batch_diag(qs, ts, **kw)
    got = sb.semiglobal_batch(qs, ts, **kw, device="cpu")
    equal(got, want)
    assert got[0].tolist() == [14] * 8
    assert all(oracle.semiglobal_full(q, t)[0] == 16 for q, t in zip(qs, ts))
    # so the walker (16) and the device score (14) disagree, and both
    # packages' align entries fail their device/host assert
    with pytest.raises(AssertionError):
        jax_sg_align(qs, ts, **kw)
    with pytest.raises(AssertionError):
        semiglobal_align_batch(qs, ts, **kw, device="cpu")


def full_h(qs, ts, match, mismatch, gap):
    """[B, n + 1, m + 1] semi-global DP matrices, linear gap."""
    B, n = qs.shape
    m = ts.shape[1]
    H = np.zeros((B, n + 1, m + 1), np.int64)
    H[:, 0, :] = -gap * np.arange(m + 1)
    H[:, :, 0] = -gap * np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = np.where(qs[:, i - 1] == ts[:, j - 1], match, -mismatch)
            H[:, i, j] = np.maximum(H[:, i - 1, j - 1] + s,
                                    np.maximum(H[:, i - 1, j], H[:, i, j - 1]) - gap)
    return H


def test_endpoint_tie_rule_on_column_order_traps():
    """Pairs whose maximum appears in several cells, where the first in
    column order is not the first in row order (a tracker that visits
    columns before rows picks the wrong one): the port's endpoints are
    the row-major-first cells, as the XLA tier's."""
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, 512, 10, 12, 4)
    kw = SCORINGS["tie_rich_211"]
    H = full_h(qs, ts, 2, 1, 1)
    B, n1, m1 = H.shape
    row_first = np.argmax(H.reshape(B, -1), axis=1)
    col_first = np.argmax(H.transpose(0, 2, 1).reshape(B, -1), axis=1)
    col_first = (col_first % n1) * m1 + col_first // n1
    traps = row_first != col_first
    assert traps.sum() >= 10
    got = scan.semiglobal_batch_diag(qs, ts, **kw, device="cpu")
    np.testing.assert_array_equal(got[1].numpy() * m1 + got[2].numpy(), row_first)
    np.testing.assert_array_equal(got[0].numpy(), H.reshape(B, -1).max(axis=1))
    equal(got, jax_scan.semiglobal_batch_diag(qs, ts, **kw))


# -- the kernel wrappers against the Pallas kernels ----------------------

PALLAS_CASES = {
    "uniform_tie_rich_211": ("tie_rich_211", 64, 48, 64),
    "uniform_affine_2351": ("affine_2351", 64, 48, 64),
    "blosum62_linear11": ("blosum62_linear11", 16, 32, 48),
    "blosum62_gotoh11_1": ("blosum62_gotoh11_1", 16, 32, 48),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_wrapper_on_cpu_equals_pallas(case):
    """One Pallas interpret call each (2-5 s): pad-free codes, half the
    pairs related, so the endpoints lie inside the matrix."""
    scoring, B, n, m = PALLAS_CASES[case]
    s = SCORINGS[scoring]
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, B, n, m, letters(scoring))
    if isinstance(s, dict):
        fn = sb.semiglobal_batch
        with pltpu.force_tpu_interpret_mode():
            want = semiglobal_batch_pallas(qs, ts, **s)
        got = fn(qs, ts, **s, device="cpu")
    else:
        fn = sp.semiglobal_profile
        with pltpu.force_tpu_interpret_mode():
            want = semiglobal_batch_profile_pallas(qs, ts, s)
        before = fn.launches
        got = fn(qs, ts, port(s), device="cpu")
        assert fn.launches == before  # the plain version ran
    equal(got, want)
    assert int((got[0] > 0).sum()) >= B // 2 and int(got[1].max()) > 0


# -- traceback and the CLI -----------------------------------------------

ALIGN_CASES = {
    "dna_tie_rich_varlen": ("tie_rich_211", True),
    "dna_affine": ("affine_2351", False),
    "dna_go_eq_ge_varlen": ("go_eq_ge", True),
    "dna_general_linear2": ("dna_general_linear2", False),
    "protein_linear11": ("blosum62_linear11", False),
    "protein_gotoh_varlen": ("blosum62_gotoh11_1", True),
}


@pytest.mark.parametrize("pin", [False, True])
@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_align_batch_equals_jax(case, pin):
    scoring, varlen = ALIGN_CASES[case]
    s = SCORINGS[scoring]
    rng = np.random.default_rng(10000)
    qs, ts = pairs(rng, 10, 24, 28, letters(scoring))
    lens = {}
    if varlen:
        lens = dict(lens_q=rng.integers(0, 25, 10), lens_t=rng.integers(0, 29, 10))
        lens["lens_q"][0] = lens["lens_t"][1] = 0
    jax_fn, port_fn = ((jax_nw_align, nw_align_batch) if pin
                       else (jax_sg_align, semiglobal_align_batch))
    if isinstance(s, dict):
        want = jax_fn(qs, ts, **s, **lens)
        got = port_fn(qs, ts, **s, **lens, device="cpu")
    else:
        want = jax_fn(qs, ts, params=s, **lens)
        got = port_fn(qs, ts, params=port(s), **lens, device="cpu")
    assert got == want
    assert sum(len(path) > 1 for _, path in got) >= 3


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


CLI_ARGS = {
    "semiglobal_traceback_cigar": ["semiglobal", "--random", "8x30x34",
                                   "--scoring", "2,-1", "--traceback", "--cigar"],
    "global_affine_sam": ["global", "--random", "8x30x34", "--scoring", "2,-1",
                          "--gap-open", "3", "--gap-extend", "1", "--sam"],
    "semiglobal_protein_gotoh_cigar": ["semiglobal", "--alphabet", "protein",
                                       "--random", "6x30x34", "--gap-open", "11",
                                       "--gap-extend", "1", "--cigar"],
    "global_protein_sam": ["global", "--alphabet", "protein", "--random",
                           "6x30x34", "--gap", "11", "--sam"],
}


@pytest.mark.parametrize("mode", list(CLI_ARGS))
def test_cli_equals_jax(mode):
    argv = CLI_ARGS[mode]
    want = _run(jax_cli, argv)
    got = _run(port_cli, argv + ["--device", "cpu"])
    assert got == want and len(got) >= 6


@pytest.mark.parametrize("cmd", ["semiglobal", "global"])
def test_cli_fasta_of_mixed_lengths_equals_jax(cmd, tmp_path):
    rng = np.random.default_rng(10000)
    q, t = tmp_path / "q.fa", tmp_path / "t.fa"
    qs = [port_io.decode_dna(rng.integers(0, 4, 20 + 3 * i)) for i in range(5)]
    write_fasta(q, [(f"q{i}", s) for i, s in enumerate(qs)])
    write_fasta(t, [(f"t{i}", s[2:] + port_io.decode_dna(rng.integers(0, 4, i)))
                    for i, s in enumerate(qs)])
    argv = [cmd, "--queries", str(q), "--targets", str(t), "--scoring", "2,-1"]
    for extra in (["--traceback", "--cigar"], ["--sam"]):
        want = _run(jax_cli, argv + extra)
        assert _run(port_cli, argv + extra + ["--device", "cpu"]) == want
        assert len(want) >= 5
