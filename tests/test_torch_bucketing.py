"""Variable-length batches: port (device="cpu") vs JAX.

``swtpu_torch.batch.sw_scores_varlen`` / ``sw_scores_bucketed`` against
the JAX package's, which run its XLA tier here, on the shapes of the JAX
package's own tests (37 pairs of mixed query and target lengths,
``max_buckets=3``, ``stream_chunks=3``, garbage past the lengths), on the
2-bit wire (``packed=True``), on a batch wide enough to split into
length-sorted buckets, and on protein with its own pad codes. Seed 10000,
tolerance 0.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

from swtpu.batch import bucket_edges as jax_bucket_edges
from swtpu.batch import sw_scores_bucketed as jax_bucketed
from swtpu.batch import sw_scores_varlen as jax_varlen
from swtpu.core import pack_2bit, random_dna
from swtpu.core.protein import BLOSUM62 as JAX_BLOSUM62
from swtpu.core.scoring import DNA_111 as JAX_DNA_111
from swtpu.core.scoring import ScoringParams as JaxScoringParams
from swtpu_torch.batch import (
    bucket_edges,
    sw_scores_bucketed,
    sw_scores_varlen,
)
from swtpu_torch.batch import bucketing
from swtpu_torch.core.protein import BLOSUM62, PROTEIN_Q_PAD, PROTEIN_T_PAD
from swtpu_torch.core.scoring import DNA_111, ScoringParams
from swtpu_torch.oracle import sw_score


def mixed_batch(B, n, m):
    rng = np.random.default_rng(10000)
    qs, ts = random_dna(rng, (B, n)), random_dna(rng, (B, m))
    return qs, ts, rng.integers(5, n + 1, B), rng.integers(5, m + 1, B)


VARLEN_CASES = {
    # test_batch_features.py::test_varlen_streamed_chunks_match
    "37x96x128": (dict(B=37, n=96, m=128), {}),
    "37x96x128_stream3": (dict(B=37, n=96, m=128), dict(stream_chunks=3)),
    # test_batch_features.py::test_varlen_array_scores
    "37x180x220_buckets3": (dict(B=37, n=180, m=220), dict(max_buckets=3)),
    "37x180x220_packed": (dict(B=37, n=180, m=220), dict(packed=True)),
    "37x96x128_packed_stream3": (dict(B=37, n=96, m=128),
                                 dict(packed=True, stream_chunks=3)),
}


@pytest.mark.parametrize("case", list(VARLEN_CASES))
def test_varlen_equals_jax(case):
    shape, kw = VARLEN_CASES[case]
    qs, ts, lq, lt = mixed_batch(**shape)
    if kw.get("packed"):  # the 2-bit wire: widths a multiple of 4
        qs, ts = pack_2bit(qs), pack_2bit(ts)
    want = jax_varlen(qs, ts, JAX_DNA_111, lq, lt, **kw)
    got = sw_scores_varlen(qs, ts, DNA_111, lq, lt, device="cpu", **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the same scores for any stream_chunks
    kw1 = dict(kw, stream_chunks=None)
    np.testing.assert_array_equal(
        sw_scores_varlen(qs, ts, DNA_111, lq, lt, device="cpu", **kw1), got)


def test_varlen_garbage_past_lengths_equals_oracle():
    qs, ts, lq, lt = mixed_batch(37, 180, 220)
    qs2 = qs.copy()
    qs2[:, 100:] = 3
    lq2 = np.minimum(lq, 100)
    got = sw_scores_varlen(qs2, ts, DNA_111, lq2, lt, device="cpu")
    want = np.array([sw_score(qs[b, : lq2[b]], ts[b, : lt[b]], DNA_111)
                     for b in range(37)], np.int32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_varlen(qs2, ts, JAX_DNA_111, lq2, lt))


def test_varlen_wide_spread_splits_into_buckets(monkeypatch):
    """8192 pairs, most queries short: the quantised spread exceeds 2x, so
    the batch is sorted and split into 2 buckets of their own shapes."""
    rng = np.random.default_rng(10000)
    B = 8192
    qs, ts = random_dna(rng, (B, 96)), random_dna(rng, (B, 64))
    lq = np.where(rng.random(B) < 0.8, rng.integers(5, 20, B),
                  rng.integers(5, 97, B))
    lt = rng.integers(5, 65, B)
    shapes = []
    build = bucketing._fused_masked_engine
    monkeypatch.setattr(
        bucketing, "_fused_masked_engine",
        lambda e, k, n, m, *a: shapes.append((n, m)) or build(e, k, n, m, *a),
    )
    got = sw_scores_varlen(qs, ts, DNA_111, lq, lt, max_buckets=3, device="cpu")
    assert shapes == [(32, 64), (96, 64)]
    np.testing.assert_array_equal(
        got, jax_varlen(qs, ts, JAX_DNA_111, lq, lt, max_buckets=3))


def test_varlen_protein_pads_equal_jax():
    """Protein callers pass the protein pads (24 / 25): 4 and 5 are real
    residues there."""
    rng = np.random.default_rng(10000)
    B = 37
    qs = rng.integers(0, 20, (B, 64)).astype(np.uint8)
    ts = rng.integers(0, 20, (B, 96)).astype(np.uint8)
    lq, lt = rng.integers(5, 65, B), rng.integers(5, 97, B)
    kw = dict(q_pad=PROTEIN_Q_PAD, t_pad=PROTEIN_T_PAD)
    want = jax_varlen(qs, ts, JaxScoringParams.linear(JAX_BLOSUM62, 11),
                      lq, lt, **kw)
    got = sw_scores_varlen(qs, ts, ScoringParams.linear(BLOSUM62, 11), lq, lt,
                           device="cpu", **kw)
    np.testing.assert_array_equal(got, want)


def test_varlen_custom_engine():
    qs, ts, lq, lt = mixed_batch(37, 96, 128)
    seen = []

    def engine(q, t):
        seen.append(tuple(q.shape))
        return bucketing.resolve_engine(DNA_111, None, "cpu")[0](q, t)

    got = sw_scores_varlen(qs, ts, DNA_111, lq, lt, engine=engine, device="cpu")
    assert seen == [(37, 96)]
    np.testing.assert_array_equal(got, jax_varlen(qs, ts, JAX_DNA_111, lq, lt))


def test_bucketed_equals_jax():
    """test_batch_features.py::test_bucketed_scores's pairs."""
    rng = np.random.default_rng(10000)
    pairs = [
        (random_dna(rng, (int(rng.integers(10, 150)),)),
         random_dna(rng, (int(rng.integers(10, 200)),)))
        for _ in range(16)
    ]
    got = sw_scores_bucketed(pairs, DNA_111, device="cpu")
    np.testing.assert_array_equal(got, jax_bucketed(pairs, JAX_DNA_111))
    np.testing.assert_array_equal(
        got, np.array([sw_score(q, t, DNA_111) for q, t in pairs], np.int32))


@pytest.mark.parametrize("max_len", [1, 32, 33, 100, 1000, 4097])
def test_bucket_edges_equal_jax(max_len):
    assert bucket_edges(max_len) == jax_bucket_edges(max_len)
    assert bucket_edges(max_len, 8, 2.0) == jax_bucket_edges(max_len, 8, 2.0)
    assert bucketing.Q_QUANT == 32 and bucketing.T_QUANT == 64
