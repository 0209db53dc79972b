"""The wavefront kernel's stream schedule on the CPU (seed 10000,
tolerance 0).

``sw_wavefront.wavefront_stream_mirror`` replays ``csrc/sw_wavefront.cu``
step by step: P pairs back to back through 128 positions, 8 a lane, each
pair followed by its separator block, the D = H - gap cell on the
gap-folded table, the reset and query switch at each lane's forcing
step, the best carried down the lanes. It is held here against the
oracle on the pad-extended matrix and JAX's XLA tier
(``swtpu.kernels.xla.sw_scan.sw_batch_diag``, every scoring that tier
takes) on queries of 1-128 and targets of 1-300 codes, tail and
in-length pads on both sides, ragged last streams, one and many pairs a
stream; with pair boundaries where a leak of one pair's
cells into the next would show. ``wavefront_stream`` (the pairs a stream a
launch takes), ``wavefront_period`` and the kernel's table are checked on
their own. On the card the kernel is held against this mirror and the
plain version (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import numpy as np
import pytest
import torch

from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu.kernels.xla.sw_scan import sw_batch_diag
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_10_30_15, DNA_111, ScoringParams, dna_matrix
from swtpu_torch.kernels import sw_wavefront as kwf
from swtpu_torch.oracle.sw import sw_score_batch

SEED = 10000
H100_SMS = 132
SCORINGS = {
    "dna_10_30_15": DNA_10_30_15,
    "dna_111": DNA_111,
    "blosum62_11": ScoringParams.linear(BLOSUM62, 11),
    "g4": ScoringParams.linear(np.arange(16).reshape(4, 4) % 5 - 2, 2),
    "negative": ScoringParams.linear(-1 - np.arange(16).reshape(4, 4) % 3, 1),
    "m31": ScoringParams.linear(np.random.default_rng(SEED).integers(-6, 7, (31, 31)), 4),
}
#: the scorings JAX's XLA tier takes (alphabets of up to 30 letters)
XLA_SCORINGS = [k for k, p in SCORINGS.items() if p.alphabet_size + 2 <= 32]


def _oracle(qs, ts, p):
    """The oracle on the matrix extended by the two pad codes at -2^20."""
    A = p.alphabet_size
    ext = np.full((A + 2, A + 2), -(2**20))
    ext[:A, :A] = p.matrix
    q = np.minimum(qs, A)
    t = np.where(ts >= A, A + 1, ts)
    return sw_score_batch(q, t, ScoringParams.linear(ext, p.gap))


def _codes(seed, B, n, m, p, pads=True):
    rng = np.random.default_rng(seed)
    letters = min(p.alphabet_size, 20)
    qs = rng.integers(0, letters, (B, n)).astype(np.uint8)
    ts = rng.integers(0, letters, (B, m)).astype(np.uint8)
    if pads:
        A = p.alphabet_size
        for b in range(B):  # tail pads of each length, codes past the pads too
            qs[b, int(rng.integers(1, n + 1)):] = A if b % 3 else 255
            ts[b, int(rng.integers(1, m + 1)):] = A + 1 if b % 2 else A
        qs[rng.random(qs.shape) < 0.04] = A  # in-length pads
        ts[rng.random(ts.shape) < 0.04] = A + 1
    return qs, ts


def _mirror(qs, ts, p, pairs):
    got = kwf.wavefront_stream_mirror(qs, ts, p, pairs, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (qs.shape[0],)
    return got.numpy()


@pytest.mark.parametrize("B,letters,want", [
    (0, 4, 1), (1, 4, 1), (128, 4, 1), (128, 24, 1), (2112, 4, 1), (2113, 4, 2),
    (8192, 4, 4), (8192, 24, 4), (8192, 31, 8), (65536, 4, 8), (65536, 24, 4),
    (1 << 20, 4, 14),
])
def test_stream_plan(B, letters, want):
    """The rule's picks on an H100 (132 SMs). PERF.md holds each measured
    pick beside the fastest P (``tools/wavefront_times.py --sweep``); this
    pins the rule, not its speed."""
    assert kwf.wavefront_stream(B, 128, 128, H100_SMS, letters) == want


@pytest.mark.parametrize("letters,paired", [(1, True), (4, True), (5, False), (24, False),
                                            (31, False)])
def test_table_form_and_its_shared_memory(letters, paired):
    assert kwf.wavefront_form(letters) is paired
    cols = letters + 2
    for pairs in (1, 16):
        streams = (pairs * 128 + kwf.RING_WORDS + pairs + 16) * 8 * 4
        assert kwf.stream_smem(letters, pairs) == kwf.stream_smem(letters, pairs, paired)
        assert kwf.stream_smem(letters, pairs, False) == (letters + 1) * cols * 128 + streams
        if letters <= kwf.PAIR_MAX_LETTERS:
            assert kwf.stream_smem(letters, pairs, True) == (
                (letters + 1) * cols * cols * 256 + streams)
    # the default pick is the pick for the default form
    assert kwf.wavefront_stream(8192, 128, 128, H100_SMS, letters) == kwf.wavefront_stream(
        8192, 128, 128, H100_SMS, letters, paired)


@pytest.mark.parametrize("letters", [4, 20, 24, 31])
def test_stream_plans_fit_the_card(letters):
    for B in list(range(0, 3000, 37)) + list(range(3000, 2_000_000, 40_009)):
        for m in (1, 128, 1000):
            pairs = kwf.wavefront_stream(B, 100, m, H100_SMS, letters)
            assert 1 <= pairs <= kwf.MAX_PAIRS <= kwf.LANE // kwf.ROWS
            assert kwf.stream_smem(letters, pairs) + 1024 <= kwf.SMEM_PER_SM
            if B <= H100_SMS * 8:  # a block an SM at most: one pair a stream
                assert pairs == 1


def test_period_is_a_whole_number_of_iterations():
    for m in range(0, 50):
        T = kwf.wavefront_period(m)
        assert T % kwf.ROWS == 0 and kwf.ROWS <= T - m < 2 * kwf.ROWS


@pytest.mark.parametrize("name", ["dna_10_30_15", "blosum62_11", "m31"])
def test_stream_table(name):
    p = SCORINGS[name]
    A, g = p.alphabet_size, p.gap
    tab = kwf._stream_table(p)
    assert tab.shape == (A + 1, A + 2) and tab.dtype == np.int32
    assert (tab[:, 0] == kwf.NEG_SEP).all()
    assert np.array_equal(tab[:A, 1:A + 1], p.matrix + g)
    assert (tab[A, 1:] == kwf.NEG + g).all() and (tab[:, A + 1] == kwf.NEG + g).all()


# (B, n, m, scoring, pairs a stream): every n in {1, 7, 100, 128} with
# every m in {1, 3, 33, 300}; B not a multiple of P
SHAPES = [
    (5, 1, 1, "dna_111", 1), (9, 1, 3, "g4", 2), (7, 1, 33, "m31", 3),
    (3, 1, 300, "blosum62_11", 2),
    (13, 7, 1, "dna_10_30_15", 5), (10, 7, 3, "negative", 3),
    (11, 7, 33, "dna_111", 16), (4, 7, 300, "g4", 3),
    (9, 100, 1, "blosum62_11", 2), (7, 100, 3, "dna_111", 4),
    (13, 100, 33, "dna_10_30_15", 3), (5, 100, 300, "m31", 2),
    (11, 128, 1, "g4", 4), (6, 128, 3, "dna_10_30_15", 1),
    (17, 128, 33, "blosum62_11", 3), (5, 128, 300, "dna_111", 3),
    (10, 128, 128, "negative", 3), (21, 128, 128, "dna_10_30_15", 2),
]


@pytest.mark.parametrize("B,n,m,name,pairs", SHAPES)
def test_mirror_matches_oracle_on_pads(B, n, m, name, pairs):
    p = SCORINGS[name]
    qs, ts = _codes(SEED + n * 7 + m, B, n, m, p)
    want = _oracle(qs, ts, p)
    assert np.array_equal(_mirror(qs, ts, p, pairs), want)
    if name == "negative":
        assert (want == 0).all()


@pytest.mark.parametrize("name", XLA_SCORINGS)
@pytest.mark.parametrize("B,n,m,pairs", [(13, 100, 33, 3), (7, 128, 130, 2)])
def test_mirror_matches_xla(name, B, n, m, pairs):
    p = SCORINGS[name]
    qs, ts = _codes(SEED + B, B, n, m, p)
    want = np.asarray(sw_batch_diag(qs, ts, JaxScoring.linear(p.matrix, p.gap)))
    assert np.array_equal(_mirror(qs, ts, p, pairs), want)


@pytest.mark.parametrize("pairs", [2, 5, 7, 16])
@pytest.mark.parametrize("m", [3, 64, 128])
def test_pair_boundaries_do_not_leak(pairs, m):
    """Pair k scores its best at its last column and last row (the
    query is the target's end); pair k + 1 matches nothing but its first
    column, so a reset that failed would carry pair k's cells into it."""
    p = ScoringParams.linear(dna_matrix(5, -4), 2)
    n, B = 128, 2 * pairs + 1
    rng = np.random.default_rng(SEED)
    qs = np.zeros((B, n), np.uint8)
    ts = np.zeros((B, m), np.uint8)
    for b in range(B):
        if b % 2 == 0:
            ts[b] = rng.integers(0, 4, m)
            k = min(n, m)
            qs[b, n - k:] = ts[b, m - k:]
            qs[b, :n - k] = rng.integers(0, 4, n - k)
        else:
            qs[b] = 1
            ts[b] = 2
            ts[b, 0] = 1  # a match in the first column: its diagonal must be 0
    want = _oracle(qs, ts, p)
    assert (want[1::2] == 5).all() and (want[0::2] >= 5 * min(n, m)).all()
    assert np.array_equal(_mirror(qs, ts, p, pairs), want)


def test_mirror_on_empty_batches_and_shapes():
    p = DNA_111
    for B, n, m in ((0, 128, 128), (0, 7, 0), (3, 0, 5), (3, 5, 0)):
        qs, ts = np.zeros((B, n), np.uint8), np.zeros((B, m), np.uint8)
        got = _mirror(qs, ts, p, 2)
        assert got.shape == (B,) and (got == 0).all()


def test_mirror_equals_the_plain_version():
    p = SCORINGS["g4"]
    qs, ts = _codes(SEED, 9, 60, 70, p)
    plain = kwf.sw_wavefront_plain(qs, ts, p, "cpu").numpy()
    for pairs in (1, 4):
        assert np.array_equal(_mirror(qs, ts, p, pairs), plain)


def test_negative_gaps_are_refused_on_the_card(monkeypatch):
    """No longer refused: under a negative gap the kernel (and its mirror)
    run the TPU schedule's score, one pair a stream over
    ``wavefront_steps`` steps, which counts its phantom rows and padded
    columns and sits above the oracle's. ``align --engine wavefront`` on
    the card then takes the wavefront kernel for such a gap, as JAX takes
    its Pallas kernel for any linear gap (it falls back to its XLA tier
    for Gotoh only), chosen before anything runs."""
    from swtpu_torch.ops import variants

    p = ScoringParams.linear(dna_matrix(2, -3), -1)
    q = np.zeros((2, 8), np.uint8)
    assert kwf.wavefront_refusal(p) is None
    assert kwf.wavefront_refusal(DNA_111) is None
    assert kwf.wavefront_refusal(ScoringParams.linear(dna_matrix(2, -3), 0)) is None
    # the plain version keeps the TPU schedule's score: above the oracle's
    qs, ts = _codes(SEED, 3, 20, 30, p, pads=False)
    plain = kwf.sw_wavefront_plain(qs, ts, p, "cpu").numpy()
    assert (plain > _oracle(qs, ts, p)).all()
    assert np.array_equal(kwf.wavefront_stream_mirror(qs, ts, p, 1, device="cpu").numpy(),
                          plain)
    assert variants.variant_supported("wavefront", p, 8)
    assert variants.variant_supported("wavefront", p, 8, on_card=True)
    assert variants.variant_supported("wavefront", DNA_111, 8, on_card=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    monkeypatch.setattr(variants, "sw_wavefront",
                        lambda q, t, p, d: calls.append(("sw_wavefront", d.type)) or "wf")
    monkeypatch.setattr(variants, "sw_general",
                        lambda q, t, p, d: calls.append(("sw_general", d.type)) or "general")
    assert variants.variant_engine("wavefront", p, 8, device="cuda")(q, q) == "wf"
    assert calls == [("sw_wavefront", "cuda")]


def test_mirror_refusals():
    q = np.zeros((2, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="affine wavefront"):
        kwf.wavefront_stream_mirror(q, q, ScoringParams(dna_matrix(1, -1), 3, 1), 1,
                                    device="cpu")
    with pytest.raises(ValueError, match="n <= 128"):
        kwf.wavefront_stream_mirror(np.zeros((2, 129), np.uint8), q, DNA_111, 1,
                                    device="cpu")
    for pairs in (0, kwf.MAX_PAIRS + 1):
        with pytest.raises(ValueError, match="pairs a stream"):
            kwf.wavefront_stream_mirror(q, q, DNA_111, pairs, device="cpu")
