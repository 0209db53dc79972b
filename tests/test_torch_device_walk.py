"""The device walkers' two-phase schedule, mirrored in PyTorch on the CPU.

``block_walk_mirror`` and ``xdrop_walk_mirror`` (``kernels/device_walk.py``)
replay what ``csrc/sw_walk.cu``'s map kernels do: the move map of a chunk
of rows (rounds) at a time, in the kernels' 32-bit entries (the move, the
exit / cross / stall flags, the next entry's place in a ring of chunks),
then the follower over the entries. The same numpy inputs (seed 10000) go
through the mirror, the plain versions (``block_walk_plain`` /
``xdrop_walk_plain``: the host walks encoded to the wire) and the JAX
package, tolerance 0 (byte-equal wires, equal paths):

- the block walk on DNA (1,1,1) at W = 32, K = 16, BLOSUM62, per-pair
  lengths with a zero-length pair, X = 30 early stop on random pairs, an
  all-dead endpoint ``[(0, 0)]``, and paths that run along row 0 and down
  the out-of-band column 0, at chunks of 1, 2, 7 and 64 rows (none of
  which divides n) and the default; a chunk boundary on the row where a
  path turns; chunks anchored at the largest end row of groups of 2, 4
  and 8 pairs; the start cell's own value is the walk's start value
  score + X; decoded, the paths equal ``swtpu``'s oracle;
- the per-round walk on DNA with per-pair lengths (one of 0), BLOSUM62 at
  X = 120 and X = 30 early stop, at chunks of 1, 2, 7 and 64 rounds and
  the default; decoded, equal to JAX's XLA ``banded_xdrop_align_device``.

The kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 3, 27, 28).
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.core.encode import mutate
from swtpu.core.protein import BLOSUM62
from swtpu.kernels.xla import banded_scan as jax_scan
from swtpu.oracle import banded_block as jax_block
from swtpu_torch.kernels import banded_batch, banded_block, device_walk
from swtpu_torch.kernels.banded_scan import _prep_padded, decode_device_walk

SEED = 10000
CHUNKS = [1, 2, 7, 64, None]


def related(rng, B, n, A=4, p=0.1):
    qs = rng.integers(0, A, size=(B, n)).astype(np.uint8)
    ts = np.stack([mutate(rng, q, p_mismatch=p, p_insert=0.02, p_delete=0.02,
                          out_len=n) % A for q in qs]).astype(np.uint8)
    return qs, ts


def block_case(case):
    """(qs, ts, forward keyword arguments) of a block-walk case."""
    rng = np.random.default_rng(SEED)
    kw = dict(width=32, block=16, x_threshold=70)
    if case == "uniform":
        qs, ts = related(rng, 6, 121)
    elif case == "blosum62":
        qs, ts = related(rng, 5, 90, A=20, p=0.3)
        kw.update(matrix=BLOSUM62, x_threshold=60)
    elif case == "varlen":
        qs, ts = related(rng, 6, 100)
        kw.update(lens_q=np.array([0, 99, 64, 47, 100, 81]),
                  lens_t=np.array([100, 83, 100, 61, 90, 100]), x_threshold=30)
    elif case == "x30":
        qs, ts = related(rng, 6, 100)
        ts[3:] = rng.integers(0, 4, size=(3, 100))
        kw.update(x_threshold=30)
    elif case == "all_dead":
        qs = np.zeros((3, 60), np.uint8)
        ts = np.ones((3, 60), np.uint8)
        kw.update(width=16, block=8, x_threshold=1)
    else:  # "edges": pair 0's target has a head the query lacks (its path
        # runs along row 0); pair 1's query has a head of a letter the
        # target lacks (its path runs down column 0, out of band past row 8)
        rng = np.random.default_rng(147)
        rng.choice([16, 32]), rng.choice([1, 2, 4, 8, 16])  # the draws that found it
        head = int(rng.integers(4, 30))
        q0 = rng.integers(0, 3, 60).astype(np.uint8)
        qs = np.stack([q0, np.concatenate([np.full(head, 3, np.uint8), q0])[:60]])
        t0 = np.concatenate([rng.integers(0, 3, 6).astype(np.uint8), q0])[:60]
        ts = np.stack([t0, q0])
        kw.update(width=16, block=16, x_threshold=40)
    return qs, ts, kw


def forward(qs, ts, kw):
    run = banded_block._setup(
        qs, ts, 1, 1, 1, kw["width"], kw["block"], kw["x_threshold"], None,
        kw.get("matrix"), True, None, None, kw.get("lens_q"), kw.get("lens_t"), "cpu")
    return banded_block._forward(run)


def oracle(qs, ts, kw):
    """swtpu's oracle, pair by pair: [(score, path)]."""
    lq, lt = kw.get("lens_q"), kw.get("lens_t")
    okw = {k: kw[k] for k in ("width", "block", "x_threshold", "matrix") if k in kw}
    return [jax_block.banded_xdrop_block(
        qs[p, : qs.shape[1] if lq is None else lq[p]],
        ts[p, : ts.shape[1] if lt is None else lt[p]], **okw) for p in range(len(qs))]


BLOCK_CASES = ["uniform", "blosum62", "varlen", "x30", "all_dead", "edges"]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_mirror_equals_plain(case, chunk):
    run = forward(*block_case(case))
    assert torch.equal(device_walk.block_walk_mirror(run, chunk),
                       device_walk.block_walk_plain(run))


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_mirror_grouped_equals_plain(case, group):
    """Chunks anchored at a group's largest end row (the kernel's producers
    map 8 pairs together in large batches; 2 and 4 make several groups of
    a batch here, the last one partial), the follower starting in the
    chunk that holds its own end row: the same wire, at chunks of 7 rows
    and the default."""
    run = forward(*block_case(case))
    want = device_walk.block_walk_plain(run)
    for chunk in (7, None):
        assert torch.equal(device_walk.block_walk_mirror(run, chunk, group), want)


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_block_mirror_equals_jax_oracle(case):
    qs, ts, kw = block_case(case)
    got = decode_device_walk(device_walk.block_walk_mirror(forward(qs, ts, kw), 7).numpy())
    want = oracle(qs, ts, kw)
    assert got == [(int(s), [tuple(map(int, c)) for c in p]) for s, p in want]
    if case == "all_dead":
        assert all(p == [(0, 0)] and s == 0 for s, p in got)


def test_edges_case_runs_along_row_0_and_column_0():
    """The "edges" case covers both closed forms: pair 0's path runs along
    row 0, pair 1's down column 0 where column 0 lies out of band."""
    qs, ts, kw = block_case("edges")
    run = forward(qs, ts, kw)
    paths = [p for _, p in decode_device_walk(device_walk.block_walk_mirror(run).numpy())]
    assert any(y == 0 and j > 1 for y, j in paths[0])
    rb = lambda y: int(run.bases[(y - 1) // run.K, 1]) + (y - 1) % run.K  # noqa: E731
    assert any(j == 0 and y >= 1 and rb(y) > 0 for y, j in paths[1])


@pytest.mark.parametrize("edge", ["bottom", "top"])
def test_block_chunk_boundary_on_a_turn(edge):
    """A chunk boundary on a row where the path turns (moves left): the
    turn is the bottom row of chunk 0, or the top row of chunk 1."""
    run = forward(*block_case("uniform"))
    want = device_walk.block_walk_plain(run)
    (score, path), = decode_device_walk(want[:1].numpy())
    ey = path[-1][0]
    turns = [a[0] for a, b in zip(path, path[1:]) if a[0] == b[0] and a[0] < ey - 2]
    assert turns
    C = ey - turns[-1] + (1 if edge == "bottom" else 0)
    assert torch.equal(device_walk.block_walk_mirror(run, C), want)


def test_start_value_is_the_start_cells_own():
    """score + X, the walk's start value, is the start cell's stored value,
    so the map's rule (a cell's move from its own value) holds at the
    first step too."""
    for case in BLOCK_CASES:
        run = forward(*block_case(case))
        for b in range(run.B):
            ey, ej = int(run.state[2, b]), int(run.state[3, b])
            if ey == 0:
                assert ej == 0
                continue
            rb = int(run.bases[(ey - 1) // run.K, b]) + (ey - 1) % run.K
            assert 0 <= ej - rb < run.W
            assert int(run.hist[ey - 1, ej - rb, b]) == int(run.state[1, b])


# -- the per-round walk --------------------------------------------------------


def xdrop_case(case):
    rng = np.random.default_rng(SEED + 1)
    kw = dict(bandwidth=16, x_threshold=70)
    if case == "blosum62":
        qs, ts = related(rng, 5, 90, A=20, p=0.3)
        kw.update(matrix=BLOSUM62, x_threshold=120)
        lens = None, None
    else:
        qs, ts = related(rng, 6, 100)
        lens = np.array([0, 99, 64, 47, 100, 81]), np.array([100, 83, 100, 61, 90, 100])
        if case == "x30":
            ts[3:] = rng.integers(0, 4, size=(3, 100))
            kw.update(x_threshold=30)
    return qs, ts, lens, kw


def xdrop_forward(case):
    qs, ts, (lq, lt), kw = xdrop_case(case)
    res = banded_batch.banded_batch(qs, ts, lq, lt, compress_history=False, device="cpu",
                                    **kw)
    pad = _prep_padded(qs, ts, lq, lt, kw["bandwidth"], "cpu", torch.int16)
    return res, pad, kw


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", ["varlen", "blosum62", "x30"])
def test_xdrop_mirror_equals_plain(case, chunk):
    res, pad, kw = xdrop_forward(case)
    assert torch.equal(device_walk.xdrop_walk_mirror(res, pad, chunk=chunk, **kw),
                       device_walk.xdrop_walk_plain(res, pad, **kw))


def test_xdrop_mirror_equals_jax():
    qs, ts, (lq, lt), kw = xdrop_case("varlen")
    res, pad, _ = xdrop_forward("varlen")
    got = decode_device_walk(device_walk.xdrop_walk_mirror(res, pad, chunk=7, **kw).numpy())
    assert got[0] == (0, [(0, 0)])  # the zero-length query
    assert got == jax_scan.banded_xdrop_align_device(qs, ts, lq, lt, **kw)
