"""The per-round X-drop kernel's redesign on the CPU: its staging of raw
codes and a plain mirror of its round schedule.

The CUDA kernel (``csrc/sw_xdrop.cu::xdrop_round_kernel``) runs only on
the card, where tests/test_torch_cuda.py and chip_smoke.py hold it against
the plain version. Here, tolerance 0:

- ``xdrop_round_mirror``, the kernel's arithmetic replayed in numpy (H
  kept minus the gap with cut cells at -2^29, E and F floored at 0, the
  cut applied to the selected candidate, the direction from the uncut end
  values, codes held per cell and shifted, the entering codes from 32-code
  windows, phantom cells past W) against the plain tier
  (``banded_scan.banded_xdrop_batch``) in every field below n_rounds, at W
  from 1 to 128, linear, Gotoh with the 8-bit history, BLOSUM62 11/1 at X
  = 120 with per-pair lengths, harsh scoring where bands die early, and
  gap_open == gap_extend;
- the wrapper's raw-code input (``stage``: uint8 or int16 codes as they
  are, per-pair lengths, no padded rows) on the CPU against JAX's XLA tier
  ``banded_xdrop_batch``, and the mirror on the same inputs;
- ``stage``'s checks.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.core.protein import BLOSUM62
from swtpu.kernels.xla import banded_scan as jax_scan
from swtpu_torch.core.encode import mutate
from swtpu_torch.kernels import banded_batch

B, L = 6, 90


def sets(seed=10000):
    """DNA: related pairs, the last random, N inside two, per-pair lengths
    (one query of 3); protein: ~70% identity."""
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    ts = np.stack([mutate(rng, q, out_len=L) for q in qs])
    ts[-1] = rng.integers(0, 4, L)
    qs[1, 10:13] = 4
    ts[2, 20] = 4
    lq, lt = rng.integers(L // 2, L + 1, B), rng.integers(L // 2, L + 1, B)
    lq[0] = 3
    pq = rng.integers(0, 24, (B, L)).astype(np.uint8)
    pt = pq.copy()
    pt[:, ::3] = rng.integers(0, 24, (B, L // 3))
    return (qs, ts), (pq, pt), dict(lens_q=lq, lens_t=lt)


MODES = {
    "linear_lens": ("dna", dict(lens=True)),
    "gotoh_8bit": ("dna", dict(gap_open=3, gap_extend=1, compress_history=True)),
    "blosum62_gotoh_x120_lens": ("protein", dict(matrix=BLOSUM62, gap_open=11,
                                                 gap_extend=1, x_threshold=120,
                                                 lens=True)),
    "harsh_x20": ("dna", dict(mismatch=3, gap=2, x_threshold=20)),
    "go_eq_ge": ("dna", dict(gap=7, gap_open=2, gap_extend=2)),
}


def fields(res):
    """Every field, the per-round ones zeroed at and past n_rounds."""
    nr = np.asarray(res.n_rounds)
    out = [np.asarray(res.score), np.asarray(res.max_round), nr]
    if res.pos_y is not None:
        live = np.arange(res.pos_y.shape[0])[:, None] < nr[None]
        out.append(np.where(live[..., None], np.asarray(res.band_history), 0))
        out += [np.where(live, np.asarray(x), 0) for x in (res.pos_y, res.offsets)
                if x is not None]
    return out


def assert_fields_equal(got, want):
    g, w = fields(got), fields(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def mode_inputs(mode):
    kind, kw = MODES[mode]
    kw = dict(kw)
    dna, protein, lens = sets()
    qs, ts = dna if kind == "dna" else protein
    if kw.pop("lens", False):
        kw.update(lens)
    return qs, ts, kw


@pytest.mark.parametrize("W", [1, 3, 8, 32, 33, 40, 64, 96, 100, 128])
@pytest.mark.parametrize("mode", list(MODES))
def test_round_mirror_equals_plain(mode, W):
    qs, ts, kw = mode_inputs(mode)
    got = banded_batch.xdrop_round_mirror(qs, ts, bandwidth=W, **kw)
    want = banded_batch.banded_batch_plain(qs, ts, bandwidth=W, device="cpu", **kw)
    assert_fields_equal(got, want)


def test_round_mirror_scores_only():
    qs, ts, kw = mode_inputs("linear_lens")
    got = banded_batch.xdrop_round_mirror(qs, ts, with_history=False, **kw)
    assert got.band_history is None and got.pos_y is None
    assert_fields_equal(got, banded_batch.banded_batch_plain(
        qs, ts, with_history=False, device="cpu", **kw))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_raw_codes_with_lengths_equal_xla(dtype):
    """The wrapper on the CPU takes raw codes of either type with per-pair
    lengths (no padded rows), as the kernel does, and equals JAX's XLA
    tier; so does the mirror on the same raw input."""
    (qs, ts), _, lens = sets(10001)
    q, t = qs.astype(dtype), ts.astype(dtype)
    kw = dict(gap_open=3, gap_extend=1, x_threshold=40, compress_history=True)
    want = jax_scan.banded_xdrop_batch(qs, ts, lens["lens_q"], lens["lens_t"], **kw)
    got = banded_batch.banded_batch(q, t, lens["lens_q"], lens["lens_t"], device="cpu",
                                    **kw)
    assert_fields_equal(got.numpy(), want)
    assert_fields_equal(banded_batch.xdrop_round_mirror(
        torch.from_numpy(q), torch.from_numpy(t), lens["lens_q"], lens["lens_t"], **kw),
        want)


def test_stage_takes_raw_codes():
    cpu = torch.device("cpu")
    qs = np.array([[0, 3, 300, 4], [1, 2, 3, 0]], np.int16)
    ts = np.array([[2, 2], [0, 255]], np.uint8)
    q, t, lq, lt = banded_batch.stage(qs, ts, [4, 2], None, cpu)
    assert q.dtype == t.dtype == torch.uint8 and q.is_contiguous() and t.is_contiguous()
    assert q.tolist() == [[0, 3, 255, 4], [1, 2, 3, 0]] and t.tolist() == ts.tolist()
    assert lq.dtype == torch.int32 and lq.tolist() == [4, 2] and lt is None
    q, t, lq, lt = banded_batch.stage(torch.from_numpy(qs).t().contiguous().t(),
                                      torch.from_numpy(ts), None,
                                      torch.tensor([0, 2]), cpu)
    assert q.is_contiguous() and lq is None and lt.tolist() == [0, 2]
    for lens_q, lens_t, what in (([5, 1], None, r"\[0, 4\]"), ([1, -1], None, r"\[0, 4\]"),
                                 (None, [1, 2, 3], r"\[2\]"), (None, [3, 0], r"\[0, 2\]")):
        with pytest.raises(ValueError, match=what):
            banded_batch.stage(qs, ts, lens_q, lens_t, cpu)
    with pytest.raises(ValueError, match="batch mismatch"):
        banded_batch.stage(qs, ts[:1], None, None, cpu)
