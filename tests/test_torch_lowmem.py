"""The port's low-memory host walk (``batch/lowmem.py``) against the JAX
package's: the numpy path (``use_native=False``) and the default (the
C++ walkers of both packages), at ``row_block`` 16, with and without
device endpoints, linear and affine; affine with gap_open < gap_extend
raises in the numpy walkers and walks exactly on the C++ ones. Seed
10000, tolerance 0."""

import numpy as np
import pytest

from swtpu.batch.lowmem import sw_traceback_lowmem as jax_lowmem
from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu_torch.batch.lowmem import sw_traceback_lowmem
from swtpu_torch.core.encode import mutate
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_10_30_15, ScoringParams, dna_matrix
from swtpu_torch.oracle.affine import sw_affine_traceback
from swtpu_torch.oracle.sw import sw_traceback

SEED = 10000
SCORINGS = {
    "tie_rich": ScoringParams.linear(dna_matrix(2, -1), 1),
    "dna_10_30_15": DNA_10_30_15,
    "gotoh": ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1),
    "gotoh_40_15": ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15),
    "blosum_gotoh": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1),
}


def _jp(p):
    return JaxScoring(p.matrix, p.gap_open, p.gap_extend)


def _pairs(name, trials=6):
    rng = np.random.default_rng(SEED)
    letters = 20 if name.startswith("blosum") else 4
    for _ in range(trials):
        n, m = int(rng.integers(3, 90)), int(rng.integers(3, 90))
        q = rng.integers(0, letters, n).astype(np.uint8)
        t = (mutate(rng, q, out_len=m) if letters == 4
             else rng.integers(0, letters, m).astype(np.uint8))
        yield q, t


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("with_ends", [False, True])
def test_lowmem_matches_jax(name, with_ends):
    p = SCORINGS[name]
    oracle = sw_traceback if p.is_linear else sw_affine_traceback
    for q, t in _pairs(name):
        full = oracle(q, t, p)
        ends = full[1][-1] if with_ends else None
        want = jax_lowmem(q, t, _jp(p), row_block=16, ends=ends, use_native=False)
        assert want == full
        assert sw_traceback_lowmem(q, t, p, row_block=16, ends=ends,
                                   use_native=False) == want
        # the default keyword (JAX: its C++ twin) gives the same walk
        assert sw_traceback_lowmem(q, t, p, row_block=16, ends=ends) == jax_lowmem(
            q, t, _jp(p), row_block=16, ends=ends)


def test_lowmem_zero_score():
    q = np.zeros(10, np.uint8)
    t = np.ones(12, np.uint8)
    p = SCORINGS["tie_rich"]
    assert sw_traceback_lowmem(q, t, p) == jax_lowmem(q, t, _jp(p)) == (0, [(0, 0)])
    assert sw_traceback_lowmem(q, t, p, ends=(0, 0)) == (0, [(0, 0)])


@pytest.mark.parametrize("use_native", [False, True])
def test_lowmem_affine_go_lt_ge_raises(use_native):
    """Gotoh with gap_open < gap_extend: the numpy walkers of both
    packages raise; the C++ walkers of both walk it exactly (seed 10000,
    two random 200-mers: 118 with a 228-step path ending at (165, 196))."""
    p = ScoringParams(dna_matrix(2, -3), gap_open=1, gap_extend=2)
    rng = np.random.default_rng(SEED)
    q = rng.integers(0, 4, 200).astype(np.uint8)
    t = rng.integers(0, 4, 200).astype(np.uint8)
    if not use_native:
        with pytest.raises(NotImplementedError, match="gap_open >= gap_extend"):
            jax_lowmem(q, t, _jp(p), use_native=False)
        with pytest.raises(NotImplementedError, match="gap_open >= gap_extend"):
            sw_traceback_lowmem(q, t, p, use_native=False)
        return
    want = jax_lowmem(q, t, _jp(p))
    assert want == sw_affine_traceback(q, t, p)
    assert want[0] == 118 and len(want[1]) == 228 and want[1][-1] == (165, 196)
    assert sw_traceback_lowmem(q, t, p) == want
