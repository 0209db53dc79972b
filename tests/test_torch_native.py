"""The port's C++ host code (``swtpu_torch.native``) against the JAX
package's (``swtpu.native``, the same source built apart) byte for byte,
and against the port's numpy walkers where one exists; a failed build
raises with g++'s output; the port's walk sites call the C++ walkers by
default and give the same paths with them replaced by the numpy walkers
(``native.available`` monkeypatched to say False). Seed 10000, small
shapes, tolerance 0."""

from pathlib import Path

import numpy as np
import pytest

from swtpu import native as jax_native
from swtpu.models import mapper as jax_mapper
from swtpu_torch import native
from swtpu_torch.batch import lowmem, traceback as port_tb
from swtpu_torch.core.encode import mutate, pack_2bit, unpack_2bit
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import ScoringParams, dna_matrix
from swtpu_torch.kernels import banded_scan, device_walk
from swtpu_torch.oracle.affine import sw_affine_traceback
from swtpu_torch.oracle.banded_static import sw_banded_static_traceback
from swtpu_torch.oracle.semiglobal import (
    nw_affine_full, nw_full, semiglobal_affine_full, semiglobal_full,
)
from swtpu_torch.oracle.sw import sw_traceback

SEED = 10000
LIN = ScoringParams.linear(dna_matrix(2, -1), 1)
GOTOH = ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1)
GENERAL = ScoringParams.linear(np.array(
    [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]), 2)
BLOSUM_GOTOH = ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)
SCORINGS = {"linear": LIN, "gotoh": GOTOH, "general": GENERAL,
            "blosum_gotoh": BLOSUM_GOTOH}


@pytest.fixture(autouse=True, scope="module")
def _jax_library_of_its_own(tmp_path_factory):
    """Point ``swtpu.native`` at a copy of its library built for this module.

    ``swtpu.native`` builds with g++ straight into its shared
    ``_build/libswnative.so`` and loads whatever file stands there, so a
    test process that looks while another process's g++ is still writing
    it fails to load ("file too short") and keeps that failure for the
    rest of the process. Here the JAX source is built atomically (the
    port's ``native.build``: a temporary file, then ``os.replace``) into
    this module's own directory and the JAX loader is sent there.
    """
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "SRC", Path(jax_native._SRC))
        mp.setattr(native, "BUILD_DIR", tmp_path_factory.mktemp("jax_native"))
        path = str(native.build())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_build", lambda: path)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_error", None)
        assert jax_native.available(), jax_native._load_error
        yield


def _pairs(p, count=6, seed=SEED):
    """Related (DNA) or random (protein) pairs of 3-80 codes."""
    rng = np.random.default_rng(seed)
    letters = 20 if p.alphabet_size > 4 else 4
    for _ in range(count):
        n = int(rng.integers(3, 80))
        q = rng.integers(0, letters, n).astype(np.uint8)
        t = (mutate(rng, q, out_len=int(rng.integers(3, 80))) if letters == 4
             else rng.integers(0, letters, int(rng.integers(3, 80))).astype(np.uint8))
        yield q, t


def test_codec_matches_jax_and_numpy():
    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, 4, 4 * 257).astype(np.uint8)
    packed = native.pack_2bit(codes)
    assert packed.tobytes() == jax_native.pack_2bit(codes).tobytes()
    assert packed.tobytes() == pack_2bit(codes).tobytes()
    out = native.unpack_2bit(packed)
    assert out.tobytes() == jax_native.unpack_2bit(packed).tobytes() == codes.tobytes()
    assert out.tobytes() == unpack_2bit(packed).tobytes()


@pytest.mark.parametrize("name", list(SCORINGS))
def test_local_walkers_match_jax_and_numpy(name):
    p = SCORINGS[name]
    for q, t in _pairs(p):
        if p.is_linear:
            got = native.sw_traceback(q, t, p.matrix, p.gap)
            assert got == jax_native.sw_traceback(q, t, p.matrix, p.gap)
            assert got == sw_traceback(q, t, p)
        got = native.sw_affine_traceback(q, t, p.matrix, p.gap_open, p.gap_extend)
        assert got == jax_native.sw_affine_traceback(q, t, p.matrix, p.gap_open,
                                                     p.gap_extend)
        assert got == sw_affine_traceback(q, t, p)


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("W", [4, 16])
def test_fixed_band_walker_matches_jax_and_numpy(name, W):
    p = SCORINGS[name]
    for q, t in _pairs(p):
        got = native.banded_static_traceback(q, t, p.matrix, p.gap_open,
                                             p.gap_extend, W)
        assert got == jax_native.banded_static_traceback(q, t, p.matrix, p.gap_open,
                                                         p.gap_extend, W)
        assert got == sw_banded_static_traceback(q, t, p, W)


@pytest.mark.parametrize("pin_end", [False, True])
@pytest.mark.parametrize("name", list(SCORINGS))
def test_semiglobal_walkers_match_jax_and_numpy(name, pin_end):
    p = SCORINGS[name]
    for q, t in _pairs(p):
        end = (len(q), len(t)) if pin_end else None
        if p.is_linear:
            got = native.semiglobal_traceback_matrix(q, t, p.matrix, p.gap, pin_end)
            assert got == jax_native.semiglobal_traceback_matrix(q, t, p.matrix, p.gap,
                                                                 pin_end)
            assert got == semiglobal_full(q, t, gap=p.gap, matrix=p.matrix, endpoint=end)
        got = native.semiglobal_affine_traceback(q, t, p.matrix, p.gap_open,
                                                 p.gap_extend, pin_end)
        assert got == jax_native.semiglobal_affine_traceback(q, t, p.matrix, p.gap_open,
                                                             p.gap_extend, pin_end)
        want = (nw_affine_full(q, t, gap_open=p.gap_open, gap_extend=p.gap_extend,
                               matrix=p.matrix) if pin_end else
                semiglobal_affine_full(q, t, gap_open=p.gap_open,
                                       gap_extend=p.gap_extend, matrix=p.matrix))
        assert got == want
    for q, t in _pairs(LIN):
        got = native.semiglobal_traceback(q, t, 2, 1, 1, pin_end)
        assert got == jax_native.semiglobal_traceback(q, t, 2, 1, 1, pin_end)
        assert got == (nw_full(q, t, 2, 1, 1) if pin_end else semiglobal_full(q, t, 2, 1, 1))


@pytest.mark.parametrize("name", ["gotoh", "blosum_gotoh", "linear"])
@pytest.mark.parametrize("with_ends", [False, True])
def test_lowmem_walker_matches_jax_and_numpy(name, with_ends):
    p = SCORINGS[name]
    for q, t in _pairs(p, count=4):
        full = (sw_traceback if p.is_linear else sw_affine_traceback)(q, t, p)
        ends = full[1][-1] if with_ends else None
        got = native.sw_traceback_lowmem(q, t, p.matrix, p.gap_open, p.gap_extend,
                                         ends=ends, row_block=16)
        assert got == jax_native.sw_traceback_lowmem(q, t, p.matrix, p.gap_open,
                                                     p.gap_extend, ends=ends, row_block=16)
        assert got == lowmem.sw_traceback_lowmem(q, t, p, row_block=16, ends=ends,
                                                 use_native=False) == full


def _band_inputs(affine, matrix=None):
    rng = np.random.default_rng(SEED)
    B, L, W, X = 6, 60, 8, 30
    letters = 20 if matrix is not None else 4
    qs = rng.integers(0, letters, (B, L)).astype(np.uint8)
    ts = qs.copy()
    ts[rng.random(ts.shape) < 0.1] = rng.integers(0, letters)
    lq, lt = [L - 3 * b for b in range(B)], [L - 2 * b for b in range(B)]
    kw = dict(match=2, mismatch=3, gap=2, bandwidth=W, x_threshold=X, matrix=matrix)
    if affine:
        kw.update(gap_open=4, gap_extend=1)
    res = port_tb.banded_forward_batch(qs, ts, lq, lt, device="cpu", **kw)
    return qs, ts, lq, lt, res, kw


@pytest.mark.parametrize("affine,protein", [(False, False), (True, False), (True, True)])
def test_band_walkers_match_jax_and_numpy(affine, protein):
    qs, ts, lq, lt, res, kw = _band_inputs(affine, BLOSUM62 if protein else None)
    W, X = kw["bandwidth"], kw["x_threshold"]
    for b in range(qs.shape[0]):
        args = (qs[b, : lq[b]], ts[b, : lt[b]], res.history_for(b), res.pos_y[:, b],
                int(res.n_rounds[b]), int(res.max_round[b]), int(res.score[b]) + X)
        if affine:
            tail = (kw["match"], kw["mismatch"], 4, 1, W)
            got = native.banded_affine_traceback(*args, *tail, matrix=kw["matrix"])
            assert got == jax_native.banded_affine_traceback(*args, *tail,
                                                             matrix=kw["matrix"])
            assert got == port_tb.banded_affine_traceback(*args, *tail,
                                                          matrix=kw["matrix"])
        else:
            tail = (kw["match"], kw["mismatch"], kw["gap"], W)
            got = native.banded_traceback(*args, *tail, matrix=kw["matrix"])
            assert got == jax_native.banded_traceback(*args, *tail, matrix=kw["matrix"])
            assert got == port_tb.banded_traceback(*args, *tail, matrix=kw["matrix"])


def _wire():
    """A device-walk wire of host walks (the walkers' plain version)."""
    rng = np.random.default_rng(SEED)
    walks = []
    for _ in range(5):
        q = rng.integers(0, 4, 70).astype(np.uint8)
        walks.append(semiglobal_full(q, mutate(rng, q, out_len=66), 2, 1, 1))
    return device_walk.encode_wire(walks, 140)


def test_wire_decoder_matches_jax_and_numpy(monkeypatch):
    wire = _wire()
    s, ln, paths = native.decode_move_wire(wire)
    js, jln, jpaths = jax_native.decode_move_wire(wire)
    assert s.tobytes() == js.tobytes() and ln.tobytes() == jln.tobytes()
    for b in range(len(s)):  # past path_len the JAX package's buffer is unset
        assert paths[b, : ln[b]].tobytes() == jpaths[b, : ln[b]].tobytes()
    got = banded_scan.decode_device_walk(wire)
    arrays = banded_scan.decode_device_walk(wire, as_arrays=True)
    monkeypatch.setattr(native, "available", lambda: False)
    assert banded_scan.decode_device_walk(wire) == got
    for a, b in zip(banded_scan.decode_device_walk(wire, as_arrays=True), arrays):
        assert a.tobytes() == b.tobytes()


def test_seed_candidates_match_jax():
    rng = np.random.default_rng(SEED)
    genome = rng.integers(0, 4, 6000).astype(np.uint8)
    index = jax_mapper.build_index([genome], k=11)
    reads = np.stack([mutate(rng, genome[s : s + 120], out_len=100)
                      for s in rng.integers(0, 5800, 24)])
    qcodes = jax_mapper._kmer_codes(reads, 11)
    args = (qcodes, index.starts, index.pos, 100, 16, 64, 2, 8)
    got = native.seed_candidates(*args)
    want = jax_native.seed_candidates(*args)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
    assert len(got[0]) >= 10  # most reads find their locus


def test_full_matrix_walkers_refuse_codes_outside_the_matrix():
    q = np.array([0, 1, 4, 2], np.uint8)  # an in-length pad
    t = np.array([0, 1, 2, 3], np.uint8)
    with pytest.raises(IndexError):
        sw_traceback(q, t, LIN)  # the numpy walker
    for call in (lambda: native.sw_traceback(q, t, LIN.matrix, 1),
                 lambda: native.sw_affine_traceback(q, t, GOTOH.matrix, 3, 1),
                 lambda: native.banded_static_traceback(q, t, LIN.matrix, 1, 1, 4),
                 lambda: native.sw_traceback_lowmem(q, t, LIN.matrix, 1, 1)):
        with pytest.raises(IndexError, match="outside"):
            call()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build(.|\n)*broken.cpp"):
        native.available()
    assert not list((tmp_path / "_build").glob("*.so"))


def _site_calls():
    """The port's walk sites on small CPU batches: name -> call."""
    rng = np.random.default_rng(SEED)
    qs = rng.integers(0, 4, (6, 40)).astype(np.uint8)
    ts = np.stack([mutate(rng, q, out_len=44) for q in qs])
    pq = rng.integers(0, 20, (4, 30)).astype(np.uint8)
    pt = rng.integers(0, 20, (4, 34)).astype(np.uint8)
    cpu = dict(device="cpu")
    return {
        "sw_linear": lambda: port_tb.sw_align_batch(qs, ts, LIN, **cpu),
        "sw_gotoh": lambda: port_tb.sw_align_batch(qs, ts, GOTOH, **cpu),
        "sw_protein": lambda: port_tb.sw_align_batch(pq, pt, BLOSUM_GOTOH, **cpu),
        "semiglobal": lambda: port_tb.semiglobal_align_batch(qs, ts, 2, 1, 1, **cpu),
        "semiglobal_gotoh": lambda: port_tb.semiglobal_align_batch(
            qs, ts, 2, 1, gap_open=3, gap_extend=1, **cpu),
        "global_matrix": lambda: port_tb.nw_align_batch(qs, ts, params=GENERAL, **cpu),
        "semiglobal_protein": lambda: port_tb.semiglobal_align_batch(
            pq, pt, params=BLOSUM_GOTOH, lens_q=[30, 20, 10, 3], **cpu),
        "fixed_band": lambda: port_tb.banded_static_align_batch(qs, ts, GOTOH, 8, **cpu),
        "band": lambda: port_tb.banded_align_batch(qs, ts, bandwidth=8, **cpu),
        "band_gotoh": lambda: port_tb.banded_align_batch(
            qs, ts, match=2, mismatch=3, gap_open=4, gap_extend=1, bandwidth=8, **cpu),
        "lowmem": lambda: lowmem.sw_traceback_lowmem(qs[0], ts[0], GOTOH, row_block=8),
    }


SITES = list(_site_calls())


@pytest.mark.parametrize("site", SITES)
def test_walk_sites_run_the_cpp_walkers_with_numpy_paths(site, monkeypatch):
    calls = []
    for name in ("sw_traceback", "sw_affine_traceback", "semiglobal_traceback",
                 "semiglobal_traceback_matrix", "semiglobal_affine_traceback",
                 "banded_static_traceback", "banded_traceback",
                 "banded_affine_traceback", "sw_traceback_lowmem"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    call = _site_calls()[site]
    got = call()
    # JAX walks semi-global uniform Gotoh in numpy; the port does the same
    assert bool(calls) == (site != "semiglobal_gotoh")
    monkeypatch.setattr(native, "available", lambda: False)
    n_calls = len(calls)
    assert call() == got
    assert len(calls) == n_calls

