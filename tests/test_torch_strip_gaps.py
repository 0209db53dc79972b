"""The long-pair strip tile under negative gap penalties on the CPU against
the JAX package (seed 10000, tolerance 0).

The CUDA strip kernel (``csrc/sw_strip.cu``) runs each row's cell as a
sequential chain, H[i] = max(pre[i], H[i - 1] - gap) and Gotoh's
decoupled F, where the plain tile (JAX's XLA tile) takes the same
max-plus prefix by log-doubling over shifts that fill with -2^20. The two
agree for gaps of either sign while that fill stays below every real
value (``longpair_strip.strip_refusal``). Held here:

- the plain tile against JAX's XLA tile and ``chain_mirror`` (the
  kernel's cell and its endpoint tracker, (value, row) kept apart,
  replayed cell by cell) against the plain tile, under gap -1, gap -3,
  Gotoh 2/-1, 3/0 and -2/1, on random boundaries and in-length pads;
- the band decomposition's mirror (``_tile_pipeline``) under gap -1 and
  Gotoh 2/-1;
- one interpret-mode call of each JAX Pallas strip entry on pad-free
  codes, under gap -1 and Gotoh 2/-1;
- the refusal's bound; ``longpair_sw_ends`` / ``_align`` and the
  ``longpair`` CLI against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu.kernels.xla.sw_scan import _extended_table as jax_table
from swtpu.parallel import longpair as jlp
from swtpu.parallel import make_mesh
from swtpu_torch import cli
from swtpu_torch.core.scoring import ScoringParams, dna_matrix
from swtpu_torch.kernels import longpair_strip as kls
from swtpu_torch.kernels.sw_scan import _extended_table
from swtpu_torch.parallel import longpair as plp

SEED = 10000
NEGB = -(2**20)
SCORINGS = {
    "gap_-1": ScoringParams.linear(dna_matrix(1, -1), -1),
    "gap_-3": ScoringParams.linear(dna_matrix(2, -3), -3),
    "gotoh_2_-1": ScoringParams(dna_matrix(2, -3), 2, -1),
    "gotoh_3_0": ScoringParams(dna_matrix(2, -3), 3, 0),
    "gotoh_-2_1": ScoringParams(dna_matrix(2, -3), -2, 1),
}
_jax_tile = jax.jit(jlp._tile_colscan, static_argnums=(6,))
_jax_tile_affine = jax.jit(jlp._tile_colscan_affine, static_argnums=(8,))


def _jp(p):
    return JaxScoring(p.matrix, p.gap_open, p.gap_extend)


def _inputs(rng, R, C, pads=True):
    q, t = rng.integers(0, 4, R), rng.integers(0, 4, C)
    if pads:
        q[rng.random(R) < 0.1] = 4
        t[rng.random(C) < 0.1] = 5
    # boundaries as a sweep hands them over: H >= 0, F and E above -go
    return dict(q=q, t=t, top=rng.integers(0, 60, C), topf=rng.integers(-2, 40, C),
                left=rng.integers(0, 60, R), lefte=rng.integers(-2, 40, R),
                corner=int(rng.integers(0, 60)))


def _plain(p, x):
    table = torch.as_tensor(_extended_table(p))
    if p.is_linear:
        return kls._tile_colscan(x["q"], x["t"], x["top"], x["left"], x["corner"], table,
                                 p.alphabet_size, p.gap)
    return kls._tile_colscan_affine(x["q"], x["t"], x["top"], x["topf"], x["left"],
                                    x["lefte"], x["corner"], table, p.alphabet_size,
                                    p.gap_open, p.gap_extend)


def _same(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(g, np.asarray(w)), k


def chain_mirror(q, t, top, topf, left, lefte, corner, p):
    """The strip kernel's arithmetic replayed cell by cell: column c of
    every row in order, the diagonal of row 0 the top value of the column
    before (the corner at c = 0), lane 0's F boundary max(top_f, -2^20),
    and a running best (value, row, column) updated on a greater H or an
    equal one in a lower row. Returns the plain tile's tuple."""
    tab = _extended_table(p)
    pad = tab.shape[0] - 1
    go, ge, affine = int(p.gap_open), int(p.gap_extend), not p.is_linear
    R, C = len(q), len(t)
    H = [int(x) for x in left]
    E = [int(x) for x in lefte] if affine else None
    bottom, bottom_f = [], []
    best = (-1, 0, 0)
    top_prev = int(corner)
    for c in range(C):
        up_h = int(top[c])
        up_p, up_f = up_h, max(int(topf[c]), NEGB) if affine else 0
        diag, top_prev = top_prev, up_h
        for r in range(R):
            sc = int(tab[min(int(q[r]), pad), min(int(t[c]), pad)])
            left_h = H[r]
            if affine:
                e = max(E[r] - ge, left_h - go)
                pre = max(diag + sc, e, 0)
                f = max(up_f - ge, up_p - go)
                h = max(pre, f)
                E[r], up_p, up_f = e, pre, f
            else:
                h = max(diag + sc, 0, left_h - go, up_h - go)
            diag, up_h, H[r] = left_h, h, h
            if h > best[0] or (h == best[0] and r < best[1]):
                best = (h, r, c)
        bottom.append(up_h)
        bottom_f.append(up_f)
    v, r, c = best
    end = (max(v, 0), r + 1 if v > 0 else 0, c + 1 if v > 0 else 0)
    if affine:
        return (bottom, bottom_f, H, E) + end
    return (bottom, H) + end


@pytest.mark.parametrize("name", list(SCORINGS))
def test_plain_tile_matches_jax_xla_tile(name):
    p = SCORINGS[name]
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    table = jnp.asarray(jax_table(_jp(p)))
    for R, C in ((33, 40), (97, 130)):
        x = _inputs(np.random.default_rng(SEED + R), R, C)
        if p.is_linear:
            want = _jax_tile(i32(x["q"]), i32(x["t"]), i32(x["top"]), i32(x["left"]),
                             i32(x["corner"]), table, 4, i32(p.gap))
        else:
            want = _jax_tile_affine(
                i32(x["q"]), i32(x["t"]), i32(x["top"]), i32(x["topf"]), i32(x["left"]),
                i32(x["lefte"]), i32(x["corner"]), table, 4, i32(p.gap_open),
                i32(p.gap_extend))
        _same(_plain(p, x), want)


@pytest.mark.parametrize("name", list(SCORINGS))
def test_kernel_chain_mirror_matches_the_plain_tile(name):
    p = SCORINGS[name]
    for R, C in ((1, 30), (33, 40), (60, 7)):
        x = _inputs(np.random.default_rng(SEED + R + C), R, C)
        _same(chain_mirror(x["q"], x["t"], x["top"], x["topf"], x["left"], x["lefte"],
                           x["corner"], p), _plain(p, x))


@pytest.mark.parametrize("name", ["gap_-1", "gotoh_2_-1"])
def test_band_mirror_matches_the_plain_tile(name):
    p = SCORINGS[name]
    x = _inputs(np.random.default_rng(SEED), 97, 130)
    table = torch.as_tensor(_extended_table(p))
    got = kls._tile_pipeline(x["q"], x["t"], x["top"], x["topf"], x["left"], x["lefte"],
                             x["corner"], table, 4, p.gap_open, p.gap_extend, 25, 33,
                             not p.is_linear)
    _same(got, _plain(p, x))


def test_strip_tile_matches_pallas_interpret_under_negative_gaps():
    """One interpret-mode call of each JAX Pallas entry on pad-free codes
    against the port's strip_tile entries on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    from swtpu.kernels.pallas.longpair_strip import strip_tile, strip_tile_affine

    lin, aff = SCORINGS["gap_-1"], SCORINGS["gotoh_2_-1"]
    x = _inputs(np.random.default_rng(SEED), 40, 56, pads=False)
    with pltpu.force_tpu_interpret_mode():
        want = strip_tile(x["q"], x["t"], x["top"], x["left"], x["corner"], _jp(lin))
        want_aff = strip_tile_affine(x["q"], x["t"], x["top"], x["topf"], x["left"],
                                     x["lefte"], x["corner"], _jp(aff))
    _same(kls.strip_tile(x["q"], x["t"], x["top"], x["left"], x["corner"], lin,
                         device="cpu"), want)
    _same(kls.strip_tile_affine(x["q"], x["t"], x["top"], x["topf"], x["left"],
                                x["lefte"], x["corner"], aff, device="cpu"), want_aff)


def test_refusal_states_the_fill_bound():
    """The kernel takes negative gaps while the plain tile's fill, -2^20 +
    (the shifts' sum) x |penalty|, stays below every real value: |gap| <=
    32 at 16384 rows, more on shorter strips."""
    lin = lambda g: ScoringParams.linear(dna_matrix(1, -1), g)  # noqa: E731
    assert kls.fill_reach(lin(-1), 16384) == 32767
    assert kls.fill_reach(lin(2), 16384) == 0
    assert kls.strip_refusal(lin(-32), 16384, 100) is None
    assert "2^20" in kls.strip_refusal(lin(-33), 16384, 100)
    assert kls.strip_refusal(lin(-33), 4096, 100) is None
    for name in SCORINGS:
        assert kls.strip_refusal(SCORINGS[name], 16384, 16384) is None
    # Gotoh: the fill must stay below -gap_open, F's least real value
    assert kls.strip_refusal(ScoringParams(dna_matrix(1, -1), 40, -31), 16384, 9) is None
    assert "2^20" in kls.strip_refusal(ScoringParams(dna_matrix(1, -1), 40, -32),
                                       16384, 9)
    assert "rows" in kls.strip_refusal(lin(-1), 16385, 9)


@pytest.mark.parametrize("name", ["gap_-3", "gotoh_2_-1", "gotoh_-2_1"])
def test_h_reach_bounds_every_value_of_the_tile(name):
    """The kernel packs its endpoint's (value, row) only where the largest
    boundary value plus ``h_reach`` stays below KEY_MAX: every H of the
    tile (its returns and its best) lies within that sum."""
    p = SCORINGS[name]
    for R, C in ((1, 30), (33, 40), (60, 7)):
        x = _inputs(np.random.default_rng(SEED + R * C), R, C)
        out = _plain(p, x)
        b = max(0, *(int(np.max(x[k])) for k in ("top", "topf", "left", "lefte", "corner")))
        hs = [out[0], out[2] if not p.is_linear else out[1], out[-3]]
        assert max(int(torch.as_tensor(h).max()) for h in hs) <= b + kls.h_reach(p, R, C)
    assert kls.h_reach(ScoringParams.linear(dna_matrix(1, -1), 1), 10, 20) == 10


def _related(rng, n, m):
    q = rng.integers(0, 4, n)
    t = np.concatenate([rng.integers(0, 4, 9), q, rng.integers(0, 4, m)])[:m]
    sub = rng.random(m) < 0.15
    t[sub] = rng.integers(0, 4, int(sub.sum()))
    return q.astype(np.uint8), t.astype(np.uint8)


@pytest.mark.parametrize("name", ["gap_-1", "gotoh_2_-1"])
def test_longpair_entries_match_jax_under_negative_gaps(name):
    p = SCORINGS[name]
    q, t = _related(np.random.default_rng(SEED), 256, 384)
    mesh = make_mesh(1, axis="sp")
    want = jlp.longpair_sw_ends(q, t, _jp(p), mesh, engine="xla")
    assert plp.longpair_sw_ends(q, t, p, device="cpu") == want
    assert plp.longpair_sw_ends(q, t, p, block=96, device="cpu") == want
    assert plp.longpair_sw_align(q, t, p, device="cpu") == jlp.longpair_sw_align(
        q, t, _jp(p), mesh, engine="xla")


def test_cli_longpair_negative_gap_matches_jax(capsys):
    from swtpu.cli import main as jax_cli

    argv = ["longpair", "--random", "1x300x300", "--gap", "-1", "--traceback"]
    cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr()
    jax_cli(argv + ["--devices", "1"])
    theirs = capsys.readouterr()
    assert ours.out == theirs.out and '"score": 599' in ours.out
