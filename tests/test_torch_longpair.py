"""Long pairs on the CPU: the port's plain tiles, strip-tile entries and
one-device sweep against the JAX package (seed 10000, tolerance 0).

- ``_tile_colscan`` / ``_tile_colscan_affine`` (the plain versions of the
  CUDA strip tile) equal JAX's XLA tiles on every return, under uniform
  DNA, a 4x4 matrix and BLOSUM62, with non-zero boundaries and in-length
  pads, at R in {1, 7, 33, 97} and C in {1, 40, 130};
- the plain mirror of the pipelined CUDA tile's decomposition
  (``_tile_pipeline``: row bands and column blocks of plain sub-tiles,
  the bands' last rows handed down with the E-and-diagonal candidate the
  F chain reads, the bests merged row-major first) equals the whole
  plain tile and JAX's XLA tile on every return, with bands and blocks
  that do not divide R and C, Gotoh with gap_open below gap_extend too,
  and at the bands ``strip_plan`` picks; ``strip_plan`` covers R with at
  most 16 rows a lane, puts 1024 rows or more on several warps and picks
  the power of two nearest 4R / C;
- ``strip_tile`` / ``strip_tile_affine`` equal one interpret-mode call
  each of JAX's Pallas strip tile on pad-free codes; on in-length pads
  the port equals the XLA tile and the Pallas tile does not (its uniform
  shortcut matches N against N);
- ``longpair_sw_score`` / ``_ends`` / ``_align`` equal JAX's (engine
  "xla") on meshes of 8 and 1 devices at 256 x 192 and 512 x 384:
  linear, Gotoh with gap_open >= and < gap_extend, protein; the score
  does not depend on the block, and the default block is JAX's at one
  device; a JAX mesh is refused (the port's meshes are
  tests/test_torch_mesh.py's);
- the ``longpair`` CLI prints what ``python -m swtpu longpair --devices
  1`` prints, and ``--devices 4`` in one process names torchrun.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.core.scoring import ScoringParams as JaxScoring
from swtpu.kernels.xla.sw_scan import _extended_table as jax_table
from swtpu.parallel import make_mesh
from swtpu.parallel import longpair as jlp
from swtpu_torch import cli
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_111, ScoringParams, dna_matrix
from swtpu_torch.kernels import longpair_strip as kls
from swtpu_torch.parallel import longpair as plp

SEED = 10000
G4 = np.array([[5, -4, -2, -4], [-4, 5, -4, -2], [-2, -4, 5, -4], [-4, -2, -4, 5]])
SCORINGS = {
    "dna": DNA_111,
    "g4": ScoringParams.linear(G4, 3),
    "blosum": ScoringParams.linear(BLOSUM62, 11),
    "dna_gotoh": ScoringParams(dna_matrix(2, -3), 5, 1),
    "g4_gotoh": ScoringParams(G4, 4, 2),
    "blosum_gotoh": ScoringParams(BLOSUM62, 11, 1),
}

# one jit per shape and alphabet: the uniform and 4x4 DNA tables share it
_jax_tile = jax.jit(jlp._tile_colscan, static_argnums=(6,))
_jax_tile_affine = jax.jit(jlp._tile_colscan_affine, static_argnums=(8,))


def _jp(p):
    return JaxScoring(p.matrix, p.gap_open, p.gap_extend)


def _tile_inputs(rng, p, R, C):
    letters = 20 if p.alphabet_size > 4 else 4
    q = rng.integers(0, letters, R)
    t = rng.integers(0, letters, C)
    # in-length pads on both sides (the query's and the target's pad codes)
    q[rng.random(R) < 0.1] = p.alphabet_size
    t[rng.random(C) < 0.1] = p.alphabet_size + 1
    return dict(q=q, t=t, top=rng.integers(-5, 60, C), topf=rng.integers(-40, 40, C),
                left=rng.integers(-5, 60, R), lefte=rng.integers(-40, 40, R),
                corner=int(rng.integers(0, 60)))


def _same(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert np.array_equal(g, np.asarray(w)), k


@pytest.mark.parametrize("name,R,C", [
    ("dna", 1, 40), ("g4", 1, 40), ("dna", 7, 130), ("g4", 7, 130),
    ("dna", 33, 1), ("g4", 33, 1), ("dna", 97, 40), ("g4", 97, 40),
    ("blosum", 33, 130), ("blosum", 97, 1),
    ("dna_gotoh", 7, 40), ("g4_gotoh", 7, 40), ("dna_gotoh", 97, 130),
    ("g4_gotoh", 1, 130), ("blosum_gotoh", 33, 40),
])
def test_plain_tile_matches_jax_xla_tile(name, R, C):
    p = SCORINGS[name]
    rng = np.random.default_rng(SEED + R * 1000 + C)
    x = _tile_inputs(rng, p, R, C)
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    table = jnp.asarray(jax_table(_jp(p)))
    ptable = torch.as_tensor(kls._extended_table(p))
    A = p.alphabet_size
    if p.is_linear:
        want = _jax_tile(i32(x["q"]), i32(x["t"]), i32(x["top"]), i32(x["left"]),
                         i32(x["corner"]), table, A, i32(p.gap))
        got = kls._tile_colscan(x["q"], x["t"], x["top"], x["left"], x["corner"],
                                ptable, A, p.gap)
        # the wrapper's CPU route is the same plain tile
        _same(kls.strip_tile(x["q"], x["t"], x["top"], x["left"], x["corner"], p,
                             device="cpu"), want)
    else:
        want = _jax_tile_affine(
            i32(x["q"]), i32(x["t"]), i32(x["top"]), i32(x["topf"]), i32(x["left"]),
            i32(x["lefte"]), i32(x["corner"]), table, A, i32(p.gap_open),
            i32(p.gap_extend))
        got = kls._tile_colscan_affine(x["q"], x["t"], x["top"], x["topf"], x["left"],
                                       x["lefte"], x["corner"], ptable, A,
                                       p.gap_open, p.gap_extend)
        _same(kls.strip_tile_affine(x["q"], x["t"], x["top"], x["topf"], x["left"],
                                    x["lefte"], x["corner"], p, device="cpu"), want)
    _same(got, want)


@pytest.mark.parametrize("name,R,C,band_rows,cols", [
    ("dna", 97, 130, 10, 33), ("g4", 33, 40, 7, 9), ("dna", 7, 130, 3, 130),
    ("blosum", 33, 130, 32, 17), ("dna_gotoh", 97, 130, 25, 40),
    ("g4_gotoh", 33, 40, 5, 7), ("blosum_gotoh", 33, 40, 33, 11),
    ("go_lt_ge", 97, 40, 16, 13), ("dna", 1, 40, 1, 3), ("dna_gotoh", 33, 1, 4, 1),
])
def test_pipelined_tile_mirror_matches_plain_and_jax(name, R, C, band_rows, cols):
    p = SCORINGS.get(name) or ScoringParams(dna_matrix(2, -3), 1, 3)
    rng = np.random.default_rng(SEED + R * 1000 + C)
    x = _tile_inputs(rng, p, R, C)
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    table = jnp.asarray(jax_table(_jp(p)))
    ptable = torch.as_tensor(kls._extended_table(p))
    A = p.alphabet_size
    got = kls._tile_pipeline(x["q"], x["t"], x["top"], x["topf"], x["left"], x["lefte"],
                             x["corner"], ptable, A, p.gap_open, p.gap_extend,
                             band_rows, cols, not p.is_linear)
    if p.is_linear:
        want = _jax_tile(i32(x["q"]), i32(x["t"]), i32(x["top"]), i32(x["left"]),
                         i32(x["corner"]), table, A, i32(p.gap))
        plain = kls._tile_colscan(x["q"], x["t"], x["top"], x["left"], x["corner"],
                                  ptable, A, p.gap)
    else:
        want = _jax_tile_affine(
            i32(x["q"]), i32(x["t"]), i32(x["top"]), i32(x["topf"]), i32(x["left"]),
            i32(x["lefte"]), i32(x["corner"]), table, A, i32(p.gap_open),
            i32(p.gap_extend))
        plain = kls._tile_colscan_affine(x["q"], x["t"], x["top"], x["topf"],
                                         x["left"], x["lefte"], x["corner"], ptable, A,
                                         p.gap_open, p.gap_extend)
    _same(got, plain)
    _same(got, want)


@pytest.mark.parametrize("R,C", [(300, 257), (600, 41), (1024, 256), (1500, 700)])
def test_pipelined_tile_mirror_at_the_planned_bands(R, C):
    br, bands = kls.strip_plan(R, C)
    assert bands == -(-R // (kls.BAND_LANES * br)) and br in (1, 2, 4, 8, 16)
    assert R < 1024 or bands > 1  # 1024 rows or more: several warps
    rng = np.random.default_rng(SEED + R)
    for p in (DNA_111, SCORINGS["dna_gotoh"]):
        x = _tile_inputs(rng, p, R, C)
        ptable = torch.as_tensor(kls._extended_table(p))
        A = p.alphabet_size
        got = kls._tile_pipeline(x["q"], x["t"], x["top"], x["topf"], x["left"],
                                 x["lefte"], x["corner"], ptable, A, p.gap_open,
                                 p.gap_extend, kls.BAND_LANES * br, 32, not p.is_linear)
        if p.is_linear:
            want = kls._tile_colscan(x["q"], x["t"], x["top"], x["left"], x["corner"],
                                     ptable, A, p.gap)
        else:
            want = kls._tile_colscan_affine(x["q"], x["t"], x["top"], x["topf"],
                                            x["left"], x["lefte"], x["corner"], ptable,
                                            A, p.gap_open, p.gap_extend)
        _same(got, want)


def test_strip_plan_shapes():
    for R, C in ((1, 1), (16384, 16384), (4096, 4096), (16384, 64), (40, 1024),
                 (1024, 256), (512, 384), (16383, 33)):
        br, bands = kls.strip_plan(R, C)
        assert (bands - 1) * kls.BAND_LANES * br < R <= bands * kls.BAND_LANES * br
    # a wide tile takes thinner bands than a tall thin one
    assert kls.strip_plan(16384, 16384)[0] < kls.strip_plan(16384, 64)[0]
    # br is the power of two nearest 4R / C, in 1..16
    for (R, C), br in (((16384, 16384), 4), ((1024, 1024), 4), ((16384, 4096), 16),
                       ((4096, 16384), 1), ((512, 384), 4), ((1499, 700), 8),
                       ((16384, 64), 16), ((40, 1024), 1)):
        assert kls.strip_plan(R, C)[0] == br, (R, C)


def test_plain_tile_matches_numpy_reference():
    rng = np.random.default_rng(SEED)
    for R, C in [(8, 8), (5, 7), (17, 9)]:
        q, t = rng.integers(0, 4, R), rng.integers(0, 4, C)
        top, left = rng.integers(0, 50, C), rng.integers(0, 50, R)
        corner = int(rng.integers(0, 50))
        bottom, right, best = kls.tile_sw_reference(q, t, top, left, corner,
                                                    DNA_111.matrix, 1)
        got = kls._tile_colscan(q, t, top, left, corner,
                                torch.as_tensor(kls._extended_table(DNA_111)), 4, 1)
        assert np.array_equal(got[0].numpy(), bottom)
        assert np.array_equal(got[1].numpy(), right)
        assert int(got[2]) == best


def test_strip_tile_matches_pallas_interpret():
    """One interpret-mode call of each JAX Pallas entry on pad-free codes
    against the port's strip_tile entries on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    from swtpu.kernels.pallas.longpair_strip import strip_tile, strip_tile_affine

    rng = np.random.default_rng(SEED)
    lin = ScoringParams.linear(G4, 3)
    aff = ScoringParams(dna_matrix(10, -30), 12, 3)
    R, C = 17, 24
    q, t = rng.integers(0, 4, R), rng.integers(0, 4, C)
    top, left = rng.integers(0, 50, C), rng.integers(0, 50, R)
    topf, lefte = rng.integers(-30, 40, C), rng.integers(-30, 40, R)
    with pltpu.force_tpu_interpret_mode():
        want = strip_tile(q, t, top, left, 9, _jp(lin))
        want_aff = strip_tile_affine(q, t, top, topf, left, lefte, 9, _jp(aff))
    _same(kls.strip_tile(q, t, top, left, 9, lin, device="cpu"), want)
    _same(kls.strip_tile_affine(q, t, top, topf, left, lefte, 9, aff, device="cpu"),
          want_aff)


def test_strip_tile_pads_follow_the_xla_tile():
    """In-length N (code 4) in both sequences: the XLA tile scores N at
    -2^20 and gives best 11 at (20, 20); the Pallas tile's uniform
    shortcut matches N against N and gives 20. The port follows XLA."""
    from jax.experimental.pallas import tpu as pltpu

    from swtpu.core.scoring import DNA_111 as JAX_111
    from swtpu.kernels.pallas.longpair_strip import strip_tile

    rng = np.random.default_rng(SEED)
    q, t = rng.integers(0, 4, 24), rng.integers(0, 4, 20)
    t[:] = q[:20]
    q[5:9] = 4
    t[5:9] = 4
    zc, zr = np.zeros(20, np.int32), np.zeros(24, np.int32)
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    xla = _jax_tile(i32(q), i32(t), i32(zc), i32(zr), i32(0),
                    jnp.asarray(jax_table(JAX_111)), 4, i32(1))
    got = kls.strip_tile(q, t, zc, zr, 0, DNA_111, device="cpu")
    _same(got, xla)
    assert [int(x) for x in got[2:]] == [11, 20, 20]
    with pltpu.force_tpu_interpret_mode():
        pallas = strip_tile(q, t, zc, zr, 0, JAX_111)
    assert int(pallas[2]) == 20 and not np.array_equal(np.asarray(pallas[0]),
                                                       got[0].numpy())


def _related(rng, n, m, letters=4):
    q = rng.integers(0, letters, n)
    t = q[:m].copy() if m <= n else np.concatenate([q, rng.integers(0, letters, m - n)])
    sub = rng.random(m) < 0.15
    t[sub] = rng.integers(0, letters, int(sub.sum()))
    t = np.concatenate([rng.integers(0, letters, 9), t])[:m]  # an offset
    return q.astype(np.uint8), t.astype(np.uint8)


@pytest.mark.parametrize("name,n_dev,n,m", [
    ("dna", 8, 256, 192),
    ("dna", 1, 512, 384),
    ("dna_gotoh", 8, 512, 384),
    ("go_lt_ge", 1, 256, 192),
    ("blosum", 8, 256, 192),
    ("blosum_gotoh", 1, 256, 192),
])
def test_longpair_entries_match_jax(name, n_dev, n, m):
    p = (ScoringParams(dna_matrix(2, -1), 1, 2) if name == "go_lt_ge"
         else SCORINGS[name])
    rng = np.random.default_rng(SEED + n_dev)
    q, t = _related(rng, n, m, 20 if p.alphabet_size > 4 else 4)
    mesh = make_mesh(n_dev, axis="sp")
    want_ends = jlp.longpair_sw_ends(q, t, _jp(p), mesh, engine="xla")
    assert plp.longpair_sw_ends(q, t, p, device="cpu") == want_ends
    assert plp.longpair_sw_score(q, t, p, device="cpu") == want_ends[0]
    assert want_ends[0] > 0
    try:
        want = jlp.longpair_sw_align(q, t, _jp(p), mesh, engine="xla")
    except AssertionError:
        # the decoupled F of the forward is not Gotoh's when go < ge: both
        # packages refuse the walk that disagrees with it
        with pytest.raises(AssertionError, match="mismatch"):
            plp.longpair_sw_align(q, t, p, device="cpu")
        return
    assert plp.longpair_sw_align(q, t, p, device="cpu") == want


@pytest.mark.parametrize("p", [DNA_111, ScoringParams(dna_matrix(2, -3), 5, 1)])
def test_longpair_score_does_not_depend_on_the_block(p):
    rng = np.random.default_rng(SEED)
    q, t = _related(rng, 300, 240)
    ends = {plp.longpair_sw_ends(q, t, p, block=b, device="cpu")
            for b in (None, 1, 8, 40, 80, 240)}
    assert len(ends) == 1
    # a query longer than one strip runs strip after strip
    monkey = plp.STRIP_ROWS
    try:
        plp.STRIP_ROWS = 64
        assert {plp.longpair_sw_ends(q, t, p, block=b, device="cpu")
                for b in (None, 48)} == ends
    finally:
        plp.STRIP_ROWS = monkey


@pytest.mark.parametrize("n,m", [(200, 97), (150, 40)])
def test_default_block_matches_jax_at_one_device(n, m):
    """block=None sweeps one whole-target block: JAX's step-count-optimal
    block at one device, a prime target and one under 64 columns
    included."""
    rng = np.random.default_rng(SEED + m)
    q, t = _related(rng, n, m)
    assert jlp._auto_block(n, m, 1) == m
    want = jlp.longpair_sw_ends(q, t, _jp(DNA_111), make_mesh(1, axis="sp"),
                                engine="xla")
    assert plp.longpair_sw_ends(q, t, DNA_111, device="cpu") == want
    assert plp.longpair_sw_ends(q, t, DNA_111, block=m, device="cpu") == want


def test_longpair_refusals():
    """A JAX mesh (or a device count) is not a port mesh: the port's sweep
    takes None or a DeviceMesh from swtpu_torch.parallel.make_mesh."""
    q = np.zeros(64, np.uint8)
    with pytest.raises(TypeError, match="swtpu_torch.parallel.make_mesh"):
        plp.longpair_sw_score(q, q, DNA_111, make_mesh(8, axis="sp"), device="cpu")
    with pytest.raises(TypeError, match="swtpu_torch.parallel.make_mesh"):
        plp.longpair_sw_ends(q, q, DNA_111, 2, device="cpu")
    with pytest.raises(TypeError, match="swtpu_torch.parallel.make_mesh"):
        plp.longpair_sw_align(q, q, DNA_111, make_mesh(1, axis="sp"), device="cpu")
    assert plp.longpair_sw_ends(q, q, DNA_111, None, device="cpu") == (64, 64, 64)
    with pytest.raises(NotImplementedError, match="CUDA strip tile"):
        plp.longpair_sw_score(q, q, DNA_111, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        plp.longpair_sw_score(q, q, DNA_111, engine="bogus", device="cpu")
    with pytest.raises(NotImplementedError, match="affine standalone"):
        kls.strip_tile(q, q, q, q, 0, ScoringParams(dna_matrix(1, -1), 3, 1),
                       device="cpu")


def _both_cli(argv, capsys):
    from swtpu.cli import main as jax_cli

    cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr()
    jax_cli(argv + ["--devices", "1"])
    theirs = capsys.readouterr()
    return ours, theirs


@pytest.mark.parametrize("argv", [
    ["longpair", "--random", "2x300x200", "--block", "64", "--cigar"],
    ["longpair", "--alphabet", "protein", "--random", "1x160x96", "--gap-open", "11",
     "--gap-extend", "1", "--sam"],
])
def test_cli_longpair_matches_jax(argv, capsys):
    ours, theirs = _both_cli(argv, capsys)
    assert ours.out == theirs.out and len(ours.out.splitlines()) >= 2
    assert ours.err == theirs.err


def test_cli_longpair_refuses_a_mesh():
    """--devices N > 1 in one process names the launcher: a mesh of N runs
    one process a device (tests/test_torch_mesh.py runs such worlds)."""
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4"):
        cli.main(["longpair", "--random", "1x40x40", "--devices", "4",
                  "--device", "cpu"])
