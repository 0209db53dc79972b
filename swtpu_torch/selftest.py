"""End-to-end differential self-check (``python -m swtpu_torch selftest``).

Port of ``swtpu/cli.py::cmd_selftest``: the oracles against every engine
tier that runs where the call runs, one (name, ok) a check, with the JAX
package's check names in its order and its seed-10000 inputs (the draws
of the checks that do not run are skipped as JAX skips them).

- Everywhere: ``xla_vs_oracle`` and ``nw_vs_oracle`` (the plain local and
  global scans, on the CPU), then ``banded_16k_e2e_vs_scalar_oracle`` (one
  16384-mer mutation pair through ``banded_align_batch``),
  ``msa_center_star_projection`` and ``fuzz_soak_short`` (ten fuzz rounds
  of 256 pairs), each on ``device``.
- On the card, JAX's TPU branch, each check against the port's CUDA
  kernels where JAX runs its Pallas kernels: ``rowscan*`` and the
  ``*_ends*`` checks rows 1-4; ``*prof*`` / ``*profile*`` rows 5-6 and 9;
  ``banded_*pallas*`` the per-round band (rows 14/15) against its plain
  scan; ``fixed_band`` row 10; ``banded_block*`` B9, its host walk and the
  device walk; ``longpair_strip*`` B13 against the plain tiles;
  ``ka_calibration`` ``core/stats.py`` on ``best_engine``; and
  ``banded_16k_e2e`` runs the per-round band and the device walk at
  reference scale. JAX has two per-round Pallas kernels (the per-round
  batch kernel and its packed form); the port has one, so
  ``banded_blosum62_packed_vs_xla`` keeps JAX's name and runs that kernel
  through the per-round entry point (``banded_forward_batch``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from swtpu_torch.utils.device import resolve_device


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _same(a, b) -> bool:
    """Tuples of arrays (or tensors) equal element for element."""
    return all(np.array_equal(_host(x), _host(y)) for x, y in zip(a, b))


def _banded_same(ref, dev) -> bool:
    return (np.array_equal(_host(ref.score), _host(dev.score))
            and np.array_equal(_host(ref.n_rounds), _host(dev.n_rounds)))


def _card_checks(rng, qs, ts, orc, checks):
    """JAX's TPU branch on the card's kernels (module note)."""
    from swtpu_torch.batch.traceback import banded_forward_batch
    from swtpu_torch.core.encode import mutate, random_dna
    from swtpu_torch.core.protein import BLOSUM62
    from swtpu_torch.core.scoring import DNA_10_30_15, ScoringParams
    from swtpu_torch.core.stats import calibrate_stats
    from swtpu_torch.kernels import longpair_strip as kls
    from swtpu_torch.kernels.affine_scan import sw_affine_batch_diag_ends
    from swtpu_torch.kernels.banded_batch import banded_batch
    from swtpu_torch.kernels.banded_block import (
        banded_block_align_device,
        banded_block_batch,
        banded_block_traceback_host,
    )
    from swtpu_torch.kernels.banded_scan import banded_xdrop_batch
    from swtpu_torch.kernels.semiglobal_profile import semiglobal_profile
    from swtpu_torch.kernels.semiglobal_scan import semiglobal_batch_general
    from swtpu_torch.kernels.sw_affine import sw_affine, sw_affine_ends
    from swtpu_torch.kernels.sw_banded import sw_banded_static
    from swtpu_torch.kernels.sw_batch import sw_batch, sw_batch_ends
    from swtpu_torch.kernels.sw_profile import sw_profile, sw_profile_ends
    from swtpu_torch.kernels.sw_scan import _extended_table, sw_batch_diag_ends
    from swtpu_torch.oracle import sw_score_batch
    from swtpu_torch.oracle.affine import sw_affine_score_batch
    from swtpu_torch.oracle.banded_block import banded_xdrop_block
    from swtpu_torch.oracle.banded_static import sw_banded_static_score_batch

    cuda, cpu = "cuda", "cpu"
    checks.append(("rowscan_vs_oracle",
                   np.array_equal(_host(sw_batch(qs, ts, DNA_10_30_15, device=cuda)), orc)))

    pp = ScoringParams.linear(BLOSUM62, 11)
    pq = rng.integers(0, 24, size=(16, 64)).astype(np.uint8)
    pt = rng.integers(0, 24, size=(16, 64)).astype(np.uint8)
    checks.append(("rowscan_prof_blosum62_vs_oracle",
                   np.array_equal(_host(sw_profile(pq, pt, pp, device=cuda)),
                                  sw_score_batch(pq, pt, pp))))

    aff = ScoringParams(matrix=DNA_10_30_15.matrix, gap_open=40, gap_extend=15)
    checks.append(("affine_rowscan_vs_oracle",
                   np.array_equal(_host(sw_affine(qs, ts, aff, device=cuda)),
                                  sw_affine_score_batch(qs, ts, aff))))

    paff = ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)
    checks.append(("affine_profile_blosum62_vs_oracle",
                   np.array_equal(_host(sw_profile(pq, pt, paff, device=cuda)),
                                  sw_affine_score_batch(pq, pt, paff))))

    bq = random_dna(rng, (8, 256))
    bt = np.stack([mutate(rng, bq[b]) for b in range(8)])
    ref = banded_xdrop_batch(bq, bt, with_history=False, device=cpu)
    dev = banded_batch(bq, bt, with_history=False, device=cuda)
    checks.append(("banded_pallas_vs_xla", _banded_same(ref, dev)))

    kw = dict(gap_open=3, gap_extend=1, with_history=False)
    ref = banded_xdrop_batch(bq, bt, device=cpu, **kw)
    dev = banded_batch(bq, bt, device=cuda, **kw)
    checks.append(("banded_affine_pallas_vs_xla", _banded_same(ref, dev)))

    bpq = rng.integers(0, 24, size=(8, 200)).astype(np.uint8)
    bpt = bpq.copy()
    for b in range(8):
        idx = rng.integers(0, 200, 30)
        bpt[b, idx] = rng.integers(0, 24, 30)
    kw = dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120)
    ref = banded_xdrop_batch(bpq, bpt, with_history=False, device=cpu, **kw)
    dev = banded_batch(bpq, bpt, with_history=False, device=cuda, **kw)
    checks.append(("banded_blosum62_pallas_vs_xla", _banded_same(ref, dev)))
    dev = banded_forward_batch(bpq, bpt, device=cuda, **kw)
    checks.append(("banded_blosum62_packed_vs_xla", _banded_same(ref, dev)))

    spq = rng.integers(0, 24, size=(1024, 24)).astype(np.uint8)
    spt = rng.integers(0, 24, size=(1024, 32)).astype(np.uint8)
    checks.append(("semiglobal_prof_blosum62_vs_xla",
                   _same(semiglobal_profile(spq, spt, paff, device=cuda),
                         semiglobal_batch_general(spq, spt, paff, device=cpu))))

    checks.append((
        "fixed_band_vs_oracle",
        np.array_equal(_host(sw_banded_static(bq, bt, DNA_10_30_15, bandwidth=32,
                                              device=cuda)),
                       sw_banded_static_score_batch(bq, bt, DNA_10_30_15, 32)
                       .astype(np.int32))))

    # the block tier: forward + history + host walk and the device walk,
    # bit-exact against the block oracle
    res = banded_block_batch(bq, bt, width=64, block=32, with_history=True,
                             with_meta=True, device=cuda).numpy()
    paths = banded_block_traceback_host(res, bq, bt, block=32)
    ok_blk = True
    for p in range(len(bq)):
        os_, op = banded_xdrop_block(bq[p], bt[p], width=64, block=32)
        ok_blk &= int(res.score[p]) == os_ and paths[p] == op
    checks.append(("banded_block_vs_oracle", bool(ok_blk)))
    dv = banded_block_align_device(bq, bt, width=64, block=32, device=cuda)
    checks.append(("banded_block_device_walk_vs_host",
                   all(dv[p] == (int(res.score[p]), paths[p]) for p in range(len(bq)))))

    # the long-pair strip tile: one tile of B13 against the plain
    # column-scan tile, every return (boundaries, best, endpoint)
    Rs, Cs = 512, 384
    sq = rng.integers(0, 4, Rs)
    st = rng.integers(0, 4, Cs)
    stop = rng.integers(0, 50, Cs)
    sleft = rng.integers(0, 50, Rs)
    scorn = int(rng.integers(0, 50))
    tbl = torch.as_tensor(_extended_table(DNA_10_30_15))
    ref_t = kls._tile_colscan(sq, st, stop, sleft, scorn, tbl, 4, 15)
    got_t = kls.strip_tile(sq, st, stop, sleft, scorn, DNA_10_30_15, device=cuda)
    checks.append(("longpair_strip_tile_vs_xla", _same(ref_t, got_t)))
    saff = ScoringParams(matrix=DNA_10_30_15.matrix, gap_open=40, gap_extend=15)
    stopf = rng.integers(-30, 40, Cs)
    slefte = rng.integers(-30, 40, Rs)
    tbla = torch.as_tensor(_extended_table(saff))
    ref_t = kls._tile_colscan_affine(sq, st, stop, stopf, sleft, slefte, scorn, tbla, 4,
                                     40, 15)
    got_t = kls.strip_tile_affine(sq, st, stop, stopf, sleft, slefte, scorn, saff,
                                  device=cuda)
    checks.append(("longpair_strip_affine_tile_vs_xla", _same(ref_t, got_t)))

    # endpoint kernels (score, end_i, end_j) against the plain ends scans
    tie = ScoringParams.linear(np.where(np.eye(4, dtype=bool), 2, -1).astype(np.int32), 1)
    checks.append(("rowscan_ends_vs_xla",
                   _same(sw_batch_ends(qs, ts, tie, device=cuda),
                         sw_batch_diag_ends(qs, ts, tie, device=cpu))))
    taff = ScoringParams(tie.matrix, gap_open=3, gap_extend=1)
    checks.append(("affine_rowscan_ends_vs_xla",
                   _same(sw_affine_ends(qs, ts, taff, device=cuda),
                         sw_affine_batch_diag_ends(qs, ts, taff, device=cpu))))
    checks.append(("profile_ends_blosum62_vs_xla",
                   _same(sw_profile_ends(pq, pt, paff, device=cuda),
                         sw_affine_batch_diag_ends(pq, pt, paff, device=cpu))))

    # Karlin-Altschul calibration: fit (lambda, K) for the standard
    # protein config on the card's engine and compare to NCBI's own
    # simulation-fitted preset (0.267 / 0.041). At 256 x 256 the
    # finite-size bias is ~2% on lambda (see core/stats.py).
    ka = calibrate_stats(paff, "protein", m=256, pairs=4096, seed=10000, chunk=4096,
                         device=cuda)
    checks.append(("ka_calibration_vs_ncbi_preset",
                   abs(ka.lam - 0.267) < 0.267 * 0.12 and 0.015 < ka.K < 0.12))


def run_selftest(device=None) -> List[Tuple[str, bool]]:
    """(name, ok) of every check, in the JAX package's order, on
    ``device`` (the card unless the caller passes ``device="cpu"``)."""
    from swtpu_torch.batch import banded_align_batch
    from swtpu_torch.core.encode import mutate, random_dna
    from swtpu_torch.core.scoring import DNA_10_30_15
    from swtpu_torch.fuzz import run_fuzz
    from swtpu_torch.kernels.semiglobal_scan import nw_batch_diag
    from swtpu_torch.kernels.sw_scan import sw_batch_diag
    from swtpu_torch.models.msa import GAP, msa_center_star
    from swtpu_torch.oracle import banded_xdrop, nw_full, sw_score_batch

    dev = resolve_device(device)
    rng = np.random.default_rng(10000)
    qs, ts = random_dna(rng, (32, 128)), random_dna(rng, (32, 128))
    orc = sw_score_batch(qs, ts, DNA_10_30_15)
    checks = []

    got = _host(sw_batch_diag(qs, ts, DNA_10_30_15, device="cpu"))
    checks.append(("xla_vs_oracle", np.array_equal(got, orc)))

    # global/NW: the corner-pinned read-out of the semi-global scan
    nsc = _host(nw_batch_diag(qs[:8], ts[:8], match=2, mismatch=1, gap=1, device="cpu"))
    nref = [nw_full(qs[b], ts[b], 2, 1, 1)[0] for b in range(8)]
    checks.append(("nw_vs_oracle", list(nsc) == nref))

    if dev.type == "cuda":
        _card_checks(rng, qs, ts, orc, checks)

    # reference-scale geometry: one 16384-mer mutation pair end to end
    # (the per-round band and its walk) against the scalar banded oracle
    q16 = random_dna(rng, (1, 16384))
    t16 = np.stack([mutate(rng, q16[0], out_len=16384)])
    out16 = banded_align_batch(q16, t16, [16384], [16384], device=dev)
    s16, p16 = banded_xdrop(q16[0], t16[0])
    checks.append(("banded_16k_e2e_vs_scalar_oracle", out16[0] == (s16, p16)))

    # center-star MSA: degap + the exact projection invariant (the MSA's
    # (center, k) column score equals the pinned semi-global score)
    manc = random_dna(rng, (1, 96))[0]
    mseqs = [mutate(rng, manc) for _ in range(6)]
    mres = msa_center_star(mseqs, match=2, mismatch=3, gap=2, device=dev)
    ok_msa = all(
        np.array_equal(r[r != GAP].astype(np.uint8), s)
        for r, s in zip(mres.rows, mseqs)
    )
    for k in range(len(mseqs)):
        if k == mres.center:
            continue
        ra, rb = mres.rows[mres.center], mres.rows[k]
        keep = ~((ra == GAP) & (rb == GAP))
        a, b = ra[keep], rb[keep]
        both = (a != GAP) & (b != GAP)
        proj = int(np.where(a[both] == b[both], 2, -3).sum()) - 2 * int(
            ((a != GAP) ^ (b != GAP)).sum())
        ok_msa &= proj == mres.scores[k]
    checks.append(("msa_center_star_projection", ok_msa))

    # short soak: one round of every fuzz family but the last (the full
    # harness is `python -m swtpu_torch fuzz`)
    try:
        run_fuzz(minutes=30, max_rounds=10, log=None, save_dir=None,
                 pairs_per_round=256, device=dev)
        checks.append(("fuzz_soak_short", True))
    except AssertionError:
        checks.append(("fuzz_soak_short", False))
    return [(name, bool(ok)) for name, ok in checks]
