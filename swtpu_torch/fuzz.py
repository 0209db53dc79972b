"""Soak-scale randomized differential testing.

Port of ``swtpu/fuzz.py``: a time-bounded loop that streams seed-derived
random batches through every engine tier and counts mismatches against
the tier's oracle. The same 11 families (uniform DNA, tie-rich scoring,
a general 4x4 matrix, affine, protein/BLOSUM62, semi-global, the banded
mutation model, the fixed band, the streaming search top-k, CIGAR score
re-derivation, the block-adaptive band) rotate by round; each round draws
its geometry, scoring arm and data from ``seed + round`` exactly as the
JAX package does, so a failing round re-runs alone and each round sees
the JAX package's inputs. A mismatch saves its batch as an ``.npz``
repro and the loop goes on; the run raises AssertionError at the end.

``use_cuda`` takes the place of JAX's ``use_pallas`` (default: whether
``device``, the card by default, is a CUDA device).

- ``use_cuda=False`` runs, on the CPU, the plain counterparts of exactly
  the engines JAX's ``run_fuzz(use_pallas=False)`` runs (the XLA tiers;
  the fixed-band and block-band rounds are skipped, as JAX skips them
  without Pallas), so one seed and ``max_rounds`` give the JAX package's
  ``(rounds, pairs, cells, mismatches)``.
- ``use_cuda=True`` adds the CUDA kernels where JAX adds its Pallas
  tiers: the row-scan (row 1), its affine form (row 3) and the profile
  kernel (row 5) beside the plain local tiers; the semi-global kernel
  (row 8) beside the plain semi-global scan; the fixed band (row 10) and
  the block band (B9, rows 11-12) in their own rounds. Where JAX's form
  is XLA alone, the round runs the card's route of the port's entry
  point: ``best_ends_engine`` (rows 2/4/6), global alignment on the
  pinned semi-global kernel, the per-round band (rows 14/15), the
  streaming search (rows 1-6) and ``sw_align_batch``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from swtpu_torch.core import mutate, random_dna
from swtpu_torch.core.scoring import ScoringParams, dna_matrix
from swtpu_torch.utils.device import resolve_device

#: general (non-uniform) DNA matrix exercising the profile path
GENERAL4 = np.array(
    [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]],
    dtype=np.int32,
)

FAMILIES = [
    "uniform", "tie_rich", "general4", "affine",
    "protein", "semiglobal", "banded", "fixed_band",
    "search", "cigar", "banded_block",
]


@dataclasses.dataclass
class FuzzStats:
    rounds: int = 0
    #: engine-evaluations: each engine's differential run over a batch
    #: counts that batch once (a round testing 3 engines on B pairs adds
    #: 3B), mirroring the reference's per-kernel iteration counts
    pairs: int = 0
    cells: int = 0
    mismatches: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _card(use_cuda: bool) -> str:
    """Where a round's entry points run: the card or the CPU."""
    return "cuda" if use_cuda else "cpu"


def _engines_local(params: ScoringParams, use_cuda: bool):
    """name -> fn(qs, ts) -> scores, every applicable local tier."""
    from swtpu_torch.kernels.sw_batch import _uniform_match_mismatch

    eng: Dict[str, Callable] = {}
    if params.is_linear:
        from swtpu_torch.kernels.colscan import sw_batch_colscan
        from swtpu_torch.kernels.sw_scan import sw_batch_diag

        eng["xla_diag"] = lambda q, t: sw_batch_diag(q, t, params, device="cpu")
        eng["colscan"] = lambda q, t: sw_batch_colscan(q, t, params, device="cpu")
    else:
        from swtpu_torch.kernels.affine_scan import sw_affine_batch_diag

        eng["xla_affine"] = lambda q, t: sw_affine_batch_diag(q, t, params, device="cpu")
    if use_cuda:
        mm = _uniform_match_mismatch(params)
        if params.is_linear and mm is not None and mm[1] < 0 < params.gap:
            from swtpu_torch.kernels.sw_batch import sw_batch

            eng["rowscan"] = lambda q, t: sw_batch(q, t, params, device="cuda")
        elif not params.is_linear and mm is not None:
            from swtpu_torch.kernels.sw_affine import sw_affine

            eng["rowscan_affine"] = lambda q, t: sw_affine(q, t, params, device="cuda")
        if (
            mm is None
            and params.matrix.min() >= -127
            and params.matrix.max() <= 127
            and (params.gap if params.is_linear else params.gap_extend) > 0
        ):
            from swtpu_torch.kernels.sw_profile import sw_profile

            eng["rowscan_prof"] = lambda q, t: sw_profile(q, t, params, device="cuda")
    return eng


def _oracle_local(qs, ts, params: ScoringParams) -> np.ndarray:
    if params.is_linear:
        from swtpu_torch.oracle import sw_score_batch

        return sw_score_batch(qs, ts, params).astype(np.int64)
    from swtpu_torch.oracle.affine import sw_affine_score_batch

    return sw_affine_score_batch(qs, ts, params).astype(np.int64)


def _record_failure(stats: FuzzStats, family, rnd, detail, repro: dict,
                    save_dir: Optional[str]):
    stats.mismatches += 1
    msg = f"round {rnd} family {family}: {detail}"
    stats.failures.append(msg)
    if save_dir:
        import os

        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, f"fuzz_r{rnd}_{family}.npz")
        np.savez_compressed(path, **repro)
        stats.failures[-1] += f" (repro: {path})"


def _round_local(rng, stats, family, rnd, params, B, n, m, use_cuda,
                 save_dir, ends_check=True, pad_tail=True):
    qs = random_dna(rng, (B, n))
    ts = random_dna(rng, (B, m))
    want = _oracle_local(qs, ts, params)
    # engines see a pad-extended batch on ~1/3 of rounds: the pad
    # contract (q:4/t:5 never raise the max) is part of the spec.
    # (rng-drawn, NOT rnd % 3: with the family list rotating by rnd %
    # n_families, rnd-residue gates pin each family to one arm forever)
    if pad_tail and rng.integers(3) == 0:
        qe = np.concatenate([qs, np.full((B, 8), 4, np.uint8)], axis=1)
        te = np.concatenate([ts, np.full((B, 8), 5, np.uint8)], axis=1)
    else:
        qe, te = qs, ts
    for name, fn in _engines_local(params, use_cuda).items():
        got = _host(fn(qe, te)).astype(np.int64)
        if not np.array_equal(got, want):
            bad = int(np.flatnonzero(got != want)[0])
            _record_failure(
                stats, family, rnd,
                f"{name} score mismatch at pair {bad}: "
                f"{got[bad]} != {want[bad]}",
                dict(qs=qs, ts=ts, matrix=params.matrix,
                     go=params.gap_open, ge=params.gap_extend), save_dir,
            )
        stats.pairs += B
        stats.cells += B * n * m
    if ends_check:
        # endpoints: the entry point's argmax vs the traceback oracle on a
        # subsample
        from swtpu_torch.ops.variants import best_ends_engine

        nsub = min(B, 4)
        sub = slice(0, nsub)
        sc, ei, ej = (_host(x) for x in best_ends_engine(params, _card(use_cuda))(
            qe[sub], te[sub]))
        if params.is_linear:
            from swtpu_torch.oracle.sw import sw_traceback as tb
        else:
            from swtpu_torch.oracle.affine import sw_affine_traceback as tb
        for b in range(nsub):
            s0, path = tb(qs[b], ts[b], params)
            if not (s0 == sc[b] and path[-1] == (ei[b], ej[b])):
                _record_failure(
                    stats, family, rnd,
                    f"endpoint mismatch at pair {b}: "
                    f"({sc[b]},{ei[b]},{ej[b]}) vs {s0}@{path[-1]}",
                    dict(qs=qs[:4], ts=ts[:4], matrix=params.matrix,
                         go=params.gap_open, ge=params.gap_extend),
                    save_dir,
                )


def _round_protein(rng, stats, rnd, B, use_cuda, save_dir):
    from swtpu_torch.core.protein import blosum62_params, random_protein

    params = blosum62_params()
    n, m = 48, 64
    qs = random_protein(rng, (B, n))
    ts = random_protein(rng, (B, m))
    want = _oracle_local(qs, ts, params)
    for name, fn in _engines_local(params, use_cuda).items():
        got = _host(fn(qs, ts)).astype(np.int64)
        if not np.array_equal(got, want):
            bad = int(np.flatnonzero(got != want)[0])
            _record_failure(
                stats, "protein", rnd,
                f"{name} mismatch at pair {bad}: {got[bad]} != {want[bad]}",
                dict(qs=qs, ts=ts, matrix=params.matrix,
                     go=params.gap_open, ge=params.gap_extend), save_dir,
            )
        stats.pairs += B
        stats.cells += B * n * m


def _round_semiglobal(rng, stats, rnd, B, use_cuda, save_dir):
    from swtpu_torch.kernels.semiglobal_scan import nw_batch_diag, semiglobal_batch_diag
    from swtpu_torch.oracle.semiglobal import nw_full, semiglobal_full

    n, m = 48, 64
    qs = random_dna(rng, (B, n))
    ts = random_dna(rng, (B, m))
    # tie-rich (2,-1,1) on ~half the rounds: endpoint tie-breaks are spec
    ma, mi, g = (2, 1, 1) if rng.integers(2) else (1, 1, 1)
    sc = dict(match=ma, mismatch=mi, gap=g)
    fwd = [_host(x) for x in semiglobal_batch_diag(qs, ts, **sc, device="cpu")]
    if use_cuda:  # the semi-global kernel (row 8) beside the plain scan
        from swtpu_torch.kernels.semiglobal_batch import semiglobal_batch

        fwd2 = [_host(x) for x in semiglobal_batch(qs, ts, **sc, device="cuda")]
        for a, b, what in zip(fwd, fwd2, ("score", "end_i", "end_j")):
            if not np.array_equal(a, b):
                bad = int(np.flatnonzero(a != b)[0])
                _record_failure(
                    stats, "semiglobal", rnd,
                    f"kernel/plain {what} mismatch at pair {bad}",
                    dict(qs=qs, ts=ts, scoring=np.array([ma, mi, g])),
                    save_dir,
                )
        stats.pairs += B
    # scalar-oracle anchor on a subsample
    for b in range(min(B, 4)):
        s0, path = semiglobal_full(qs[b], ts[b], ma, mi, g)
        if not (s0 == fwd[0][b] and path[-1] == (fwd[1][b], fwd[2][b])):
            _record_failure(
                stats, "semiglobal", rnd,
                f"oracle mismatch at pair {b}: "
                f"({fwd[0][b]},{fwd[1][b]},{fwd[2][b]}) vs {s0}@{path[-1]}",
                dict(qs=qs[:4], ts=ts[:4], scoring=np.array([ma, mi, g])),
                save_dir,
            )
    stats.pairs += B
    stats.cells += B * n * m
    # global/NW read-out of the same family (pin_end): engine vs oracle;
    # on the card the pinned semi-global kernel
    if use_cuda:
        from swtpu_torch.kernels.semiglobal_batch import semiglobal_batch

        nsc = _host(semiglobal_batch(qs, ts, **sc, pin_end=True, device="cuda")[0])
    else:
        nsc = _host(nw_batch_diag(qs, ts, **sc, device="cpu"))
    for b in range(min(B, 4)):
        s0 = nw_full(qs[b], ts[b], ma, mi, g)[0]
        if s0 != nsc[b]:
            _record_failure(
                stats, "semiglobal", rnd,
                f"nw mismatch at pair {b}: {nsc[b]} vs {s0}",
                dict(qs=qs[:4], ts=ts[:4], scoring=np.array([ma, mi, g])),
                save_dir,
            )
    stats.pairs += B
    stats.cells += B * n * m


def _round_banded(rng, stats, rnd, B, use_cuda, save_dir):
    from swtpu_torch.oracle.banded_affine import banded_affine_xdrop
    from swtpu_torch.oracle.semiglobal import banded_xdrop

    L = 192
    qs = random_dna(rng, (B, L))
    ts = np.stack([mutate(rng, qs[b], out_len=L) for b in range(B)])
    # alternate linear / Gotoh rounds (the affine extension rides the
    # same H-only band history); rng-drawn so both arms run whatever the
    # family rotation period is
    affine = bool(rng.integers(2))
    kw = dict(gap_open=3, gap_extend=1) if affine else {}
    if use_cuda:  # the per-round kernel (rows 14/15)
        from swtpu_torch.kernels.banded_batch import banded_batch

        res = banded_batch(qs, ts, with_history=False, device="cuda", **kw)
    else:
        from swtpu_torch.kernels.banded_scan import banded_xdrop_batch

        res = banded_xdrop_batch(qs, ts, with_history=False, device="cpu", **kw)
    score = _host(res.score)
    for b in range(min(B, 8)):
        if affine:
            score0, _ = banded_affine_xdrop(qs[b], ts[b], **kw)
        else:
            score0, _ = banded_xdrop(qs[b], ts[b])
        if int(score[b]) != score0:
            _record_failure(
                stats, "banded", rnd,
                f"score mismatch at pair {b} ({kw or 'linear'}): "
                f"{int(score[b])} != {score0}",
                dict(qs=qs[:8], ts=ts[:8]), save_dir,
            )
    stats.pairs += B
    stats.cells += B * 32 * 2 * L  # band cells upper bound


def _round_banded_block(rng, stats, rnd, B, use_cuda, save_dir):
    """Block-adaptive tier (B9) vs ITS oracle (band-clipped tiers get
    band-clipped oracles): scores + endpoints on every checked pair, full
    history + host walk on a few. The kernel runs on the card only; the
    round is skipped elsewhere, as JAX skips it without Pallas."""
    if not use_cuda:
        return
    from swtpu_torch.kernels.banded_block import (
        banded_block_batch,
        banded_block_traceback_host,
    )
    from swtpu_torch.oracle.banded_block import banded_xdrop_block

    # geometry/scoring arms rng-drawn (never rnd residues, see the
    # round-rotation rule in run_fuzz)
    W, K = [(32, 16), (64, 32), (64, 64), (48, 16)][int(rng.integers(4))]
    L = int(rng.integers(80, 220))
    match, mismatch, gap, X = [
        (1, 1, 1, 70), (2, 1, 1, 40), (1, 3, 2, 30)
    ][int(rng.integers(3))]
    qs = random_dna(rng, (B, L))
    ts = np.stack([mutate(rng, qs[b], out_len=L) for b in range(B)])
    if rng.integers(2):  # non-homologous arm: per-pair death/freeze
        ts[: B // 2] = random_dna(rng, (B // 2, L))
    # varlen arm: rng-drawn per-pair lens exercise the kernel's row
    # freezes, per-pair n_rows, and the final-row X-drop fixup
    varlen = bool(rng.integers(2))
    lens_q = lens_t = None
    if varlen:
        lens_q = rng.integers(max(K // 2, 8), L + 1, B).astype(np.int64)
        lens_t = rng.integers(max(L // 2, 8), L + 1, B).astype(np.int64)
    res = banded_block_batch(
        qs, ts, match=match, mismatch=mismatch, gap=gap, width=W,
        block=K, x_threshold=X, with_history=True, with_meta=True,
        lens_q=lens_q, lens_t=lens_t, device="cuda",
    ).numpy()
    paths = banded_block_traceback_host(
        res, qs, ts, match=match, mismatch=mismatch, gap=gap, block=K,
        x_threshold=X,
    )
    for b in range(min(B, 6)):
        oq = qs[b] if not varlen else qs[b][: lens_q[b]]
        ot = ts[b] if not varlen else ts[b][: lens_t[b]]
        ora = banded_xdrop_block(
            oq, ot, match=match, mismatch=mismatch, gap=gap,
            width=W, block=K, x_threshold=X, return_state=True,
        )
        ok = (
            int(res.score[b]) == ora.score
            and (int(res.end_y[b]), int(res.end_j[b])) == ora.end
            and int(res.n_rows[b]) == ora.n_rows
            and np.array_equal(
                res.band_history[: ora.n_rows, :, b], ora.band_history
            )
            and paths[b] == ora.path
        )
        if not ok:
            _record_failure(
                stats, "banded_block", rnd,
                f"mismatch at pair {b} (W={W} K={K} "
                f"{match}/{mismatch}/{gap} X={X}): "
                f"{int(res.score[b])} != {ora.score}",
                dict(qs=qs[:8], ts=ts[:8]), save_dir,
            )
    stats.pairs += B
    stats.cells += B * W * L


def _round_fixed_band(rng, stats, rnd, B, use_cuda, save_dir):
    """Static-corridor (|i-j| <= W) kernel (row 10) vs its scalar oracle
    (the kernel runs on the card only; the round is skipped elsewhere)."""
    if not use_cuda:
        return
    from swtpu_torch.kernels.sw_banded import sw_banded_static
    from swtpu_torch.oracle.banded_static import sw_banded_static_score_batch

    L, W = 128, 16
    p = (
        ScoringParams.linear(dna_matrix(2, -1), 1)
        if rng.integers(2)
        else ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
    )
    qs = random_dna(rng, (B, L))
    ts = np.stack([mutate(rng, qs[b], out_len=L) for b in range(B)])
    got = _host(sw_banded_static(qs, ts, p, bandwidth=W, device="cuda"))
    want = sw_banded_static_score_batch(
        qs[:16], ts[:16], p, W
    ).astype(np.int64)
    if not np.array_equal(got[:16].astype(np.int64), want):
        bad = int(np.flatnonzero(got[:16] != want)[0])
        _record_failure(
            stats, "fixed_band", rnd,
            f"score mismatch at pair {bad}: {got[bad]} != {want[bad]}",
            dict(qs=qs[:16], ts=ts[:16], matrix=p.matrix,
                 go=p.gap_open, ge=p.gap_extend), save_dir,
        )
    stats.pairs += B
    stats.cells += B * (2 * W + 1) * L


def _round_search(rng, stats, rnd, use_cuda, save_dir):
    """Streaming all-vs-all top-k (device-resident merge state) vs a
    brute-force numpy rescore, incl. the deterministic tie order (score
    desc, id asc) and the padded tail chunk. Geometry from a fixed
    2-entry palette."""
    from swtpu_torch.parallel.search import all_vs_all_topk

    Nq, L, Nt, chunk, k = [(4, 64, 37, 16, 5), (3, 48, 24, 8, 8)][
        int(rng.integers(2))
    ]
    # tie-rich (2,-1,1) on half the rounds: merge tie order is spec
    ma, mi, g = (2, -1, 1) if rng.integers(2) else (1, -1, 1)
    params = ScoringParams.linear(dna_matrix(ma, mi), g)
    Q = random_dna(rng, (Nq, L))
    T = random_dna(rng, (Nt, L))
    got_s, got_i = all_vs_all_topk(Q, T, params, k=k, chunk_size=chunk,
                                   device=_card(use_cuda))
    ref = np.stack(
        [
            _oracle_local(np.repeat(Q[b : b + 1], Nt, 0), T, params)
            for b in range(Nq)
        ]
    )
    ids = np.arange(Nt)[None, :].repeat(Nq, 0)
    order = np.lexsort((ids, -ref), axis=1)[:, :k]
    want_s = np.take_along_axis(ref, order, axis=1).astype(np.int64)
    if not (
        np.array_equal(got_i.astype(np.int64), order)
        and np.array_equal(got_s.astype(np.int64), want_s)
    ):
        _record_failure(
            stats, "search", rnd,
            f"top-{k} mismatch (Nq={Nq} Nt={Nt} chunk={chunk} "
            f"scoring=({ma},{mi},{g}))",
            dict(Q=Q, T=T, matrix=params.matrix, gap=np.array([g]),
                 k=np.array([k]), chunk=np.array([chunk])), save_dir,
        )
    stats.pairs += Nq * Nt
    stats.cells += Nq * Nt * L * L


def _round_cigar(rng, stats, rnd, use_cuda, save_dir):
    """Traceback path -> CIGAR -> independent score re-derivation.
    sw_align_batch paths are re-walked column by column (matrix score per
    =/X/M, linear or Gotoh gap-run costs for I/D runs) and the re-derived
    score must equal the engine score; CIGAR op counts must consume
    exactly the query (soft clips included) and the path's target span."""
    from swtpu_torch.batch.traceback import sw_align_batch
    from swtpu_torch.core.cigar import cigar_stats, path_to_cigar

    B, n, m = 8, 64, 80
    affine = bool(rng.integers(2))
    params = (
        ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1)
        if affine
        else ScoringParams.linear(dna_matrix(2, -1), 1)
    )
    qs = random_dna(rng, (B, n))
    # mutation-model on half the rounds: long homologous paths with runs
    if rng.integers(2):
        ts = np.stack([mutate(rng, qs[b], out_len=m) for b in range(B)])
    else:
        ts = random_dna(rng, (B, m))
    for b, (score, path) in enumerate(
        sw_align_batch(qs, ts, params, device=_card(use_cuda))
    ):
        cg = path_to_cigar(path, qs[b], ts[b], query_len=n)
        st = cigar_stats(cg)
        # consumption invariants
        ok = st["query_consumed"] == n
        if len(path) >= 2:
            ok = ok and st["target_consumed"] == path[-1][1] - path[0][1]
        # independent score re-derivation from the path
        rescore = 0
        run = None  # current gap-run op or None
        for (i0, j0), (i1, j1) in zip(path, path[1:]):
            if i1 > i0 and j1 > j0:
                rescore += int(
                    params.matrix[qs[b][i1 - 1], ts[b][j1 - 1]]
                )
                run = None
            else:
                op = "I" if i1 > i0 else "D"
                rescore -= int(
                    params.gap_extend
                    + (0 if run == op else params.gap_open - params.gap_extend)
                    if not params.is_linear
                    else params.gap
                )
                run = op
        ok = ok and rescore == int(score)
        if not ok:
            _record_failure(
                stats, "cigar", rnd,
                f"pair {b}: cigar={cg} stats={st} rescore={rescore} "
                f"score={int(score)} ({'affine' if affine else 'linear'})",
                dict(qs=qs, ts=ts, matrix=params.matrix,
                     go=params.gap_open, ge=params.gap_extend), save_dir,
            )
    stats.pairs += B
    stats.cells += B * n * m


def run_fuzz(
    minutes: float = 1.0,
    seed: int = 10000,
    pairs_per_round: int = 512,
    families: Optional[List[str]] = None,
    use_cuda: Optional[bool] = None,
    save_dir: Optional[str] = "fuzz_failures",
    log: Optional[Callable[[str], None]] = print,
    max_rounds: Optional[int] = None,
    device=None,
) -> FuzzStats:
    """Run the soak loop for ~minutes of wall time (or ``max_rounds``).
    Returns FuzzStats; raises AssertionError at the end if any mismatch
    was recorded. ``device``: the card unless the caller passes
    ``device="cpu"``; ``use_cuda`` defaults to whether it is a CUDA
    device (module note)."""
    dev = resolve_device(device)
    if use_cuda is None:
        use_cuda = dev.type == "cuda"
    if use_cuda and dev.type != "cuda":
        raise ValueError("use_cuda=True runs the CUDA kernels: it needs the card")
    families = families or FAMILIES
    for f in families:
        if f not in FAMILIES:
            raise ValueError(f"unknown family {f!r}; have {FAMILIES}")
    stats = FuzzStats()
    B = pairs_per_round
    deadline = time.monotonic() + minutes * 60.0
    rnd = 0
    while time.monotonic() < deadline:
        if max_rounds is not None and rnd >= max_rounds:
            break
        fam = families[rnd % len(families)]
        # per-round RNG: failing rounds re-run standalone. All intra-
        # family config choices (geometry, scoring arm, pad gate) are
        # drawn from THIS rng, never from rnd residues: the family
        # itself is rnd % len(families), so an `rnd % k` gate with
        # k | len(families) would pin a family to one arm forever.
        rng = np.random.default_rng(seed + rnd)
        # geometry from a fixed palette (incl. non-tile-aligned lengths)
        n, m = [(64, 96), (128, 128), (100, 137), (48, 64)][
            int(rng.integers(4))
        ]
        if fam == "uniform":
            sc = [(1, -1, 1), (10, -30, 15)][int(rng.integers(2))]
            _round_local(
                rng, stats, fam, rnd,
                ScoringParams.linear(dna_matrix(sc[0], sc[1]), sc[2]),
                B, n, m, use_cuda, save_dir,
            )
        elif fam == "tie_rich":
            _round_local(
                rng, stats, fam, rnd,
                ScoringParams.linear(dna_matrix(2, -1), 1),
                B, n, m, use_cuda, save_dir,
            )
        elif fam == "general4":
            _round_local(
                rng, stats, fam, rnd, ScoringParams.linear(GENERAL4, 2),
                B, n, m, use_cuda, save_dir,
            )
        elif fam == "affine":
            _round_local(
                rng, stats, fam, rnd,
                ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1),
                B, n, m, use_cuda, save_dir,
            )
        elif fam == "protein":
            _round_protein(rng, stats, rnd, max(B // 4, 32), use_cuda, save_dir)
        elif fam == "semiglobal":
            _round_semiglobal(rng, stats, rnd, B, use_cuda, save_dir)
        elif fam == "banded":
            _round_banded(rng, stats, rnd, max(B // 8, 16), use_cuda, save_dir)
        elif fam == "fixed_band":
            _round_fixed_band(rng, stats, rnd, max(B // 8, 16), use_cuda, save_dir)
        elif fam == "banded_block":
            _round_banded_block(rng, stats, rnd, max(B // 8, 16), use_cuda, save_dir)
        elif fam == "search":
            _round_search(rng, stats, rnd, use_cuda, save_dir)
        elif fam == "cigar":
            _round_cigar(rng, stats, rnd, use_cuda, save_dir)
        stats.rounds = rnd = rnd + 1
        if log and rnd % 20 == 0:
            log(
                f"fuzz: {rnd} rounds, {stats.pairs} pairs, "
                f"{stats.cells / 1e9:.2f} Gcells, "
                f"{stats.mismatches} mismatches"
            )
    if log:
        log(json.dumps(dict(
            rounds=stats.rounds, pairs=stats.pairs, cells=stats.cells,
            mismatches=stats.mismatches,
        )))
        for f in stats.failures[:20]:
            log("FAIL: " + f)
    if stats.mismatches:
        raise AssertionError(
            f"fuzz found {stats.mismatches} mismatches "
            f"({stats.rounds} rounds, {stats.pairs} pairs)"
        )
    return stats
