"""swtpu_torch command-line interface: ``align``, ``semiglobal``,
``global``, ``banded``, ``longpair``, ``search``, ``map``, ``msa``,
``assemble``, ``pack``, ``bench``, ``selftest`` and ``fuzz``.

Port of ``swtpu/cli.py``'s ``align`` (local Smith-Waterman alignment of
query/target pairs), ``semiglobal`` and ``global`` (semi-global and
Needleman-Wunsch alignment with traceback), ``banded`` (adaptive-banded
X-drop semi-global alignment; ``--fixed``: local alignment in the fixed
corridor |i - j| <= bandwidth), ``longpair`` (one long pair on one
card, tile by tile), ``search`` (all-vs-all top-k database search,
BASELINE config 5: JSON hits, ``--tsv`` BLAST outfmt-6 rows with
Karlin-Altschul E-values and bit scores under ``--stats``, or SAM),
``map`` (seed-and-extend read mapping), ``msa`` (center-star multiple
alignment), ``assemble`` (greedy overlap-layout-consensus assembly),
``pack`` (DNA FASTA <-> the 2-bit ``.npz`` container), ``bench`` (the
benchmark suite, ``bench_suite.main`` with the arguments that follow),
``selftest`` (the
oracles against every tier that runs there: on the card the CUDA
kernels) and ``fuzz`` (the randomized soak of ``swtpu_torch/fuzz.py``). Output is the
same JSON lines (TSV, SAM, FASTA) as
``python -m swtpu`` prints for the same arguments; ``map`` on the card
takes the card's route (``models/mapper.py``), so its hit scores follow
the fixed corridor and the block tier there. ``banded
--block-adaptive`` runs the block tier (width 2 x bandwidth, block
bandwidth) on the card, where JAX runs it only on the TPU.

Usage:
  python -m swtpu_torch align --random 1024x128x128 --scoring 10,-30 --gap 15
  python -m swtpu_torch align --queries q.fa --targets t.fa --cigar
  python -m swtpu_torch align --queries q.npz --targets t.npz --sam
  python -m swtpu_torch align --random 64x128x128 --scoring 10,-30 --gap 15 --engine rowscan_bf16
  python -m swtpu_torch align --random 8x64x64 --gap-open 40 --gap-extend 15 --sam
  python -m swtpu_torch align --alphabet protein --random 64x128x128 --gap-open 11 --gap-extend 1
  python -m swtpu_torch align --random 8x64x64 --device cpu
  python -m swtpu_torch semiglobal --random 8x200x200 --traceback
  python -m swtpu_torch global --queries q.fa --targets t.fa --cigar
  python -m swtpu_torch global --alphabet protein --random 8x128x128 --gap-open 11 --gap-extend 1 --sam
  python -m swtpu_torch banded --random 8x200x200 --x-drop 70 --cigar
  python -m swtpu_torch banded --alphabet protein --random 8x128x128 --gap-open 11 --gap-extend 1 --x-drop 120 --sam
  python -m swtpu_torch banded --fixed --random 64x128x128 --bandwidth 32
  python -m swtpu_torch banded --block-adaptive --random 8x2048x2048 --bandwidth 32 --cigar
  python -m swtpu_torch banded --block-adaptive --alphabet protein --random 8x300x300 --x-drop 120
  python -m swtpu_torch banded --fixed --random 8x128x128 --gap-open 3 --gap-extend 1 --traceback
  python -m swtpu_torch align --random 128x128x128 --scoring 10,-30 --gap 15 --engine wavefront
  python -m swtpu_torch longpair --random 1x16384x16384 --traceback
  python -m swtpu_torch longpair --queries q.fa --targets t.fa --block 4096 --cigar
  python -m swtpu_torch search --random 16x131072x128 --topk 10 --chunk 8192
  python -m swtpu_torch search --queries q.fa --targets db.fa --tsv --stats calibrate
  python -m swtpu_torch search --alphabet protein --queries q.fa --targets db.fa --gap-open 11 --gap-extend 1 --tsv --stats preset
  python -m swtpu_torch search --random 4x64x100 --both-strands --sam --device cpu
  python -m swtpu_torch map --random 1000000x4096x152 --min-score 20 --traceback
  python -m swtpu_torch map --reads reads.fa --ref ref.fa --both-strands --sam
  python -m swtpu_torch msa --random 48x256 --scoring 2,-3 --gap 2
  python -m swtpu_torch msa --alphabet protein --queries fam.fa --gap-open 11 --gap-extend 1
  python -m swtpu_torch assemble --random 20000x150x50
  python -m swtpu_torch assemble --reads reads.fa --slack 2 --sam --device cpu
  torchrun --nproc-per-node 2 -m swtpu_torch longpair --random 1x16384x16384
  python -m swtpu_torch selftest
  python -m swtpu_torch fuzz --rounds 22 --pairs 512
  python -m swtpu_torch pack reads.fa reads.npz
  python -m swtpu_torch pack reads.npz reads.fa --unpack

``--device`` defaults to ``cuda``: without a card the command fails
rather than run on the CPU. ``--alphabet protein`` scores with BLOSUM62
(``--scoring`` is then ignored). Inputs ending in ``.npz`` are read as
the 2-bit container (DNA only). ``--engine`` names a score engine of
``ops.variants.VARIANTS`` for linear scores; a name whose guard does not
pass and an unknown name run ``best_engine`` (a kernel on the card, the
plain tier on the CPU), and so do the plain tiers' names (the default
``xla_diag``, ``colscan``) on the card. ``longpair --devices N`` runs in
a world of N processes, one a device (``torchrun --nproc-per-node N -m
swtpu_torch longpair ...``; ``--device cpu`` runs the world on gloo):
rank 0 prints what ``python -m swtpu longpair --devices N`` prints.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from swtpu_torch import bench_suite


def _pad_codes(alphabet):
    """Alphabet-correct FASTA pad codes (query, target).

    DNA uses 4/5 (first codes past the 0..3 alphabet). Protein must NOT:
    4/5 are real residues (C, Q — BLOSUM62 C-C is +9), so its pads are
    the reserved 24/25 just past the 24-letter NCBI alphabet.
    """
    if alphabet == "protein":
        from swtpu_torch.core.protein import PROTEIN_Q_PAD, PROTEIN_T_PAD

        return PROTEIN_Q_PAD, PROTEIN_T_PAD
    return 4, 5


def _load_seq_batch(path, alphabet, pad_code, pad_to=0):
    """Load a sequence batch: FASTA, or a 2-bit-packed .npz container
    (``pack``) by extension."""
    from swtpu_torch.core.io import load_fasta_batch, load_packed_batch

    if path.endswith(".npz"):
        if alphabet != "dna":
            raise SystemExit("2-bit packed input is DNA-only")
        return load_packed_batch(path, pad_to=pad_to, pad_code=pad_code)
    return load_fasta_batch(path, alphabet, pad_to=pad_to, pad_code=pad_code)


def _load_pair_inputs(args):
    if args.random:
        b, n, m = (int(x) for x in args.random.split("x"))
        rng = np.random.default_rng(args.seed)
        hi = 4 if args.alphabet == "dna" else 20
        qs = rng.integers(0, hi, size=(b, n)).astype(np.uint8)
        ts = rng.integers(0, hi, size=(b, m)).astype(np.uint8)
        names = [f"pair{i}" for i in range(b)]
        return names, qs, ts, np.full(b, n), np.full(b, m)
    if not (args.queries and args.targets):
        raise SystemExit("need --random BxNxM or --queries/--targets FASTA")
    pad_q, pad_t = _pad_codes(args.alphabet)
    qn, qs, ql = _load_seq_batch(args.queries, args.alphabet, pad_code=pad_q)
    tn, ts, tl = _load_seq_batch(args.targets, args.alphabet, pad_code=pad_t)
    if len(qs) != len(ts):
        raise SystemExit(
            f"pairwise mode needs equal counts, got {len(qs)} vs {len(ts)}"
        )
    return [f"{a}|{b}" for a, b in zip(qn, tn)], qs, ts, ql, tl


def _scoring(args):
    from swtpu_torch.core.scoring import ScoringParams, dna_matrix

    if args.alphabet == "protein":
        from swtpu_torch.core.protein import BLOSUM62

        mat = BLOSUM62
    else:
        match, mismatch = (int(x) for x in args.scoring.split(","))
        mat = dna_matrix(match, mismatch)
    if args.gap_open is not None:
        return ScoringParams(
            mat, gap_open=args.gap_open, gap_extend=args.gap_extend
        )
    return ScoringParams.linear(mat, args.gap)


def _emit_sam(names, qs, ts, ql, tl, alphabet, results):
    """Print SAM 1.6 (header + one record per pair) for an iterable of
    (score, path) results; pair names 'q|t' split into QNAME/RNAME."""
    from swtpu_torch.core.sam import sam_header, sam_record

    qn = [n.split("|", 1)[0] for n in names]
    tn = [
        n.split("|", 1)[1] if "|" in n else f"{n}:target" for n in names
    ]
    print(sam_header(list(zip(tn, [int(x) for x in tl]))))
    for k, (score, path) in enumerate(results):
        print(
            sam_record(
                qn[k], tn[k], qs[k], ts[k], score, path, alphabet,
                query_len=int(ql[k]),
            )
        )


def cmd_align(args):
    names, qs, ts, ql, tl = _load_pair_inputs(args)
    params = _scoring(args)
    if args.sam or args.traceback or args.cigar:
        from swtpu_torch.batch import sw_align_batch

        results = sw_align_batch(qs, ts, params, device=args.device)
        if args.sam:
            _emit_sam(names, qs, ts, ql, tl, args.alphabet, results)
            return
        from swtpu_torch.core.cigar import path_to_cigar

        for k, (name, (score, path)) in enumerate(zip(names, results)):
            rec = dict(pair=name, score=score)
            if args.traceback:
                rec["path"] = path
            if args.cigar:
                rec["cigar"] = path_to_cigar(
                    path, qs[k], ts[k], query_len=int(ql[k])
                )
            print(json.dumps(rec))
        return
    from swtpu_torch.ops.variants import best_engine, variant_engine

    if params.is_linear:
        fn = variant_engine(args.engine, params, qs.shape[1], args.device)
    else:
        fn = best_engine(params, args.device)
    scores = np.asarray(torch.as_tensor(fn(qs, ts)).cpu())
    for name, s in zip(names, scores):
        print(json.dumps(dict(pair=name, score=int(s))))


def cmd_semiglobal(args, pin_end=False):
    """Semi-global (or, ``pin_end``, global) alignment with traceback:
    JSON records with score, start and end (``--traceback`` the path,
    ``--cigar`` a CIGAR without soft clips), or SAM."""
    names, qs, ts, ql, tl = _load_pair_inputs(args)
    from swtpu_torch.batch import semiglobal_align_batch

    # varlen FASTA batches pass their lengths; uniform batches do not
    varlen = bool(
        (np.asarray(ql) != qs.shape[1]).any()
        or (np.asarray(tl) != ts.shape[1]).any()
    )
    kw = dict(lens_q=ql, lens_t=tl) if varlen else {}
    kw.update(pin_end=pin_end, device=args.device)
    if args.alphabet == "protein":
        out = semiglobal_align_batch(qs, ts, params=_scoring(args), **kw)
    else:
        match, mismatch = (int(x) for x in args.scoring.split(","))
        out = semiglobal_align_batch(
            qs, ts, match, abs(mismatch), args.gap,
            gap_open=args.gap_open,
            gap_extend=args.gap_extend if args.gap_open is not None else None,
            **kw,
        )
    if args.sam:
        _emit_sam(names, qs, ts, ql, tl, args.alphabet, out)
        return
    from swtpu_torch.core.cigar import path_to_cigar

    for k, (name, (score, path)) in enumerate(zip(names, out)):
        rec = dict(pair=name, score=score, start=path[0], end=path[-1])
        if args.traceback:
            rec["path"] = path
        if args.cigar:
            # semi-global: the alignment window is the path itself, no
            # soft clips (it starts at the top-left by definition)
            rec["cigar"] = path_to_cigar(path, qs[k], ts[k])
        print(json.dumps(rec))


def cmd_banded(args):
    """Adaptive-banded X-drop semi-global alignment (JSON records with
    score, start and end, or SAM), or with ``--fixed`` fixed-corridor
    local alignment (scores; paths with --traceback/--cigar/--sam)."""
    names, qs, ts, ql, tl = _load_pair_inputs(args)
    match, mismatch = (int(x) for x in args.scoring.split(","))
    from swtpu_torch.core.cigar import path_to_cigar

    if args.fixed:
        # fixed diagonal corridor |i-j| <= W (BASELINE configs 1-2
        # geometry); DNA and protein scoring via --alphabet
        from swtpu_torch.batch.traceback import (
            banded_static_align_batch,
            banded_static_scores,
        )

        params = _scoring(args)
        if args.traceback or args.cigar or args.sam:
            out = banded_static_align_batch(
                qs, ts, params, bandwidth=args.bandwidth, device=args.device
            )
            if args.sam:
                _emit_sam(names, qs, ts, ql, tl, args.alphabet, out)
                return
            for k, (name, (score, path)) in enumerate(zip(names, out)):
                rec = dict(pair=name, score=score)
                if args.traceback:
                    rec["path"] = path
                if args.cigar:
                    rec["cigar"] = path_to_cigar(
                        path, qs[k], ts[k], query_len=int(ql[k])
                    )
                print(json.dumps(rec))
            return
        scores = banded_static_scores(
            qs, ts, params, bandwidth=args.bandwidth, device=args.device
        ).cpu().numpy()
        for name, s in zip(names, scores):
            print(json.dumps(dict(pair=name, score=int(s))))
        return
    if args.block_adaptive:
        # the block-adaptive tier: linear / affine / protein; per-pair lens on
        # linear gaps only; the device walk for paths (linear)
        from swtpu_torch.kernels.banded_block import (
            banded_block_align_device,
            banded_block_batch,
        )

        varlen = not (np.all(ql == ql[0]) and np.all(tl == tl[0]))
        if varlen and args.gap_open is not None:
            raise SystemExit(
                "--block-adaptive affine needs uniform lengths; the "
                "linear engines take per-pair lens (round 5)"
            )
        kw = dict(
            match=match, mismatch=abs(mismatch),
            width=args.bandwidth * 2, block=args.bandwidth,
            x_threshold=args.x_drop,
            matrix=_scoring(args).matrix if args.alphabet == "protein" else None,
            device=args.device,
        )
        qs2 = qs[:, : int(ql.max())]
        ts2 = ts[:, : int(tl.max())]
        if varlen:
            kw["lens_q"] = ql
            kw["lens_t"] = tl
        if args.traceback or args.cigar:
            if args.gap_open is not None:
                raise SystemExit(
                    "--block-adaptive affine traceback: use the python "
                    "API (banded_block_traceback_host); the CLI device "
                    "walk is linear-gap"
                )
            out = banded_block_align_device(qs2, ts2, gap=args.gap, **kw)
            for k, (name, (score, path)) in enumerate(zip(names, out)):
                rec = dict(pair=name, score=score, start=path[0], end=path[-1])
                if args.traceback:
                    rec["path"] = path
                if args.cigar:
                    rec["cigar"] = path_to_cigar(path, qs2[k], ts2[k])
                print(json.dumps(rec))
            return
        res = banded_block_batch(
            qs2, ts2,
            gap=args.gap if args.gap_open is None else 1,
            gap_open=args.gap_open,
            gap_extend=args.gap_extend if args.gap_open is not None else None,
            **kw,
        ).numpy()
        for k, name in enumerate(names):
            print(json.dumps(dict(
                pair=name, score=int(res.score[k]),
                end=[int(res.end_y[k]), int(res.end_j[k])],
            )))
        return
    from swtpu_torch.batch import banded_align_batch

    # linear and affine ride the same device forward pass; affine paths
    # come from the host Gotoh walker over the device band history.
    # --alphabet protein selects the general-matrix (BLOSUM62) mode.
    out = banded_align_batch(
        qs,
        ts,
        list(ql),
        list(tl),
        match=match,
        mismatch=abs(mismatch),
        gap=args.gap,
        bandwidth=args.bandwidth,
        x_threshold=args.x_drop,
        gap_open=args.gap_open,
        gap_extend=args.gap_extend if args.gap_open is not None else None,
        matrix=_scoring(args).matrix if args.alphabet == "protein" else None,
        device=args.device,
    )
    if args.sam:
        _emit_sam(names, qs, ts, ql, tl, args.alphabet, out)
        return
    for k, (name, (score, path)) in enumerate(zip(names, out)):
        rec = dict(pair=name, score=score, start=path[0], end=path[-1])
        if args.traceback:
            rec["path"] = path
        if args.cigar:
            # banded semi-global: path starts at the top-left, no clips
            rec["cigar"] = path_to_cigar(path, qs[k], ts[k])
        print(json.dumps(rec))


def cmd_longpair(args):
    """One long pair at a time, its query strips over the mesh's sp axis:
    one process a device (``torchrun --nproc-per-node N -m swtpu_torch
    longpair ...``), strip boundaries point to point (parallel/longpair.py),
    each strip in sub-strips of at most 16384 rows, the target in column
    blocks. Rank 0 prints; the other ranks sweep their strips."""
    import torch.distributed as dist

    from swtpu_torch.parallel import (
        init_distributed,
        longpair_sw_align,
        longpair_sw_ends,
        longpair_sw_score,
        make_mesh,
    )
    from swtpu_torch.parallel.longpair import _auto_block

    init_distributed(backend=args.backend, device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_dev = args.devices or world
    if n_dev != world:
        raise SystemExit(
            f"longpair --devices {n_dev} runs one process a device, and this world "
            f"has {world}: start it with torchrun --nproc-per-node {n_dev} -m "
            "swtpu_torch longpair ..."
        )
    mesh = make_mesh(n_dev, axis="sp", device=args.device) if world > 1 else None
    lead = not dist.is_initialized() or dist.get_rank() == 0
    names, qs, ts, ql, tl = _load_pair_inputs(args)
    params = _scoring(args)
    sam_rows = []  # (name, trimmed q, trimmed t, score, path)
    for name, q, t, lq, lt in zip(names, qs, ts, ql, tl):
        q, t = q[:lq], t[:lt]
        # strip/block divisibility: trim to the mesh/block grid
        if len(q) < n_dev or len(t) < (args.block or 1):
            blk = args.block if args.block is not None else "auto"
            raise SystemExit(
                f"longpair needs len(q) >= devices ({n_dev}) and len(t) >="
                f" --block ({blk}); got {len(q)}x{len(t)} for"
                f" {name} — lower --block/--devices or use `align`"
            )
        if len(q) % n_dev:
            new_lq = len(q) - len(q) % n_dev
            if lead:
                print(
                    f"warning: {name}: query trimmed {len(q)} -> {new_lq} to a"
                    f" multiple of --devices ({n_dev}); reported score is for"
                    " the TRIMMED pair",
                    file=sys.stderr,
                )
            q = q[:new_lq]
        block = args.block
        if block is None:
            # auto: the step-count-optimal divisor of len(t) (the whole
            # target on one device), so the target is never trimmed
            block = _auto_block(len(q), len(t), n_dev)
        elif len(t) % block:
            new_lt = len(t) - len(t) % block
            if lead:
                print(
                    f"warning: {name}: target trimmed {len(t)} -> {new_lt} to a"
                    f" multiple of --block ({block}); reported score is for"
                    " the TRIMMED pair",
                    file=sys.stderr,
                )
            t = t[:new_lt]
        if not lead:  # the sweep is collective; the walk and the output are rank 0's
            longpair_sw_ends(q, t, params, mesh, block=block, device=args.device)
            continue
        if args.traceback or args.cigar or args.sam:
            score, path = longpair_sw_align(q, t, params, mesh, block=block,
                                            device=args.device)
            if args.sam:
                sam_rows.append((name, q, t, score, path))
                continue
            rec = dict(pair=name, score=score)
            if args.traceback:
                rec["path"] = path
            if args.cigar:
                from swtpu_torch.core.cigar import path_to_cigar

                rec["cigar"] = path_to_cigar(path, q, t, query_len=len(q))
            print(json.dumps(rec))
        else:
            score = longpair_sw_score(q, t, params, mesh, block=block,
                                      device=args.device)
            print(json.dumps(dict(pair=name, score=score)))
    if sam_rows:
        _emit_sam(
            [r[0] for r in sam_rows],
            [r[1] for r in sam_rows],
            [r[2] for r in sam_rows],
            [len(r[1]) for r in sam_rows],
            [len(r[2]) for r in sam_rows],
            args.alphabet,
            [(r[3], r[4]) for r in sam_rows],
        )


def _gap_runs(path):
    """Gap openings of a path: runs of equal non-diagonal steps."""
    runs, prev = 0, None
    for (a, b), (c, d) in zip(path, path[1:]):
        step = (c - a, d - b)
        if step != (1, 1) and step != prev:
            runs += 1
        prev = step
    return runs


def cmd_search(args):
    """All-vs-all top-k search of every query against the database
    (``parallel/search.py``), then with ``--tsv`` / ``--sam`` /
    ``--cigar`` / ``--traceback`` a batched traceback of every hit
    (``sw_align_batch``)."""
    from swtpu_torch.parallel.search import SearchCheckpoint, all_vs_all_topk
    from swtpu_torch.utils.obs import RunLog

    params = _scoring(args)
    if args.random:
        nq, nt, L = (int(x) for x in args.random.split("x"))
        rng = np.random.default_rng(args.seed)
        hi = 4 if args.alphabet == "dna" else 20
        Q = rng.integers(0, hi, size=(nq, L)).astype(np.uint8)
        T = rng.integers(0, hi, size=(nt, L)).astype(np.uint8)
        qn = [f"q{i}" for i in range(nq)]
        tn = [f"t{i}" for i in range(nt)]
        ql = np.full(nq, L)
        tl = np.full(nt, L)
    else:
        pad_q, pad_t = _pad_codes(args.alphabet)
        qn, Q, ql = _load_seq_batch(args.queries, args.alphabet, pad_code=pad_q)
        tn, T, tl = _load_seq_batch(args.targets, args.alphabet, pad_code=pad_t)
    log = RunLog()
    ckpt = SearchCheckpoint(args.checkpoint) if args.checkpoint else None
    Nq = len(Q)
    Qrc = None
    Qx = Q
    if args.both_strands:
        if args.alphabet != "dna":
            raise SystemExit("--both-strands is DNA-only")
        from swtpu_torch.core.encode import revcomp

        # the reverse complements as extra query rows: one search over
        # [2 Nq] queries, then a per-query merge of the two strands
        Qrc = np.stack([revcomp(Q[i], ql[i]) for i in range(Nq)])
        Qx = np.concatenate([Q, Qrc])
    scores, ids = all_vs_all_topk(
        Qx, T, params, k=args.topk, chunk_size=args.chunk, checkpoint=ckpt,
        # the search loop emits serialized JSON lines; RunLog adds ts
        log=(lambda line: log.emit(**json.loads(line))) if args.verbose else None,
        device=args.device,
    )
    if args.both_strands:
        # deterministic strand merge: score desc, target id asc, '+' first
        s2 = np.concatenate([scores[:Nq], scores[Nq:]], axis=1)
        i2 = np.concatenate([ids[:Nq], ids[Nq:]], axis=1)
        st2 = np.concatenate([np.zeros_like(ids[:Nq]), np.ones_like(ids[Nq:])], axis=1)
        order = np.lexsort((st2, i2, -s2), axis=1)[:, : args.topk]
        scores = np.take_along_axis(s2, order, axis=1)
        ids = np.take_along_axis(i2, order, axis=1)
        strands = np.take_along_axis(st2, order, axis=1)
    else:
        strands = np.zeros_like(ids)
    if not (args.sam or args.cigar or args.traceback or args.tsv):
        for i, name in enumerate(qn):
            hits = [
                dict(target=tn[j] if j < len(tn) else int(j), score=int(s),
                     **(dict(strand="-" if st else "+") if args.both_strands else {}))
                for s, j, st in zip(scores[i], ids[i], strands[i]) if s >= 0
            ]
            print(json.dumps(dict(query=name, hits=hits)))
        return
    # every surviving (query, hit) pair walked in one batched call
    from swtpu_torch.batch import sw_align_batch
    from swtpu_torch.core.cigar import cigar_stats, path_to_cigar

    hits = [(i, int(j), int(st)) for i in range(len(qn))
            for s, j, st in zip(scores[i], ids[i], strands[i]) if s >= 0]
    pj = [h[1] for h in hits]

    def qrow(i, st):  # the aligned query row is the strand that hit
        return Qrc[i] if st else Q[i]

    Qsel = np.stack([qrow(i, st) for i, _, st in hits]) if hits else Q[:0]
    aligned = sw_align_batch(Qsel, T[pj], params, device=args.device) if hits else []
    if args.sam:
        from swtpu_torch.core.sam import sam_header, sam_record

        print(sam_header([(tn[j], int(tl[j])) for j in sorted(set(pj))]))
        for (i, j, st), (score, path) in zip(hits, aligned):
            print(sam_record(qn[i], tn[j], qrow(i, st), T[j], score, path,
                             args.alphabet, query_len=int(ql[i]),
                             flag=16 if st else 0))
        return
    if args.tsv:
        # BLAST outfmt-6 style: qname tname pident alnlen mismatches
        # gapopens qstart qend tstart tend, then the raw score (--stats
        # none) or evalue and bitscore; 1-based inclusive coordinates
        ka = None
        if args.stats != "none":
            from swtpu_torch.core.stats import bit_score, e_value, resolve_stats

            # calibrate at the search's own geometry (median lengths
            # rounded to 8 / 16), so the fit models this problem size
            mean_tl = float(np.mean(tl)) if len(tl) else 1.0
            m_cal = max(8, int(round(np.median(ql) / 8)) * 8)
            n_cal = max(16, int(round(np.median(tl) / 16)) * 16)
            ka = resolve_stats(params, args.alphabet, mode=args.stats,
                               calibrate_pairs=args.calibrate_pairs, seed=args.seed,
                               m=m_cal, n=n_cal, device=args.device)
            print(f"# karlin-altschul: lambda={ka.lam:.4f} K={ka.K:.4g} "
                  f"source={ka.source}", file=sys.stderr)
        for (i, j, strand), (score, path) in zip(hits, aligned):
            if len(path) < 2:
                continue
            st = cigar_stats(path_to_cigar(path, qrow(i, strand), T[j]))
            cols = st["aligned_columns"] + st["insertions"] + st["deletions"]
            pid = 100.0 * st["matches"] / cols if cols else 0.0
            if ka is not None:
                ev = float(e_value(score, int(ql[i]), mean_tl, ka, db_seqs=len(T)))
                if args.evalue_max is not None and ev > args.evalue_max:
                    continue
                tail = (f"{ev:.2g}", f"{float(bit_score(score, ka)):.1f}")
            else:
                tail = (int(score),)
            print("\t".join(str(x) for x in (
                qn[i], tn[j], f"{pid:.1f}", cols, st["mismatches"], _gap_runs(path),
                path[0][0] + 1, path[-1][0], path[0][1] + 1, path[-1][1],
            ) + tail + (("-" if strand else "+",) if args.both_strands else ())))
        return
    out = {i: [] for i in range(len(qn))}
    for (i, j, strand), (score, path) in zip(hits, aligned):
        hit = dict(target=tn[j], score=int(score))
        if args.both_strands:
            hit["strand"] = "-" if strand else "+"
        if args.traceback:
            hit["path"] = path
        if args.cigar:
            # the path was walked on the strand that hit
            hit["cigar"] = path_to_cigar(path, qrow(i, strand), T[j],
                                         query_len=int(ql[i]))
        out[i].append(hit)
    for i, name in enumerate(qn):
        print(json.dumps(dict(query=name, hits=out[i])))


def cmd_pack(args):
    """DNA FASTA <-> 2-bit packed .npz batch container."""
    import os

    from swtpu_torch.core.io import (
        decode_dna,
        load_fasta_batch,
        load_packed_batch,
        save_packed_batch,
        write_fasta,
    )

    if args.unpack:
        names, batch, lens = load_packed_batch(args.input)
        write_fasta(
            args.output,
            [(n, decode_dna(batch[i, : lens[i]])) for i, n in enumerate(names)],
        )
        print(json.dumps(dict(records=len(names), out=args.output)))
        return
    names, batch, lens = load_fasta_batch(args.input, "dna", pad_code=0)
    save_packed_batch(args.output, names, batch, lens)
    print(json.dumps(dict(
        records=len(names), packed_bytes=os.path.getsize(args.output),
        out=args.output,
    )))


def cmd_map(args):
    """Seed-and-extend read mapping: k-mer seeding (host), one batched
    extension of every candidate locus (device), the winners' paths with
    --traceback / --cigar / --sam."""
    from swtpu_torch.models.mapper import build_index, map_reads

    rng = np.random.default_rng(args.seed)
    if args.random:
        # GxRxL: random G-mer genome, R reads of length L sampled at
        # random loci and pushed through the mutation model
        from swtpu_torch.core.encode import mutate, revcomp

        G, R, L = (int(x) for x in args.random.split("x"))
        genome = rng.integers(0, 4, size=G).astype(np.uint8)
        starts = rng.integers(0, G - L, size=R)
        reads = np.stack([mutate(rng, genome[s: s + L], out_len=L) for s in starts])
        if args.both_strands:
            flip = rng.random(R) < 0.5
            for i in np.nonzero(flip)[0]:
                reads[i] = revcomp(reads[i])
        rnames = [f"read{i}" for i in range(R)]
        rlens = np.full(R, L)
        contigs, cnames, clens = [genome], ["genome"], [G]
    else:
        if not (args.reads and args.ref):
            raise SystemExit("need --reads and --ref FASTAs or --random")
        rnames, reads, rlens = _load_seq_batch(args.reads, "dna", pad_code=4)
        cnames, carr, clens = _load_seq_batch(args.ref, "dna", pad_code=5)
        contigs = [carr[i] for i in range(len(carr))]
    k = args.k if args.k is not None else (9 if args.random else 13)
    idx = build_index(contigs, cnames, k=k, lens=clens)
    hits = map_reads(
        reads, rlens, index=idx, min_seeds=args.min_seeds, max_occ=args.max_occ,
        max_loci=args.max_loci, match=args.match, mismatch=args.mismatch,
        gap=args.gap, gap_open=args.gap_open, gap_extend=args.gap_extend,
        bandwidth=args.bandwidth, x_threshold=args.x_drop, min_score=args.min_score,
        both_strands=args.both_strands,
        traceback=args.traceback or args.cigar or args.sam, device=args.device,
    )
    n_mapped = sum(h is not None for h in hits)
    if args.random:
        # reconstruction report: how many reads land on their true locus
        ok = sum(1 for i, h in enumerate(hits)
                 if h is not None and abs(h.pos - int(starts[i])) <= args.bandwidth)
        print(json.dumps(dict(reads=len(hits), mapped=n_mapped, correct_locus=ok)))
        return
    from swtpu_torch.core.encode import revcomp

    def contig_seq(h):
        cid = idx.contig_names.index(h.contig)
        cstart = int(idx.contig_starts[cid])
        return idx.ref[cstart: cstart + int(idx.contig_lens[cid])]

    if args.sam:
        from swtpu_torch.core.sam import sam_header, sam_record

        print(sam_header(list(zip(cnames, [int(x) for x in clens]))))
        for i, h in enumerate(hits):
            if h is None or not h.path:
                print(sam_record(rnames[i], "*", reads[i][: int(rlens[i])],
                                 reads[i][:0], 0, [], "dna", query_len=int(rlens[i])))
                continue
            q = revcomp(reads[i], int(rlens[i])) if h.strand == "-" else reads[i]
            print(sam_record(rnames[i], h.contig, q, contig_seq(h), h.score, h.path,
                             "dna", query_len=int(rlens[i]),
                             flag=16 if h.strand == "-" else 0))
        return
    for i, h in enumerate(hits):
        rec = dict(read=rnames[i])
        if h is None:
            rec["mapped"] = False
        else:
            rec.update(mapped=True, contig=h.contig, pos=h.pos, score=h.score,
                       strand=h.strand, n_seeds=h.n_seeds)
            if args.traceback and h.path:
                rec["path"] = [list(p) for p in h.path]
            if args.cigar and h.path:
                from swtpu_torch.core.cigar import path_to_cigar

                q = revcomp(reads[i], int(rlens[i])) if h.strand == "-" else reads[i]
                rec["cigar"] = path_to_cigar(h.path, q, contig_seq(h),
                                             query_len=int(rlens[i]))
        print(json.dumps(rec))


def cmd_assemble(args):
    """Greedy overlap-layout-consensus assembly: the contig as FASTA (or
    --out), with --sam every read placed on it."""
    from swtpu_torch.core.io import decode_dna, load_fasta_batch, write_fasta
    from swtpu_torch.models.assembly import assemble_greedy, make_reads

    rng = np.random.default_rng(args.seed)
    if args.random:
        # GxLxS: random G-mer genome tiled into L-mers every S bases
        G, L, S = (int(x) for x in args.random.split("x"))
        genome = rng.integers(0, 4, size=G).astype(np.uint8)
        reads = make_reads(rng, genome, read_len=L, step=S)
        names = [f"read{i}" for i in range(len(reads))]
    else:
        if not args.reads:
            raise SystemExit("need --reads FASTA or --random GxLxS")
        names, arr, lens = load_fasta_batch(args.reads, "dna", pad_code=4)
        reads = [arr[i][: lens[i]] for i in range(len(arr))]
    contig = assemble_greedy(reads, min_overlap=args.min_overlap, slack=args.slack,
                             device=args.device)
    summary = json.dumps(dict(contig_len=len(contig), reads=len(reads)))
    if args.out:
        write_fasta(args.out, [("contig", decode_dna(contig))])
    elif not args.sam:
        print(summary)
        print(">contig")
        print(decode_dna(contig))
    else:
        # --sam keeps stdout pure SAM; the summary goes to stderr
        print(summary, file=sys.stderr)
    if args.random:
        # demo mode: whether the assembly reproduced the genome
        ok = len(contig) == len(genome) and bool(np.array_equal(contig, genome))
        print(json.dumps(dict(genome_len=len(genome), reconstructed=ok)),
              file=sys.stderr)
    if args.sam:
        # read placements: local-align every read back to the contig
        from swtpu_torch.batch import sw_align_batch
        from swtpu_torch.core.sam import sam_header, sam_record

        L = max(len(r) for r in reads)
        qs = np.stack([np.concatenate([r, np.full(L - len(r), 4, np.uint8)])
                       for r in reads])
        ts = np.ascontiguousarray(np.broadcast_to(contig[None, :],
                                                  (len(reads), len(contig))))
        print(sam_header([("contig", len(contig))]))
        for k, (score, path) in enumerate(
                sw_align_batch(qs, ts, _scoring(args), device=args.device)):
            print(sam_record(names[k], "contig", qs[k], contig, score, path, "dna",
                             query_len=len(reads[k])))


def cmd_msa(args):
    """Center-star multiple sequence alignment (models/msa.py): gapped
    FASTA on stdout, a JSON summary on stderr."""
    from swtpu_torch.core.io import read_fasta
    from swtpu_torch.models.msa import msa_center_star, msa_rows_to_strings

    if args.random:
        # NxL: N mutation-model descendants of one random L-mer ancestor
        from swtpu_torch.core.encode import mutate

        N, L = (int(x) for x in args.random.split("x"))
        rng = np.random.default_rng(args.seed)
        hi = 4 if args.alphabet == "dna" else 20
        ancestor = rng.integers(0, hi, size=L).astype(np.uint8)
        seqs = [mutate(rng, ancestor) for _ in range(N)]
        names = [f"seq{i}" for i in range(N)]
    else:
        if not args.queries:
            raise SystemExit("need --queries FASTA or --random NxL")
        if args.alphabet == "protein":
            from swtpu_torch.core.protein import encode_protein as enc
        else:
            from swtpu_torch.core.io import encode_dna as enc
        names, seqs = [], []
        for name, s in read_fasta(args.queries):
            names.append(name)
            seqs.append(enc(s))
    if len(seqs) < 2:
        raise SystemExit("msa needs >= 2 sequences")
    center = None
    if args.center is not None:
        if args.center not in names:
            raise SystemExit(f"--center {args.center!r} not in inputs")
        center = names.index(args.center)
    res = msa_center_star(seqs, params=_scoring(args), center=center,
                          device=args.device)
    print(json.dumps(dict(n=len(seqs), width=len(res.rows[0]),
                          center=names[res.center], sp_score=res.sp)),
          file=sys.stderr)
    for name, row in zip(names, msa_rows_to_strings(res.rows, args.alphabet)):
        print(f">{name}")
        print(row)


def cmd_selftest(args):
    """End-to-end differential checks (oracle vs every engine tier that
    runs on the device; swtpu_torch/selftest.py). One JSON line per
    check; exits 1 if any fails."""
    from swtpu_torch.selftest import run_selftest

    ok_all = True
    for name, ok in run_selftest(args.device):
        ok_all &= ok
        print(json.dumps(dict(selftest=name, ok=ok)))
    if not ok_all:
        raise SystemExit(1)


def cmd_fuzz(args):
    """Soak-scale randomized differential testing (swtpu_torch.fuzz): the
    CUDA kernels beside the plain tiers on the card, the plain tiers
    alone with --device cpu."""
    from swtpu_torch.fuzz import run_fuzz

    families = args.families.split(",") if args.families else None
    run_fuzz(
        minutes=args.minutes, seed=args.seed, pairs_per_round=args.pairs,
        families=families, save_dir=args.save_dir, max_rounds=args.rounds,
        device=args.device,
    )


def cmd_bench(args):
    """The benchmark suite (swtpu_torch/bench_suite.py): the arguments
    after ``bench`` go to ``bench_suite.main`` as they are."""
    bench_suite.main(args.bench_argv)


def build_parser():
    ap = argparse.ArgumentParser(prog="swtpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_option(p):
        p.add_argument(
            "--device", choices=["cuda", "cpu"], default="cuda",
            help="where the engines run (default cuda; no CPU fallback)",
        )

    def common(p):
        p.add_argument("--queries", help="FASTA of query sequences")
        p.add_argument("--targets", help="FASTA of target sequences")
        p.add_argument(
            "--random", help="BxNxM: generate B random pairs of lengths N, M"
        )
        p.add_argument("--seed", type=int, default=10000)
        p.add_argument(
            "--alphabet", choices=["dna", "protein"], default="dna",
            help="dna (--scoring match,mismatch) or protein (BLOSUM62)",
        )
        p.add_argument("--scoring", default="1,-1", help="match,mismatch")
        p.add_argument("--gap", type=int, default=1)
        p.add_argument("--gap-open", type=int, default=None)
        p.add_argument("--gap-extend", type=int, default=1)
        p.add_argument("--traceback", action="store_true")
        p.add_argument(
            "--cigar",
            action="store_true",
            help="emit a SAM-style extended CIGAR (=/X/I/D, soft clips "
            "for local alignments) derived from the traceback path",
        )
        p.add_argument(
            "--sam",
            action="store_true",
            help="emit full SAM 1.6 records (header + one line per pair, "
            "AS/NM tags) instead of JSON; implies traceback",
        )
        device_option(p)

    p = sub.add_parser("align", help="local (Smith-Waterman) alignment")
    common(p)
    p.add_argument(
        "--engine", default="xla_diag",
        help="score engine for linear scoring (oracle|xla_diag|wavefront|"
        "colscan|rowscan|rowscan_prof|rowscan_bf16); on the card the plain "
        "tiers' names (xla_diag, colscan), a name whose guard fails and an "
        "unknown name run best_engine",
    )
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("semiglobal", help="semi-global alignment")
    common(p)
    p.set_defaults(fn=cmd_semiglobal)

    p = sub.add_parser(
        "global",
        help="global (Needleman-Wunsch) alignment — the semi-global "
        "forward pass with the endpoint pinned at each pair's corner",
    )
    common(p)
    p.set_defaults(fn=lambda args: cmd_semiglobal(args, pin_end=True))

    p = sub.add_parser("banded", help="adaptive-banded X-drop semi-global")
    common(p)
    p.add_argument("--bandwidth", type=int, default=32)
    p.add_argument("--x-drop", type=int, default=70)
    p.add_argument(
        "--fixed",
        action="store_true",
        help="fixed diagonal corridor |i-j| <= bandwidth (local SW, "
        "score-only, issue-bound engine)",
    )
    p.add_argument(
        "--block-adaptive",
        action="store_true",
        help="the block-adaptive tier: a corridor of 2 x bandwidth slots "
        "recentred every bandwidth rows (scores and endpoints; paths with "
        "--traceback/--cigar, linear gaps)",
    )
    p.set_defaults(fn=cmd_banded)

    p = sub.add_parser(
        "longpair", help="one long pair on one card, tile by tile"
    )
    common(p)
    p.add_argument(
        "--block", type=int, default=None,
        help="column-block width (default: auto — one block of the whole "
        "target, the step-count-optimal block on one device)",
    )
    p.add_argument(
        "--devices", type=int, default=None,
        help="mesh size (default: the world's size; one process a device, "
        "started by torchrun --nproc-per-node N)",
    )
    p.add_argument(
        "--backend", choices=["nccl", "gloo"], default=None,
        help="the world's backend (default: nccl on the card, gloo on the CPU; "
        "ranks sharing one card need gloo)",
    )
    p.set_defaults(fn=cmd_longpair)

    p = sub.add_parser("search", help="all-vs-all top-k database search")
    common(p)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--checkpoint", help="resume cursor .npz path")
    p.add_argument("--verbose", action="store_true",
                   help="a JSON record a chunk on stderr")
    p.add_argument(
        "--tsv", action="store_true",
        help="BLAST outfmt-6-style tabular hits (qname tname pident alnlen "
        "mismatches gapopens qstart qend tstart tend score), computed from a "
        "batched traceback of every hit",
    )
    p.add_argument(
        "--both-strands", action="store_true",
        help="DNA only: also search the reverse complement of every query; "
        "hits carry a strand (+/-; SAM FLAG 16), merged deterministically "
        "(score desc, id asc, '+' first)",
    )
    p.add_argument(
        "--stats", choices=["none", "auto", "preset", "calibrate"], default="none",
        help="Karlin-Altschul significance: --tsv emits evalue and bitscore "
        "(full outfmt 6). preset = NCBI's BLOSUM62 11/1 parameters; calibrate "
        "= fit (lambda, K) for the scoring in use by aligning random "
        "background pairs on the device's engine; auto = preset when "
        "tabulated, else calibrate",
    )
    p.add_argument("--calibrate-pairs", type=int, default=8192,
                   help="random pairs scored by --stats calibrate (default 8192)")
    p.add_argument("--evalue-max", type=float, default=None,
                   help="with --stats: drop hits whose E-value exceeds this")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser(
        "map",
        help="seed-and-extend read mapping: k-mer seeds + one batched banded "
        "extension of every candidate locus on the device",
    )
    p.add_argument("--reads", help="FASTA of reads (DNA)")
    p.add_argument("--ref", help="FASTA of reference contigs")
    p.add_argument(
        "--random", metavar="GxRxL",
        help="demo: random G-mer genome, R mutation-model reads of length L; "
        "reports how many map back to their true locus",
    )
    p.add_argument("--seed", type=int, default=10000)
    p.add_argument(
        "--k", type=int, default=None,
        help="seed k-mer size (default 13; 9 for the --random demo, whose "
        "mutation-model reads are only ~70%% identity)",
    )
    p.add_argument("--min-seeds", type=int, default=2)
    p.add_argument("--max-occ", type=int, default=64,
                   help="ignore k-mers occurring more often than this (repeats)")
    p.add_argument("--max-loci", type=int, default=8)
    p.add_argument("--match", type=int, default=1)
    p.add_argument("--mismatch", type=int, default=1, help="penalty (positive)")
    p.add_argument("--gap", type=int, default=1, help="penalty (positive)")
    p.add_argument("--gap-open", type=int, default=None)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--bandwidth", type=int, default=32)
    p.add_argument("--x-drop", type=int, default=70)
    p.add_argument("--min-score", type=int, default=20)
    p.add_argument("--both-strands", action="store_true")
    p.add_argument("--traceback", action="store_true")
    p.add_argument("--cigar", action="store_true")
    p.add_argument("--sam", action="store_true")
    device_option(p)
    p.set_defaults(fn=cmd_map)

    p = sub.add_parser(
        "assemble",
        help="greedy overlap-layout-consensus assembly",
    )
    p.add_argument("--reads", help="FASTA of reads")
    p.add_argument(
        "--random", metavar="GxLxS",
        help="demo: random G-mer genome tiled into L-mer reads every S bases "
        "(reports whether the contig reconstructs the genome)",
    )
    p.add_argument("--seed", type=int, default=10000)
    p.add_argument("--min-overlap", type=int, default=20)
    p.add_argument(
        "--slack", type=int, default=0,
        help="error tolerance: overlap endpoints may miss the read ends by up "
        "to this many bases and the consensus majority-votes substitution "
        "errors out (0 = exact suffix-prefix splice)",
    )
    p.add_argument("--out", help="write the contig FASTA here")
    p.add_argument("--sam", action="store_true",
                   help="also emit SAM placements of every read on the contig")
    p.add_argument("--scoring", default="1,-1", help="match,mismatch for --sam")
    p.add_argument("--gap", type=int, default=1)
    p.add_argument("--gap-open", type=int, default=None)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--alphabet", choices=["dna"], default="dna",
                   help=argparse.SUPPRESS)
    device_option(p)
    p.set_defaults(fn=cmd_assemble)

    p = sub.add_parser(
        "msa",
        help="center-star multiple sequence alignment on the batched NW "
        "kernels (gapped FASTA to stdout)",
    )
    p.add_argument("--queries", help="FASTA of sequences to align")
    p.add_argument("--random", metavar="NxL",
                   help="demo: N mutation-model descendants of one random L-mer")
    p.add_argument("--seed", type=int, default=10000)
    p.add_argument("--alphabet", choices=["dna", "protein"], default="dna")
    p.add_argument("--scoring", default="1,-1",
                   help="match,mismatch (DNA; protein uses BLOSUM62)")
    p.add_argument("--gap", type=int, default=1)
    p.add_argument("--gap-open", type=int, default=None)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--center", help="star around this named sequence instead "
                   "of the max-total-similarity pick")
    device_option(p)
    p.set_defaults(fn=cmd_msa)

    p = sub.add_parser(
        "pack",
        help="convert DNA FASTA to/from the 2-bit packed .npz container "
        "(align accepts .npz inputs directly)",
    )
    p.add_argument("input", help="FASTA (or .npz with --unpack)")
    p.add_argument("output", help=".npz out (or FASTA with --unpack)")
    p.add_argument(
        "--unpack", action="store_true", help=".npz -> FASTA instead"
    )
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("bench", help="benchmark suite")
    bench_suite.add_arguments(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("selftest", help="quick differential self-check")
    device_option(p)
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser(
        "fuzz",
        help="soak-scale randomized differential testing (the reference's "
        "10M-iteration harness pattern, time-bounded)",
    )
    p.add_argument("--minutes", type=float, default=1.0)
    p.add_argument("--rounds", type=int, default=None,
                   help="stop after N rounds (default: time-bounded only)")
    p.add_argument("--seed", type=int, default=10000)
    p.add_argument("--pairs", type=int, default=512,
                   help="pairs per round")
    p.add_argument("--families", default=None,
                   help="comma list: uniform,tie_rich,general4,affine,"
                   "protein,semiglobal,banded,fixed_band,search,cigar,banded_block")
    p.add_argument("--save-dir", default="fuzz_failures",
                   help="where to write .npz repros on mismatch")
    device_option(p)
    p.set_defaults(fn=cmd_fuzz)
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args.bench_argv = argv[1:]  # what follows ``bench`` (no option precedes it)
    args.fn(args)


if __name__ == "__main__":
    main()
