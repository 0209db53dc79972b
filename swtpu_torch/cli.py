"""swtpu_torch command-line interface: the ``align`` subcommand.

Port of ``swtpu/cli.py``'s ``align`` (local Smith-Waterman alignment of
query/target pairs). Output is the same JSON lines (or SAM) as
``python -m swtpu align`` prints for the same arguments.

Usage:
  python -m swtpu_torch align --random 1024x128x128 --scoring 10,-30 --gap 15
  python -m swtpu_torch align --queries q.fa --targets t.fa --cigar
  python -m swtpu_torch align --random 8x64x64 --gap-open 40 --gap-extend 15 --sam
  python -m swtpu_torch align --random 8x64x64 --device cpu

``--device`` defaults to ``cuda``: without a card the command fails
rather than run on the CPU. DNA only; protein input and the 2-bit
``.npz`` container are later slices.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

Q_PAD, T_PAD = 4, 5  # DNA pad codes (first codes past the 0..3 alphabet)


def _load_pair_inputs(args):
    if args.alphabet != "dna":
        raise SystemExit(
            "protein input is not ported to swtpu_torch yet (ROADMAP.md); "
            "use python -m swtpu"
        )
    if args.random:
        b, n, m = (int(x) for x in args.random.split("x"))
        rng = np.random.default_rng(args.seed)
        qs = rng.integers(0, 4, size=(b, n)).astype(np.uint8)
        ts = rng.integers(0, 4, size=(b, m)).astype(np.uint8)
        names = [f"pair{i}" for i in range(b)]
        return names, qs, ts, np.full(b, n), np.full(b, m)
    if not (args.queries and args.targets):
        raise SystemExit("need --random BxNxM or --queries/--targets FASTA")
    for path in (args.queries, args.targets):
        if path.endswith(".npz"):
            raise SystemExit(
                "2-bit packed .npz input is not ported to swtpu_torch yet "
                "(ROADMAP.md); pass FASTA"
            )
    from swtpu_torch.core.io import load_fasta_batch

    qn, qs, ql = load_fasta_batch(args.queries, pad_code=Q_PAD)
    tn, ts, tl = load_fasta_batch(args.targets, pad_code=T_PAD)
    if len(qs) != len(ts):
        raise SystemExit(
            f"pairwise mode needs equal counts, got {len(qs)} vs {len(ts)}"
        )
    return [f"{a}|{b}" for a, b in zip(qn, tn)], qs, ts, ql, tl


def _scoring(args):
    from swtpu_torch.core.scoring import ScoringParams, dna_matrix

    match, mismatch = (int(x) for x in args.scoring.split(","))
    mat = dna_matrix(match, mismatch)
    if args.gap_open is not None:
        return ScoringParams(
            mat, gap_open=args.gap_open, gap_extend=args.gap_extend
        )
    return ScoringParams.linear(mat, args.gap)


def _emit_sam(names, qs, ts, ql, tl, results):
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
                qn[k], tn[k], qs[k], ts[k], score, path,
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
            _emit_sam(names, qs, ts, ql, tl, results)
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
    from swtpu_torch.ops import best_engine

    scores = best_engine(params, args.device)(qs, ts).cpu().numpy()
    for name, s in zip(names, scores):
        print(json.dumps(dict(pair=name, score=int(s))))


def build_parser():
    ap = argparse.ArgumentParser(prog="swtpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("align", help="local (Smith-Waterman) alignment")
    p.add_argument("--queries", help="FASTA of query sequences")
    p.add_argument("--targets", help="FASTA of target sequences")
    p.add_argument(
        "--random", help="BxNxM: generate B random pairs of lengths N, M"
    )
    p.add_argument("--seed", type=int, default=10000)
    p.add_argument(
        "--alphabet", choices=["dna", "protein"], default="dna",
        help="dna (protein is not ported yet and is rejected)",
    )
    p.add_argument("--scoring", default="1,-1", help="match,mismatch")
    p.add_argument("--gap", type=int, default=1)
    p.add_argument("--gap-open", type=int, default=None)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--traceback", action="store_true")
    p.add_argument(
        "--cigar",
        action="store_true",
        help="emit a SAM-style extended CIGAR (=/X/I/D, soft clips) "
        "derived from the traceback path",
    )
    p.add_argument(
        "--sam",
        action="store_true",
        help="emit full SAM 1.6 records (header + one line per pair, "
        "AS/NM tags) instead of JSON; implies traceback",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the engines run (default cuda; no CPU fallback)",
    )
    p.set_defaults(fn=cmd_align)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
