"""Time ``all_vs_all_topk``'s modes against each other on the card.

Run from the root of a checkout (``env PYTHONPATH=. python3 <this
script>``). At BASELINE config 5's one-card scale (``chip_smoke.py``
phase 34's draws: 16 queries x 131,072 random 128-mers, seed 10000, k =
10, chunks of 8192; DNA (1,-1,1) and protein BLOSUM62 11/1 from the
background model) it times the wall of each mode: streaming raw,
streaming packed (DNA), resident, and each of the two with
``max_retries=0`` (no host sync until the end; resident so is the fused
sweep). Rep 0 warms up; each later rep draws a fresh query set and runs
every mode once, the order rotated a rep, and every mode's hits must
equal streaming raw's. One JSON line per (scoring, mode) with the walls,
their minimum and median; the first line is the card's name and power
limit.

    env PYTHONPATH=. python3 tools/search_times.py --reps 9
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_111, ScoringParams
from swtpu_torch.core.stats import background_freqs
from swtpu_torch.parallel.search import all_vs_all_topk

SEED = 10000
NQ, NS, L, K, CH = 16, 131072, 128, 10, 8192
MODES = {
    "streaming raw": dict(packed=False, resident=False),
    "streaming packed": dict(packed=True, resident=False),
    "resident": dict(packed=False, resident=True),
    "streaming raw, no sync": dict(packed=False, resident=False, max_retries=0),
    "fused sweep (resident, no sync)": dict(packed=False, resident=True, max_retries=0),
}


def draws(letters, rng, rows, freqs):
    if letters == 4:
        return rng.integers(0, 4, size=(rows, L)).astype(np.uint8)
    return rng.choice(20, size=(rows, L), p=freqs).astype(np.uint8)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=9, help="timed reps after the warm-up")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    pfreq = background_freqs("protein")
    srng = np.random.default_rng(SEED)  # phase 34's order: queries, a chunk, the DB
    sets = {}
    for label, p, letters in (("DNA (1,-1,1)", DNA_111, 4),
                              ("protein BLOSUM62 11/1",
                               ScoringParams(BLOSUM62, gap_open=11, gap_extend=1), 20)):
        draws(letters, srng, NQ, pfreq), draws(letters, srng, 2048, pfreq)
        sets[label] = (p, letters, draws(letters, srng, NS, pfreq))
    for label, (p, letters, db) in sets.items():
        modes = {m: kw for m, kw in MODES.items() if letters == 4 or not kw["packed"]}
        walls = {m: [] for m in modes}
        names = list(modes)
        for rep in range(args.reps + 1):
            qs = draws(letters, np.random.default_rng(777 + rep), NQ, pfreq)
            want = None
            for j in range(len(names)):
                m = names[(j + rep) % len(names)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = all_vs_all_topk(qs, db, p, k=K, chunk_size=CH, **modes[m])
                wall = time.perf_counter() - t0
                want = want or got
                if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
                    raise SystemExit(f"{label} {m}: hits differ from the other modes'")
                if rep:
                    walls[m].append(wall * 1e3)
        for m, w in walls.items():
            print(json.dumps(dict(scoring=label, mode=m, min_ms=min(w),
                                  median_ms=float(np.median(w)), walls_ms=w)), flush=True)


if __name__ == "__main__":
    main()
