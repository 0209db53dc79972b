"""Wall of one ``longpair_sw_ends`` call on the 16384 x 16384 pair of
``chip_smoke.py`` phase 30 (seed 10000, ~85% identity), linear (1,-1,1)
and Gotoh (2,-3,5,1), on the card: the min and median of ``--reps``
host walls (CUDA-synchronised), after a warm-up call.

Run from the root of a checkout (to compare two checkouts, run it from
each in one call, in turns):

    env PYTHONPATH=. python3 tools/longpair_times.py --label new --reps 30
"""

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from swtpu_torch.core.encode import mutate
from swtpu_torch.core.scoring import DNA_111, ScoringParams, dna_matrix
from swtpu_torch.parallel.longpair import longpair_sw_ends


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="new")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("longpair_times: no CUDA device")
    rng = np.random.default_rng(10000)
    L = 16384
    q = rng.integers(0, 4, L).astype(np.uint8)
    t = mutate(rng, q, p_mismatch=0.1, p_insert=0.025, p_delete=0.025, out_len=L)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    out = dict(label=args.label, card=smi)
    for label, p in (("linear (1,-1,1)", DNA_111),
                     ("Gotoh (2,-3,5,1)", ScoringParams(dna_matrix(2, -3), 5, 1))):
        ends = longpair_sw_ends(q, t, p)  # warm: the build and the first launch
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = longpair_sw_ends(q, t, p)
            walls.append((time.perf_counter() - t0) * 1e3)
            if again != ends:
                raise SystemExit(f"longpair_times: {label} gave {again}, then {ends}")
        out[label] = dict(ends=ends, min_ms=min(walls), median_ms=statistics.median(walls))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
