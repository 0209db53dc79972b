"""Time the strip tile's kernel alone (``longpair_strip.strip_launch_t``,
B13) on ``chip_smoke.py`` phase 30's tiles on the card: a related 4096 x
4096 linear (1,-1,1) tile, and the related 16384 x 16384 pair linear and
Gotoh (2,-3,5,1), zero boundaries. Three readings each (CUDA events, best
of 3 reps of 5 calls), one JSON line, labelled by the first argument.

Run from the root of a checkout; to compare two checkouts, run it from
each in one call, in turns (parent, new, new, parent):

    env PYTHONPATH=. python3 tools/strip_times.py new
"""

import json
import sys

import numpy as np
import torch

from swtpu_torch.core.encode import mutate
from swtpu_torch.core.scoring import DNA_111, ScoringParams, dna_matrix
from swtpu_torch.kernels import longpair_strip as kls
from swtpu_torch.kernels import sw_profile as kp
from swtpu_torch.utils import time_kernel


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else "new"
    if not torch.cuda.is_available():
        print("strip_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(10000)
    L = 16384
    lq = rng.integers(0, 4, L).astype(np.uint8)
    lt = mutate(rng, lq, p_mismatch=0.1, p_insert=0.025, p_delete=0.025, out_len=L)
    q4 = rng.integers(0, 4, 4096).astype(np.uint8)
    t4 = mutate(rng, q4, p_mismatch=0.1, p_insert=0.025, p_delete=0.025)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {"label": label}
    for name, (q, t), p in (("4096 linear", (q4, t4), DNA_111),
                            ("16K linear", (lq, lt), DNA_111),
                            ("16K gotoh", (lq, lt), ScoringParams(dna_matrix(2, -3), 5, 1))):
        R, C = len(q), len(t)
        aff = not p.is_linear
        sargs = (kls.stage_codes(q, p, dev), kls.stage_codes(t, p, dev),
                 kp.profile_table(p, dev), torch.zeros(C, **i32),
                 torch.full((C,), -(2**20), **i32) if aff else None,
                 torch.zeros(R + 1, **i32),
                 torch.full((R + 1,), -(2**20), **i32) if aff else None, p)
        kls.strip_launch_t(*sargs)
        torch.cuda.synchronize()
        ms = [time_kernel(kls.strip_launch_t, sargs, iters=5, warmup=1, reps=3) * 1e3
              for _ in range(3)]
        out[name] = [round(x, 4) for x in ms]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
