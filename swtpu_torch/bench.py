"""Headline benchmark on the card: batched 128x128 DNA Smith-Waterman at
scoring (10, -30, 15).

Port of the repo's ``bench.py``: the reference's SpeedTest workload
(random 128-mers, one alignment = 128 * 128 = 16384 DP cells), timed with
CUDA events (``utils.timing.time_kernel``) through ``best_engine`` on the
card. Refuses to run without a card.

    python -m swtpu_torch.bench [--batch 32768] [--iters 20] [--verbose]

Prints ONE JSON line:
  {"metric": "sw_batch_128x128_gcups_cuda", "value": N, "unit": "GCUPS",
   "vs_baseline": N}
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

BASELINE_GCUPS = 8.70  # reference simd9 on a Ryzen 3700X CPU (BASELINE.md)


def make_inputs(batch, n, m, seed=10000):
    rng = np.random.default_rng(seed)
    qs = rng.integers(0, 4, size=(batch, n)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(batch, m)).astype(np.uint8)
    return qs, ts


def main(argv=None):
    ap = argparse.ArgumentParser(prog="swtpu_torch.bench")
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("swtpu_torch.bench needs a CUDA device")

    from swtpu_torch.core.scoring import DNA_10_30_15
    from swtpu_torch.ops import best_engine
    from swtpu_torch.utils import time_kernel

    fn = best_engine(DNA_10_30_15, "cuda")
    qs_h, ts_h = make_inputs(args.batch, args.n, args.m)
    qs = torch.from_numpy(qs_h).cuda()
    ts = torch.from_numpy(ts_h).cuda()
    sec = time_kernel(fn, (qs, ts), iters=args.iters)
    cells = args.batch * args.n * args.m
    gcups = cells / sec / 1e9
    if args.verbose:
        print(
            f"# device={torch.cuda.get_device_name(0)} batch={args.batch} "
            f"ms={sec * 1e3:.3f} ms/1M={1e6 / args.batch * sec * 1e3:.1f}"
        )
    print(
        json.dumps(
            {
                "metric": f"sw_batch_{args.n}x{args.m}_gcups_cuda",
                "value": gcups,
                "unit": "GCUPS",
                "vs_baseline": gcups / BASELINE_GCUPS,
            }
        )
    )


if __name__ == "__main__":
    main()
