"""Time the bf16 tier and the four fixed-band kernel forms on the card.

Run from the root of a checkout (``env PYTHONPATH=. python3
<this script> --label new``): it builds that checkout's
``csrc/sw_bf16.cu`` and ``csrc/sw_banded.cu`` and times, per form and
shape, the wrapper's call and the launch alone (CUDA events, best of 3)
on random codes from a fixed seed, at the shapes ``chip_smoke.py`` times:

- bf16 (10, -30, 15) at 32,768 and 1,048,576 pairs of 128 x 128 (phases
  16 and 14), and (1, -1, 1) with ``allow_overflow`` on 32,768 pairs of
  300 x 320, one in eight homologous (config 4's bf16 pass, phase 12);
- the fixed band at W = 32: (1, -1, 1), Gotoh (1, -1, 3, 1) on DNA and
  BLOSUM62 11 / 11/1 on protein at 32,768 and 1,048,576 pairs of 128 x
  128 (phases 16 and 22), and the two DNA forms on 2048 related
  2048-mers (phase 22).

One JSON line per (form, shape); the first line is the card's name and
power limit. ``--lb`` times a checkout from before the kernels read [B,
L] codes (its launches take the [L, B] transposes): the codes are
transposed before the clock starts, so both checkouts' launches are timed
on the same inputs. On a machine with the card:

    (cd <earlier checkout> && env PYTHONPATH=. python3 \\
        <repo>/tools/bf16_banded_times.py --label earlier --lb)
    env PYTHONPATH=. python3 tools/bf16_banded_times.py --label new
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from swtpu_torch.core.encode import mutate
from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import ScoringParams, dna_matrix
from swtpu_torch.kernels import sw_banded as ksb
from swtpu_torch.kernels import sw_bf16 as kbf
from swtpu_torch.utils import time_kernel

SEED = 10012
W = 32
BANDED = {
    "sw_banded_static": ScoringParams.linear(dna_matrix(1, -1), 1),
    "sw_banded_static_affine": ScoringParams(dna_matrix(1, -1), 3, 1),
    "sw_banded_profile": ScoringParams.linear(BLOSUM62, 11),
    "sw_banded_profile_affine": ScoringParams(BLOSUM62, 11, 1),
}


def related(rng, B, L, homologous):
    """B random DNA pairs of L x L, the first ``homologous`` of them the
    query with 2% substitutions."""
    q = rng.integers(0, 4, (B, L), dtype=np.uint8)
    t = rng.integers(0, 4, (B, L), dtype=np.uint8)
    for b in range(homologous):
        t[b] = mutate(rng, q[b], p_mismatch=0.02, p_insert=0, p_delete=0)
    return q, t


def emit(label, form, shape, alone, wrapped):
    B, n, m = shape
    print(json.dumps({"label": label, "form": form, "pairs": B, "n": n, "m": m,
                      "alone_ms": alone * 1e3, "wrapper_ms": wrapped * 1e3}), flush=True)


def time_pair(label, form, shape, launch, wrapper, q, t, lb):
    """Hold the launch against the wrapper once, then time both."""
    qa, ta = (q.t().contiguous(), t.t().contiguous()) if lb else (q, t)
    if not torch.equal(launch(qa, ta), wrapper(q, t)):
        raise RuntimeError(f"{form}: launch alone differs from the wrapper")
    it = 20 if shape[0] <= 65536 else 5
    emit(label, form, shape, time_kernel(launch, (qa, ta), iters=it),
         time_kernel(wrapper, (q, t), iters=it))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="the checkout's name in the output")
    ap.add_argument("--lb", action="store_true",
                    help="the checkout's launches take [L, B] codes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip()}), flush=True)
    rng = np.random.default_rng(SEED)

    def cuda(*xs):
        return [torch.from_numpy(x).to(dev) for x in xs]

    p = ScoringParams.linear(dna_matrix(10, -30), 15)
    for B in (32768, 1 << 20):
        q, t = cuda(*(rng.integers(0, 4, (B, 128), dtype=np.uint8) for _ in range(2)))
        time_pair(args.label, "sw_bf16", (B, 128, 128),
                  lambda a, b: kbf.bf16_launch_t(a, b, p),
                  lambda a, b: kbf.sw_bf16(a, b, p), q, t, args.lb)
        del q, t
    p111 = ScoringParams.linear(dna_matrix(1, -1), 1)
    q, t = cuda(*related(rng, 32768, 320, 4096))
    q = q[:, :300].contiguous()
    time_pair(args.label, "sw_bf16 allow_overflow", (32768, 300, 320),
              lambda a, b: kbf.bf16_launch_t(a, b, p111, allow_overflow=True),
              lambda a, b: kbf.sw_bf16(a, b, p111, allow_overflow=True), q, t, args.lb)
    del q, t

    for B in (32768, 1 << 20):
        codes = {A: cuda(*(rng.integers(0, A, (B, 128), dtype=np.uint8) for _ in range(2)))
                 for A in (4, 20)}
        for name, sc in BANDED.items():
            profile = name.startswith("sw_banded_profile")
            table = ksb.banded_table(sc.matrix, dev) if profile else None
            wrapper = ksb.sw_banded_profile if profile else ksb.sw_banded_static
            q, t = codes[20 if profile else 4]
            time_pair(args.label, name, (B, 128, 128),
                      lambda a, b, sc=sc, table=table: ksb.banded_launch_t(a, b, sc, W, table),
                      lambda a, b, sc=sc, wrapper=wrapper: wrapper(a, b, sc, W), q, t, args.lb)
        del codes, q, t
        torch.cuda.empty_cache()
    q, t = cuda(*related(rng, 2048, 2048, 2048))
    for name in ("sw_banded_static", "sw_banded_static_affine"):
        sc = BANDED[name]
        time_pair(args.label, name, (2048, 2048, 2048),
                  lambda a, b, sc=sc: ksb.banded_launch_t(a, b, sc, W),
                  lambda a, b, sc=sc: ksb.sw_banded_static(a, b, sc, W), q, t, args.lb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
