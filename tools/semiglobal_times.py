"""Time the eight semi-global / global kernel forms on the card.

Run from the root of a checkout (``env PYTHONPATH=. python3
<this script> --label new``): it builds that checkout's
``csrc/sw_semiglobal.cu`` and times, per form, the wrapper's call and the
launch alone, CUDA events, best of 3, at 32,768 and 1,048,576 pairs of
128 x 128 (random codes from a fixed seed: DNA for the uniform forms,
protein for the profile forms, as ``chip_smoke.py`` phases 16-18). One
JSON line per (form, shape); the first line is the card's name and power
limit. ``--lb`` times a checkout from before the kernel read [B, L]
codes (the parent of that change, whose launch takes the row-scan's
[L, B]): the codes are transposed before the clock starts, so both
checkouts' launches are timed on the same inputs. On a machine with the
card:

    (cd <earlier checkout> && env PYTHONPATH=. python3 \\
        <repo>/tools/semiglobal_times.py --label earlier --lb)
    env PYTHONPATH=. python3 tools/semiglobal_times.py --label new
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels import semiglobal_batch as ksg
from swtpu_torch.kernels import semiglobal_profile as ksp
from swtpu_torch.kernels import sw_profile as kp
from swtpu_torch.utils import time_kernel

SEED = 10011
L = 128
UNIFORM = {"linear": dict(match=1, mismatch=1, gap=1),
           "affine": dict(match=2, mismatch=3, gap_open=5, gap_extend=1)}
PROFILE = {"linear": ScoringParams.linear(BLOSUM62, 11),
           "affine": ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)}


def forms():
    """(name as chip_smoke.py's KERNELS, scoring, pinned)."""
    for kind, table in (("batch", UNIFORM), ("profile", PROFILE)):
        for gaps in ("linear", "affine"):
            for pin in (False, True):
                name = f"semiglobal_{kind}" + ("_affine" if gaps == "affine" else "") + (
                    "_pinned" if pin else "")
                yield name, table[gaps], pin


def launch_and_wrapper(sc, pin, dev, lb):
    """The launch's arguments and the wrapper for one form."""
    if isinstance(sc, dict):
        go, ge, affine = ksg.gaps(**{k: v for k, v in sc.items() if k.startswith("gap")})
        return ((sc["match"], -sc["mismatch"], go, ge, affine, pin), {},
                lambda a, b: ksg.semiglobal_batch(a, b, **sc, pin_end=pin))
    kw = dict(table=kp.profile_table(sc, dev))
    if not lb:
        kw["n_codes"] = sc.alphabet_size + 1
    # the largest |entry| bounds the packed key (a checkout from before the
    # kernel took it reads 0 there and ignores it)
    return ((int(abs(sc.matrix).max()), 0, sc.gap_open, sc.gap_extend, not sc.is_linear,
             pin), kw,
            lambda a, b: ksp.semiglobal_profile(a, b, sc, pin_end=pin))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="the checkout's name in the output")
    ap.add_argument("--lb", action="store_true",
                    help="the checkout's launch takes [L, B] codes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip()}), flush=True)
    rng = np.random.default_rng(SEED)
    for B in (32768, 1 << 20):
        codes = {letters: [torch.from_numpy(rng.integers(0, letters, (B, L), dtype=np.uint8)
                                            ).to(dev) for _ in range(2)]
                 for letters in (4, 20)}
        for name, sc, pin in forms():
            q, t = codes[4 if isinstance(sc, dict) else 20]
            launch_args, kw, wrapper = launch_and_wrapper(sc, pin, dev, args.lb)
            qa, ta = (q.t().contiguous(), t.t().contiguous()) if args.lb else (q, t)
            for g, w in zip(ksg.semiglobal_launch_t(qa, ta, *launch_args, **kw),
                            wrapper(q, t)):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{name}: launch alone differs from the wrapper")
            it = 20 if B <= 65536 else 5
            alone = time_kernel(
                lambda: ksg.semiglobal_launch_t(qa, ta, *launch_args, **kw), (), iters=it)
            wrapped = time_kernel(wrapper, (q, t), iters=it)
            print(json.dumps({"label": args.label, "form": name, "pairs": B, "n": L,
                              "m": L, "alone_ms": alone * 1e3,
                              "wrapper_ms": wrapped * 1e3}), flush=True)
            del qa, ta
        del codes
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
