"""Time the local row-scan and the profile kernel's thread form on the card.

Run from the root of a checkout (``env PYTHONPATH=. python3
<this script> --label new``): it builds that checkout's
``csrc/sw_rowscan.cu`` and ``csrc/sw_profile.cu`` and times, per form, the
entry point's call (``best_engine`` for the score forms,
``best_ends_engine`` for the endpoint forms) and the launch alone, CUDA
events, best of 3, at 32,768 and 1,048,576 pairs of 128 x 128 (random
codes from a fixed seed: DNA under (10,-30,15) and (10,-30,40,15) for the
four uniform forms, protein under BLOSUM62 11 and 11/1 for the four
profile forms, as ``chip_smoke.py`` phases 4, 7 and 16). Both sizes take
the profile kernel's thread form. One JSON line per (form, shape); the
first line is the card's name and power limit. ``--lb`` times a checkout
from before the kernels read [B, L] codes (its launches take the [L, B]
transposes its wrappers made): the codes are transposed before the clock
starts, so both checkouts' launches are timed on the same inputs. On a
machine with the card:

    (cd <earlier checkout> && env PYTHONPATH=. python3 \\
        <repo>/tools/rowscan_times.py --label earlier --lb)
    env PYTHONPATH=. python3 tools/rowscan_times.py --label new
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_10_30_15, ScoringParams, dna_matrix
from swtpu_torch.kernels import sw_batch as kb
from swtpu_torch.kernels import sw_profile as kp
from swtpu_torch.ops import best_ends_engine, best_engine
from swtpu_torch.utils import time_kernel

SEED = 10013
L = 128
AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
P_LIN = ScoringParams.linear(BLOSUM62, 11)
P_GOTOH = ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)
# form (as chip_smoke.py's KERNELS) -> (scoring, endpoint)
FORMS = {
    "sw_batch": (DNA_10_30_15, False), "sw_batch_ends": (DNA_10_30_15, True),
    "sw_affine": (AFF, False), "sw_affine_ends": (AFF, True),
    "sw_profile": (P_LIN, False), "sw_profile_ends": (P_LIN, True),
    "sw_profile_affine": (P_GOTOH, False), "sw_profile_affine_ends": (P_GOTOH, True),
}


def launch(name, p, ends, q, t, dev):
    """The form's launch alone on codes in the checkout's layout."""
    if name.startswith("sw_profile"):
        table = kp.profile_table(p, dev)
        return lambda: kp.profile_launch_t(q, t, table, p, ends)
    mm = kb._uniform_match_mismatch(p)
    return lambda: kb.rowscan_launch_t(q, t, p, *mm, not p.is_linear, ends)


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
    for B in (32768, 1 << 20):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        assert kp.profile_form(B, L, L, n_sm) == "thread"
        codes = {letters: [torch.from_numpy(rng.integers(0, letters, (B, L), dtype=np.uint8)
                                            ).to(dev) for _ in range(2)]
                 for letters in (4, 20)}
        for name, (p, ends) in FORMS.items():
            q, t = codes[20 if name.startswith("sw_profile") else 4]
            qa, ta = (q.t().contiguous(), t.t().contiguous()) if args.lb else (q, t)
            bare = launch(name, p, ends, qa, ta, dev)
            call = (best_ends_engine if ends else best_engine)(p)
            got, want = bare(), call(q, t)
            for g, w in zip(got if ends else (got,), want if ends else (want,)):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{name}: launch alone differs from the entry point")
            it = 20 if B <= 65536 else 5
            alone = time_kernel(bare, (), iters=it)
            wrapped = time_kernel(call, (q, t), iters=it)
            print(json.dumps({"label": args.label, "form": name, "pairs": B, "n": L,
                              "m": L, "alone_ms": alone * 1e3,
                              "call_ms": wrapped * 1e3}), flush=True)
            del qa, ta
        del codes
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
