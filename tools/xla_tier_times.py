"""Time the card's counterparts of JAX's XLA tier: the general local kernel
in each form and the per-round band past W = 128, with the warp kernel
beside them.

Run from the root of a checkout (``env PYTHONPATH=. python3 <this script>
--label new``): it builds that checkout's ``csrc/sw_general.cu`` and
``csrc/sw_xdrop.cu`` and times, CUDA events, best of 3:

- the general kernel at 32,768 pairs of 128 x 128 (DNA, half related, 3%
  pads inside) under gap 0 and Gotoh 3/0, scores and endpoints: the
  entry point's call (``sw_general`` / ``sw_general_ends``) and each form's
  launch alone that the checkout has (the sweep form in every checkout;
  the tile form, with the packed key and with the select tracker, where
  it exists);
- the per-round band on 256 related 2048-mers, scores only: the wide
  band's CTA launch alone (``xdrop_wide_launch_t``) at W = 129, 160, 192,
  224, 256, 384, 512 and 1024, its one-warp form alone where the checkout
  has it (W <= 256), the wrapper's call at W = 256 and 512, with ns a round
  of the longest pair; the warp kernel's launch alone at W = 32 and 96.

Every launch is checked equal to the entry point's call first. One JSON
line per time; the first line is the card's name and power limit. To
compare two checkouts, run both in one call on one card, in turns (parent,
new, new, parent):

    (cd <earlier checkout> && env PYTHONPATH=. python3 \\
        <repo>/tools/xla_tier_times.py --label earlier)
    env PYTHONPATH=. python3 tools/xla_tier_times.py --label new
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from swtpu_torch.core.encode import mutate
from swtpu_torch.core.scoring import ScoringParams, dna_matrix
from swtpu_torch.kernels import banded_batch as kbb
from swtpu_torch.kernels import sw_general as kg
from swtpu_torch.kernels.sw_profile import profile_table
from swtpu_torch.utils import time_kernel

SEED = 10020
SCORINGS = {"gap 0": ScoringParams.linear(dna_matrix(1, -1), 0),
            "Gotoh 3/0": ScoringParams(dna_matrix(2, -3), 3, 0)}
WIDE = (129, 160, 192, 224, 256, 384, 512, 1024)
WARP = (32, 96)


def general_pairs(rng, B, n, m):
    """Half related (the query's codes in the target's first columns), 3%
    pads inside, as chip_smoke.py's local_pairs makes them."""
    q = rng.integers(0, 4, (B, n)).astype(np.uint8)
    t = rng.integers(0, 4, (B, m)).astype(np.uint8)
    k = min(n, m)
    t[: B // 2, :k] = q[: B // 2, :k]
    q[rng.random(q.shape) < 0.03] = 4
    t[rng.random(t.shape) < 0.03] = 5
    return q, t


def same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def general(label, dev):
    rng = np.random.default_rng(SEED)
    B, n, m = 32768, 128, 128
    q, t = (torch.from_numpy(x).to(dev) for x in general_pairs(rng, B, n, m))
    sweep = getattr(kg, "general_sweep_launch_t", None) or kg.general_launch_t
    tile = getattr(kg, "general_tile_launch_t", None)
    for name, p in SCORINGS.items():
        table = profile_table(p, dev)
        for ends in (False, True):
            call = kg.sw_general_ends if ends else kg.sw_general
            want = call(q, t, p)
            forms = {"sweep": lambda: sweep(q, t, table, p, ends)}
            if tile is not None:
                forms["tile"] = lambda: tile(q, t, table, p, ends)
                if ends:
                    forms["tile select"] = lambda: tile(q, t, table, p, ends, True)
            for form, fn in forms.items():
                if not same(fn(), want):
                    raise RuntimeError(f"{form} ({name}, ends {ends}) differs from the call")
                emit(label=label, kernel="sw_general", scoring=name, ends=ends, form=form,
                     pairs=B, n=n, m=m, alone_ms=time_kernel(fn, (), iters=10) * 1e3)
            emit(label=label, kernel="sw_general", scoring=name, ends=ends, form="call",
                 pairs=B, n=n, m=m, call_ms=time_kernel(call, (q, t, p), iters=10) * 1e3)
    del q, t
    torch.cuda.empty_cache()


def band(label, dev):
    rng = np.random.default_rng(SEED + 1)
    B, L = 256, 2048
    aq = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    at = np.stack([mutate(rng, aq[b], out_len=L) for b in range(B)])
    q, t = torch.from_numpy(aq).to(dev), torch.from_numpy(at).to(dev)
    staged = kbb.stage(q, t, None, None, dev)
    warp = getattr(kbb, "xdrop_wide_warp_launch_t", None)
    for W in WIDE + WARP:
        call = kbb.banded_batch(q, t, bandwidth=W, with_history=False)
        if W in WIDE:
            forms = {"cta": kbb.xdrop_wide_launch_t}
            if warp is not None and W <= kbb.WIDE_WARP_MAX_WIDTH:
                forms["warp"] = warp
        else:
            forms = {"round": kbb.xdrop_launch_t}
        for form, launch in forms.items():
            def fn(W=W, launch=launch):
                return launch(*staged, W, 70, 1, 1, 1, with_history=False)

            got = fn()
            if not all(torch.equal(a, b) for a, b in zip(
                    got[:3], (call.score, call.max_round, call.n_rounds))):
                raise RuntimeError(f"W={W} {form}: the launch alone differs from the call")
            alone = time_kernel(fn, (), iters=5) * 1e3
            rounds = int(call.n_rounds.max())
            emit(label=label, kernel="banded_batch_wide" if W in WIDE else "xdrop_round",
                 form=form, W=W, pairs=B, L=L, alone_ms=alone,
                 ns_a_round=alone * 1e6 / rounds, rounds_max=rounds,
                 rounds_sum=int(call.n_rounds.sum()))
        if W in (256, 512):
            emit(label=label, kernel="banded_batch_wide", form="call", W=W, pairs=B, L=L,
                 call_ms=time_kernel(lambda W=W: kbb.banded_batch(
                     q, t, bandwidth=W, with_history=False), (), iters=5) * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="the checkout's name in the output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit(label=args.label, card=smi.stdout.strip())
    general(args.label, dev)
    band(args.label, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
