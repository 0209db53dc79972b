"""Time the wavefront kernel (``csrc/sw_wavefront.cu``) on the card.

Run from the root of a checkout (``env PYTHONPATH=. python3 <this script>
--label new``): it builds that checkout's ``csrc/sw_wavefront.cu`` and
times, at 128 and 8192 pairs of 128 x 128 (random codes from a fixed
seed: DNA under (10,-30,15) and (1,-1,1), protein under BLOSUM62 11, as
``chip_smoke.py`` phase 32), the launch alone (``wavefront_launch_t``
with the checkout's default pairs a stream) and the entry point's call
(``sw_wavefront``), CUDA events, best of 3, after checking that the two
agree; beside them the launch's device time without the host's gaps (a
CUDA graph of 20 launches replayed, best of 3: at 128 pairs the back-to-back
launches wait on the host) and the host's microseconds a launch. One JSON
line per (scoring, pairs); the first line is the card's name and power
limit. ``--sweep`` (a checkout whose launch takes ``pairs`` and
``paired``) also times every P (pairs a stream) of 1-16, each checked
against the default, by its device time (the graph), and prints the P
``wavefront_stream`` picks beside the fastest: under (10,-30,15) at 16
pairs of 128 x 1024 and 64, 128, 1024, 8192, 65536 and 1,048,576 pairs of
128 x 128, under BLOSUM62 11 at 8192, 65536 and 1,048,576 pairs; and for
DNA at 8192 and 65536 pairs the lane table by columns beside the default
one by pairs of columns (an A/B of the two forms, each at its own picks).
On a
machine with the card, parent first and last:

    (cd <earlier checkout> && env PYTHONPATH=. python3 \\
        <repo>/tools/wavefront_times.py --label earlier)
    env PYTHONPATH=. python3 tools/wavefront_times.py --label new
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from swtpu_torch.core.protein import BLOSUM62
from swtpu_torch.core.scoring import DNA_10_30_15, DNA_111, ScoringParams
from swtpu_torch.kernels import sw_wavefront as kwf
from swtpu_torch.utils import time_kernel

SEED = 10014
L = 128
SCORINGS = {"(10,-30,15)": (DNA_10_30_15, 4), "(1,-1,1)": (DNA_111, 4),
            "BLOSUM62 11": (ScoringParams.linear(BLOSUM62, 11), 20)}
# (scoring, pairs, m, the table by pairs of columns): None the default form
SWEEP = (("(10,-30,15)", 16, 1024, None), ("(10,-30,15)", 64, 128, None),
         ("(10,-30,15)", 128, 128, None), ("(10,-30,15)", 1024, 128, None),
         ("(10,-30,15)", 8192, 128, None), ("(10,-30,15)", 8192, 128, False),
         ("(10,-30,15)", 65536, 128, None), ("(10,-30,15)", 65536, 128, False),
         ("(10,-30,15)", 1 << 20, 128, None),
         ("BLOSUM62 11", 8192, 128, None), ("BLOSUM62 11", 65536, 128, None),
         ("BLOSUM62 11", 1 << 20, 128, None))
SWEEP_PAIRS = range(1, 17)  # every pairs a stream the kernel takes


def codes(rng, B, letters, dev, m=L):
    return [torch.from_numpy(rng.integers(0, letters, (B, k), dtype=np.uint8)).to(dev)
            for k in (L, m)]


def graph_time(fn, args, iters=20, reps=3):
    """Best-of-``reps`` device seconds a call, ``iters`` calls captured in
    one CUDA graph and replayed between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    best = float("inf")
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / iters)
    return best


def host_time(fn, args, iters=200):
    """Host seconds a call: the wrapper's Python and the launch's enqueue."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True, help="the checkout's name in the output")
    ap.add_argument("--sweep", action="store_true", help="time every form too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to time", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip()}), flush=True)
    rng = np.random.default_rng(SEED)
    for B in (128, 8192):
        for label, (p, letters) in SCORINGS.items():
            q, t = codes(rng, B, letters, dev)
            table = kwf.wavefront_table(p, dev)
            if not torch.equal(kwf.wavefront_launch_t(q, t, table, p),
                               kwf.sw_wavefront(q, t, p)):
                raise RuntimeError(f"{label}: launch alone differs from the entry point")
            alone = time_kernel(kwf.wavefront_launch_t, (q, t, table, p), iters=20)
            call = time_kernel(kwf.sw_wavefront, (q, t, p), iters=20)
            graph = graph_time(kwf.wavefront_launch_t, (q, t, table, p))
            host = host_time(kwf.wavefront_launch_t, (q, t, table, p))
            print(json.dumps({"label": args.label, "scoring": label, "pairs": B, "n": L,
                              "m": L, "alone_ms": alone * 1e3, "call_ms": call * 1e3,
                              "graph_ms": graph * 1e3, "host_us": host * 1e6}), flush=True)
    if args.sweep:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        for label, B, m, paired in SWEEP:
            p, letters = SCORINGS[label]
            A = p.alphabet_size
            if paired is None:
                paired = kwf.wavefront_form(A)
            table = kwf.wavefront_table(p, dev)
            q, t = codes(rng, B, letters, dev, m)
            want = kwf.wavefront_launch_t(q, t, table, p)
            times = {}
            for pairs in SWEEP_PAIRS:
                fn_args = (q, t, table, p, pairs, paired)
                if not torch.equal(kwf.wavefront_launch_t(*fn_args), want):
                    raise RuntimeError(f"{pairs} pairs a stream differ at {B} pairs")
                times[pairs] = graph_time(kwf.wavefront_launch_t, fn_args) * 1e3
            picked = kwf.wavefront_stream(B, L, m, n_sm, A, paired)
            fastest = min(times, key=times.get)
            print(json.dumps({"label": args.label, "scoring": label, "sweep_pairs": B,
                              "m": m, "table": "pairs of columns" if paired else "columns",
                              "ms": {f"P{k}": v for k, v in times.items()},
                              "picked": picked, "picked_ms": times[picked],
                              "fastest": fastest, "fastest_ms": times[fastest]}), flush=True)
            del q, t, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
