#!/usr/bin/env python3
"""Smoke run of the swtpu_torch port on one CUDA card.

Drives the port's main path (batched local alignment: scores, endpoints,
traceback, the ``align`` CLI) on the card, through the entry points a
user calls, and holds every CUDA kernel against its plain PyTorch version:

  1. environment: card name and power limit, device count;
  2. build: nvcc on the repo's CUDA sources; registers, spills and shared
     memory of each kernel;
  3. kernels vs plain versions on the card, exactly equal (integers,
     tolerance 0), plus a 64-pair spot check against the numpy oracle;
  4. main path, scores: ``best_engine`` at the SpeedTest size,
     1,048,576 x (128 x 128), linear (10, -30, 15) and affine
     (10, -30, open 40, extend 15), timed with CUDA events; all 1M scores
     held against the plain version on the card;
  5. main path, traceback: ``sw_align_batch`` on 256 related pairs,
     linear and affine, with endpoint, rescoring, CIGAR and SAM checks;
     the device endpoints held against the plain version;
  6. CLI: ``swtpu_torch.cli.main(["align", ...])``, captured and checked;
  7. kernel times at 32768 x (128 x 128): the wrapper (layout transposes
     included) and the launch alone on codes already transposed, beside
     the plain version's time and the int32 issue bound; the one-line
     benchmark.

Launch counts are zeroed just before phase 4 and read just after phase 6;
every kernel must have launched there. Any failed check raises, and the
run exits nonzero. Without a card it exits 2 and prints no result.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 10000
SOURCE = "sw_rowscan.cu"
# DRAM rate of an H100 SXM (NVIDIA data sheet); INT32 lanes per SM on Hopper
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64

# Instantiation of csrc/sw_rowscan.cu -> (wrapper name, TPU kernel it
# replaces, int32 ops per DP cell as the kernel is written):
#   score select 3 (compare, select, pad select), linear H 5 (add, max 0,
#   max(up, left), subtract gap, max), affine F 3 + E 3 + H 4, running
#   best 1 for scores or 3 for ends (compare, two selects).
KERNELS = {
    "ILb0ELb0E": ("sw_batch", "swtpu/kernels/pallas/sw_batch.py:317", 9),
    "ILb0ELb1E": ("sw_batch_ends", "swtpu/kernels/pallas/sw_batch.py:215", 11),
    "ILb1ELb0E": ("sw_affine", "swtpu/kernels/pallas/sw_affine.py:145", 14),
    "ILb1ELb1E": ("sw_affine_ends", "swtpu/kernels/pallas/sw_affine.py:175", 16),
}


def tup(x):
    return x if isinstance(x, tuple) else (x,)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi(fields):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def phase(name):
    print(f"== {name}", flush=True)


def random_codes(rng, shape):
    return rng.integers(0, 4, size=shape, dtype=np.uint8)


def related_pairs(rng, B, L):
    """Targets = the query with ~10% substitutions and a few indels,
    cut or filled with random bases to length L."""
    qs = random_codes(rng, (B, L))
    ts = np.empty_like(qs)
    for b in range(B):
        t = qs[b].copy()
        sub = rng.random(L) < 0.10
        t[sub] = (t[sub] + rng.integers(1, 4, size=int(sub.sum()))) % 4
        t = list(t)
        for _ in range(int(rng.integers(1, 4))):  # deletions
            del t[int(rng.integers(0, len(t)))]
        for _ in range(int(rng.integers(1, 4))):  # insertions
            t.insert(int(rng.integers(0, len(t))), int(rng.integers(0, 4)))
        t = np.array(t[:L], dtype=np.uint8)
        ts[b, : len(t)] = t
        ts[b, len(t):] = random_codes(rng, (L - len(t),))
    return qs, ts


def rescore(path, q, t, params):
    """Score of a local alignment path, from its steps alone."""
    mat = params.matrix
    go, ge = params.gap_open, params.gap_extend
    total, prev_step = 0, None
    for (i0, j0), (i1, j1) in zip(path, path[1:]):
        step = (i1 - i0, j1 - j0)
        if step == (1, 1):
            total += int(mat[q[i1 - 1], t[j1 - 1]])
        else:
            total -= ge if step == prev_step else go
        prev_step = step
    return total


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2

    from swtpu_torch.batch import sw_align_batch
    from swtpu_torch.cli import main as cli_main
    from swtpu_torch.core.cigar import cigar_stats, path_to_cigar
    from swtpu_torch.core.sam import sam_record
    from swtpu_torch.core.scoring import (
        DNA_10_30_15, ScoringParams, dna_matrix,
    )
    from swtpu_torch.kernels import _build, sw_affine as ka, sw_batch as kb
    from swtpu_torch.oracle.affine import (
        sw_affine_score_batch, sw_affine_traceback,
    )
    from swtpu_torch.oracle.sw import sw_score_batch, sw_traceback
    from swtpu_torch.ops import best_ends_engine, best_engine
    from swtpu_torch.utils import time_kernel

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
    kernel_fns = {
        "sw_batch": (kb.sw_batch, kb.sw_batch_plain),
        "sw_batch_ends": (kb.sw_batch_ends, kb.sw_batch_ends_plain),
        "sw_affine": (ka.sw_affine, ka.sw_affine_plain),
        "sw_affine_ends": (ka.sw_affine_ends, ka.sw_affine_ends_plain),
    }

    # 1. environment -------------------------------------------------------
    phase("1 environment")
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device {kind} count {count} torch {torch.__version__} "
          f"cuda {torch.version.cuda} max SM clock {sm_clock_mhz:.0f} MHz",
          flush=True)

    # 2. build ------------------------------------------------------------
    phase("2 build")
    t0 = time.perf_counter()
    _build.build_all([SOURCE])
    print(f"nvcc {SOURCE}: {time.perf_counter() - t0:.1f} s "
          f"(0.0 s means it was already built)", flush=True)
    log = _build.build_log(SOURCE)
    entries = re.split(r"Compiling entry function '", log)[1:]
    seen = set()
    for e in entries:
        tag = next((k for k in KERNELS if k in e.split("'")[0]), None)
        check(tag is not None, f"unknown kernel in nvcc report: {e[:80]}")
        regs = re.search(r"Used (\d+) registers", e)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
        smem = re.search(r"(\d+) bytes smem", e)
        check(regs and spill, f"no register report for {tag}")
        print(f"{KERNELS[tag][0]}: registers {regs.group(1)}, spill stores "
              f"{spill.group(1)} B, spill loads {spill.group(2)} B, shared "
              f"memory {smem.group(1) if smem else 0} B", flush=True)
        seen.add(tag)
    check(seen == set(KERNELS), f"nvcc built {sorted(seen)}")

    # 3. kernels vs plain versions -----------------------------------------
    phase("3 kernels vs plain versions (exact)")
    rng = np.random.default_rng(SEED)
    max_err = {name: 0 for name in kernel_fns}
    flag_q = random_codes(rng, (32768, 128))
    flag_t = random_codes(rng, (32768, 128))
    odd_q = random_codes(rng, (1000, 90))
    odd_q[:, 70:] = 4
    odd_t = random_codes(rng, (1000, 200))
    cases = [
        ("32768x128x128", flag_q, flag_t, [DNA_10_30_15, AFF]),
        ("1000x90x200 pad tail", odd_q, odd_t, [DNA_10_30_15, AFF]),
        ("32768x128x128 tie-rich", flag_q, flag_t, [
            ScoringParams.linear(dna_matrix(2, -1), 1),
            ScoringParams(dna_matrix(2, -1), gap_open=3, gap_extend=1),
        ]),
        ("32768x128x128 mismatch>=0", flag_q, flag_t, [
            ScoringParams.linear(dna_matrix(1, 1), 1),
            ScoringParams(dna_matrix(1, 1), gap_open=2, gap_extend=1),
        ]),
    ]
    for label, qh, th, plist in cases:
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        for p in plist:
            names = ["sw_affine", "sw_affine_ends"]
            if p.is_linear:  # the affine kernel with open == extend too
                names = ["sw_batch", "sw_batch_ends"] + names
            for name in names:
                kern, plain = kernel_fns[name]
                got = kern(qd, td, p)
                torch.cuda.synchronize()
                want = plain(qd, td, p)
                err = max(int((g.long() - w.long()).abs().max())
                          for g, w in zip(tup(got), tup(want)))
                max_err[name] = max(max_err[name], err)
                print(f"{label} ({int(p.matrix[0, 0])},{int(p.matrix[0, 1])},"
                      f"{p.gap_open},{p.gap_extend}) {name}: max |kernel - "
                      f"plain| = {err}", flush=True)
                check(err == 0, f"{name} differs from its plain version on {label}")
    # 64-pair spot check against the numpy oracle
    q64, t64 = flag_q[:64], flag_t[:64]
    qd, td = torch.from_numpy(q64).to(dev), torch.from_numpy(t64).to(dev)
    for p, batch_oracle, walker in (
        (DNA_10_30_15, sw_score_batch, sw_traceback),
        (AFF, sw_affine_score_batch, sw_affine_traceback),
    ):
        fn_s, fn_e = ((kb.sw_batch, kb.sw_batch_ends) if p.is_linear
                      else (ka.sw_affine, ka.sw_affine_ends))
        want = batch_oracle(q64, t64, p)
        check(np.array_equal(fn_s(qd, td, p).cpu().numpy(), want),
              f"{fn_s.__name__} vs oracle")
        sc, ei, ej = (x.cpu().numpy() for x in fn_e(qd, td, p))
        for b in range(64):
            s0, path = walker(q64[b], t64[b], p)
            check(s0 == sc[b] and (s0 == 0 or path[-1] == (ei[b], ej[b])),
                  f"{fn_e.__name__} vs oracle at pair {b}")
        print(f"oracle spot check, 64 pairs, {fn_s.__name__} and "
              f"{fn_e.__name__}: equal", flush=True)
    del flag_q, flag_t

    # main path: counts from here to the end of phase 6 --------------------
    for kern, _ in kernel_fns.values():
        kern.launches = 0

    # 4. main path, scores ------------------------------------------------
    phase("4 main path, scores: best_engine at 1,048,576 x (128x128)")
    B, n, m = 1 << 20, 128, 128
    qh, th = random_codes(rng, (B, n)), random_codes(rng, (B, m))
    qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
    for p, batch_oracle in ((DNA_10_30_15, sw_score_batch),
                            (AFF, sw_affine_score_batch)):
        fn = best_engine(p)
        scores = fn(qd, td)
        torch.cuda.synchronize()
        check(scores.shape == (B,) and scores.dtype == torch.int32
              and scores.device.type == "cuda", "best_engine output")
        # every one of the B scores against the plain version, on the card
        name = "sw_batch" if p.is_linear else "sw_affine"
        t0 = time.perf_counter()
        want = kernel_fns[name][1](qd, td, p)
        err = int((scores.long() - want.long()).abs().max())
        max_err[name] = max(max_err[name], err)
        print(f"best_engine gap=({p.gap_open},{p.gap_extend}) vs {name}'s "
              f"plain version over all {B} pairs: max |kernel - plain| = "
              f"{err} ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(err == 0, f"{name} differs from its plain version at 1M pairs")
        del want
        torch.cuda.empty_cache()
        s_host = scores.cpu().numpy()
        check(s_host.min() >= 0 and s_host.max() <= 10 * n, "score range")
        idx = rng.choice(B, 64, replace=False)
        check(np.array_equal(s_host[idx], batch_oracle(qh[idx], th[idx], p)),
              "best_engine vs oracle on 64 random pairs")
        sec = time_kernel(fn, (qd, td), iters=10)
        cells = B * n * m
        print(f"best_engine gap=({p.gap_open},{p.gap_extend}): "
              f"{sec * 1e3:.3f} ms per call, {cells / sec / 1e9:.1f} GCUPS, "
              f"{1e6 / B * sec * 1e3:.3f} ms per 1M alignments, mean score "
              f"{s_host.mean():.3f} [{smi}]", flush=True)
    # the wrapper's share of that call: the [B, L] -> [L, B] transposes
    layout_s = time_kernel(
        lambda q, t: (q.t().contiguous(), t.t().contiguous()), (qd, td), iters=10
    )
    print(f"of which layout transposes: {layout_s * 1e3:.3f} ms per call",
          flush=True)
    del qd, td, qh, th, scores

    # 5. main path, traceback ---------------------------------------------
    phase("5 main path, traceback: sw_align_batch on 256 related pairs")
    qs, ts = related_pairs(rng, 256, 128)
    qs_d, ts_d = torch.from_numpy(qs).to(dev), torch.from_numpy(ts).to(dev)
    for p in (DNA_10_30_15, AFF):
        ends_fn = best_ends_engine(p)
        got = ends_fn(qs, ts)
        name = "sw_batch_ends" if p.is_linear else "sw_affine_ends"
        want = kernel_fns[name][1](qs_d, ts_d, p)
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{name} differs from its plain version on 256 pairs")
        sc, ei, ej = (x.cpu().numpy() for x in got)
        ends_s = time_kernel(ends_fn, (qs_d, ts_d))
        t0 = time.perf_counter()
        res = sw_align_batch(qs, ts, p)
        walk_s = time.perf_counter() - t0
        n_mapped = 0
        for b, (score, path) in enumerate(res):
            check(score == sc[b], f"score of pair {b}")
            if score == 0:
                continue
            n_mapped += 1
            check(path[-1] == (ei[b], ej[b]), f"endpoint of pair {b}")
            check(rescore(path, qs[b], ts[b], p) == score, f"rescore of pair {b}")
            cig = path_to_cigar(path, qs[b], ts[b], query_len=128)
            st = cigar_stats(cig)
            check(st["query_consumed"] == 128, f"CIGAR query length, pair {b}")
            check(st["target_consumed"] == path[-1][1] - path[0][1],
                  f"CIGAR target length, pair {b}")
            rec = sam_record(f"q{b}", f"t{b}", qs[b], ts[b], score, path,
                             query_len=128).split("\t")
            check(len(rec) == 13 and rec[5] == cig
                  and rec[11] == f"AS:i:{score}", f"SAM record, pair {b}")
        check(n_mapped > 200, f"only {n_mapped} of 256 related pairs aligned")
        print(f"gap=({p.gap_open},{p.gap_extend}): device ends "
              f"{ends_s * 1e3:.4f} ms, equal to {name}'s plain version; "
              f"sw_align_batch {walk_s:.2f} s wall (host walk), {n_mapped} "
              f"aligned, mean score {float(np.mean([r[0] for r in res])):.2f}; "
              f"endpoints, rescoring, CIGAR and SAM checked", flush=True)

    # 6. CLI --------------------------------------------------------------
    phase("6 CLI: swtpu_torch align")

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(argv)
        return buf.getvalue().splitlines()

    base = ["align", "--random", "64x128x128", "--scoring", "10,-30"]
    lines = run_cli(base + ["--gap", "15", "--cigar"])
    recs = [json.loads(x) for x in lines]
    rs = np.random.default_rng(SEED)  # the CLI's --random inputs
    cq = rs.integers(0, 4, size=(64, 128)).astype(np.uint8)
    ct = rs.integers(0, 4, size=(64, 128)).astype(np.uint8)
    want = sw_score_batch(cq, ct, DNA_10_30_15)
    check(len(recs) == 64 and [r["pair"] for r in recs] == [f"pair{i}" for i in range(64)],
          "CLI --cigar records")
    check([r["score"] for r in recs] == want.tolist(), "CLI --cigar scores")
    check(all(cigar_stats(r["cigar"])["query_consumed"] == 128 for r in recs),
          "CLI CIGAR lengths")
    print(f"align --cigar: 64 records, scores equal the oracle; first: {lines[0]}",
          flush=True)
    recs = [json.loads(x) for x in run_cli(base + ["--gap", "15"])]
    check([r["score"] for r in recs] == want.tolist(), "CLI score-only")
    lines = run_cli(base + ["--gap-open", "40", "--gap-extend", "15", "--sam"])
    body = [x for x in lines if not x.startswith("@")]
    want = sw_affine_score_batch(cq, ct, AFF)
    check(len(body) == 64 and all(
        (x.split("\t")[11] == f"AS:i:{w}") if w else x.split("\t")[1] == "4"
        for x, w in zip(body, want)), "CLI affine --sam")
    print("align score-only and affine --sam: outputs equal the oracle", flush=True)

    launches = {name: kern.launches for name, (kern, _) in kernel_fns.items()}
    print(f"main-path launches: {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")

    # 7. kernel times -----------------------------------------------------
    phase("7 kernel times at 32768 x (128x128)")
    print(smi, flush=True)
    B, n, m = 32768, 128, 128
    qd = torch.from_numpy(random_codes(rng, (B, n))).to(dev)
    td = torch.from_numpy(random_codes(rng, (B, m))).to(dev)
    issue_rate = torch.cuda.get_device_properties(0).multi_processor_count * \
        INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    # the wrapper's [B, L] -> [L, B] layout transposes alone, and the codes
    # in the kernel's layout for timing the launch alone
    layout_ms = time_kernel(
        lambda q, t: (q.t().contiguous(), t.t().contiguous()), (qd, td), iters=20
    ) * 1e3
    print(f"layout transposes: {layout_ms:.4f} ms per call", flush=True)
    qT, tT = qd.t().contiguous(), td.t().contiguous()
    rows = []
    for tag, (name, replaces, ops) in KERNELS.items():
        kern, plain = kernel_fns[name]
        affine, ends = "affine" in name, name.endswith("_ends")
        p = AFF if affine else DNA_10_30_15
        ms = time_kernel(kern, (qd, td, p), iters=20) * 1e3

        def bare(p=p, affine=affine, ends=ends):
            return kb.rowscan_launch_t(
                qT, tT, p, *kb._uniform_match_mismatch(p), affine, ends
            )

        for g, w in zip(tup(bare()), tup(kern(qd, td, p))):
            check(torch.equal(g, w), f"{name}: bare launch vs wrapper")
        kernel_ms = time_kernel(bare, (), iters=20) * 1e3
        plain_ms = time_kernel(plain, (qd, td, p), iters=2, warmup=1, reps=2) * 1e3
        n_out = 3 if name.endswith("_ends") else 1
        bytes_ = B * (n + m) + 4 * B * n_out
        op_ms = B * n * m * ops / issue_rate * 1e3
        byte_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=f"swtpu_torch/csrc/{SOURCE}",
            replaces=replaces, launches=launches[name],
            max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=max(op_ms, byte_ms),
            bound_by="operations" if op_ms >= byte_ms else "bytes",
            library_ms=None, kernel_ms=kernel_ms,
        ))
        bound = max(op_ms, byte_ms)
        print(f"{name}: wrapper {ms:.4f} ms ({bound / ms:.1%} of the bound), "
              f"launch alone {kernel_ms:.4f} ms ({bound / kernel_ms:.1%}), "
              f"plain {plain_ms:.2f} ms, bound {bound:.4f} ms ({ops} int32 "
              f"ops/cell at {sm_clock_mhz:.0f} MHz), wrapper "
              f"{B * n * m / ms / 1e6:.1f} GCUPS", flush=True)
    from swtpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(["--batch", str(B)])
    rec = json.loads(buf.getvalue().splitlines()[-1])
    check(rec["metric"] == "sw_batch_128x128_gcups_cuda" and rec["value"] > 0,
          "bench line")
    print(f"bench: {json.dumps(rec)}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
