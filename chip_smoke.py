#!/usr/bin/env python3
"""Smoke run of the swtpu_torch port on one CUDA card.

Drives the port's two main paths on the card, through the entry points a
user calls, and holds every CUDA kernel against its plain PyTorch version:
the DNA path (batched local alignment under uniform scoring: scores,
endpoints, traceback, the ``align`` CLI; the row-scan kernels of
``csrc/sw_rowscan.cu``) and the protein / general-matrix path (BLOSUM62,
linear and Gotoh gaps; the profile kernels of ``csrc/sw_profile.cu``).

   1. environment: card name and power limit, device count;
   2. build: nvcc on both CUDA sources at once; registers, spills and
      shared memory of each kernel;
   3. kernels vs plain versions on the card, exactly equal (integers,
      tolerance 0), on DNA and protein shapes, pads and scorings; the
      profile kernel on a uniform scoring against the row-scan kernel;
      64-pair spot checks against the numpy oracle;
   4. DNA main path, scores: ``best_engine`` at the SpeedTest size,
      1,048,576 x (128 x 128), linear (10, -30, 15) and affine
      (10, -30, open 40, extend 15), timed with CUDA events; all 1M scores
      held against the plain version on the card;
   5. DNA main path, traceback: ``sw_align_batch`` on 256 related pairs,
      linear and affine, with endpoint, rescoring, CIGAR and SAM checks;
      the device endpoints held against the plain version;
   6. DNA CLI: ``swtpu_torch.cli.main(["align", ...])``, captured and
      checked against the oracle;
   7. protein main path, scores: ``best_engine`` at 1,048,576 x
      (128 x 128) random protein, BLOSUM62 linear 11 and Gotoh 11/1
      (the JAX package's ``bench_protein`` scorings), timed; all 1M scores
      held against the plain version on the card, in chunks;
   8. protein main path, BASELINE config 3: 64 mutated 120-mer fragments
      against the 256 SwissProt-like targets of
      ``swtpu/data/swissprot_like_256.fasta`` (read as data), 16,384 pairs
      in 6 target-length buckets, as the JAX package's
      ``bench_protein_swissprot`` builds them; wall ms and GCUPS over the
      real cells; every score against the plain version, 32 against the
      oracle;
   9. protein main path, traceback: ``sw_align_batch`` on 256 related
      protein 128-mers, Gotoh 11/1 and linear 11, with the same checks as
      phase 5 and a protein SEQ in SAM;
  10. protein CLI: ``align --alphabet protein``, captured and checked;
  11. kernel times at 32768 x (128 x 128) (DNA for the row-scan kernels,
      protein for the profile kernels): the wrapper (layout transposes
      included) and the launch alone on codes already transposed, beside
      the plain version's time and the bound; the one-line benchmark.

Launch counts are zeroed just before each path (phases 4 and 7) and read
just after it (phases 6 and 10); every kernel of a path must have
launched in its window. Any failed check raises, and the run exits
nonzero. Without a card it exits 2 and prints no result.

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
from pathlib import Path

import numpy as np
import torch

SEED = 10000
ROWSCAN, PROFILE = "sw_rowscan.cu", "sw_profile.cu"
SWISSPROT = Path(__file__).resolve().parent / "swtpu" / "data" / "swissprot_like_256.fasta"
# DRAM rate of an H100 SXM (NVIDIA data sheet); INT32 lanes and shared
# memory banks (32-bit words per clock) per SM on Hopper
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
SMEM_WORDS_PER_SM = 32

# kernel -> (source, mangled-name fragment in nvcc's report, the TPU
# kernel it replaces, int32 ops per DP cell as written, shared-memory
# lookups per cell). Row-scan: score select 3 (compare, select, pad
# select), linear H 5 (add, max 0, max(up, left), subtract gap, max),
# affine F 3 + E 3 + H 4, running best 1 for scores or 3 for ends
# (compare, two selects). Profile: the score is one add (table offset)
# and one shared-memory lookup instead of the select 3.
KERNELS = {
    "sw_batch": (ROWSCAN, "sw_rowscan_kernelILb0ELb0E",
                 "swtpu/kernels/pallas/sw_batch.py:317", 9, 0),
    "sw_batch_ends": (ROWSCAN, "sw_rowscan_kernelILb0ELb1E",
                      "swtpu/kernels/pallas/sw_batch.py:215", 11, 0),
    "sw_affine": (ROWSCAN, "sw_rowscan_kernelILb1ELb0E",
                  "swtpu/kernels/pallas/sw_affine.py:145", 14, 0),
    "sw_affine_ends": (ROWSCAN, "sw_rowscan_kernelILb1ELb1E",
                       "swtpu/kernels/pallas/sw_affine.py:175", 16, 0),
    "sw_profile": (PROFILE, "sw_profile_kernelILb0ELb0E",
                   "swtpu/kernels/pallas/sw_profile.py:287", 7, 1),
    "sw_profile_ends": (PROFILE, "sw_profile_kernelILb0ELb1E",
                        "swtpu/kernels/pallas/sw_profile.py:353", 9, 1),
    "sw_profile_affine": (PROFILE, "sw_profile_kernelILb1ELb0E",
                          "swtpu/kernels/pallas/sw_profile.py:287", 12, 1),
    "sw_profile_affine_ends": (PROFILE, "sw_profile_kernelILb1ELb1E",
                               "swtpu/kernels/pallas/sw_profile.py:353", 14, 1),
}
DNA_PATH = ["sw_batch", "sw_batch_ends", "sw_affine", "sw_affine_ends"]
PROTEIN_PATH = ["sw_profile", "sw_profile_ends", "sw_profile_affine",
                "sw_profile_affine_ends"]


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


def related_pairs(rng, B, L, letters=4):
    """Targets = the query with ~10% substitutions and a few indels,
    cut or filled with random letters to length L."""
    qs = rng.integers(0, letters, size=(B, L), dtype=np.uint8)
    ts = np.empty_like(qs)
    for b in range(B):
        t = qs[b].copy()
        sub = rng.random(L) < 0.10
        t[sub] = (t[sub] + rng.integers(1, letters, size=int(sub.sum()))) % letters
        t = list(t)
        for _ in range(int(rng.integers(1, 4))):  # deletions
            del t[int(rng.integers(0, len(t)))]
        for _ in range(int(rng.integers(1, 4))):  # insertions
            t.insert(int(rng.integers(0, len(t))), int(rng.integers(0, letters)))
        t = np.array(t[:L], dtype=np.uint8)
        ts[b, : len(t)] = t
        ts[b, len(t):] = rng.integers(0, letters, size=L - len(t), dtype=np.uint8)
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


def run_cli(cli_main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue().splitlines()


def max_abs_err(got, want):
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(tup(got), tup(want)))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2

    from swtpu_torch.batch import sw_align_batch
    from swtpu_torch.cli import main as cli_main
    from swtpu_torch.core.cigar import cigar_stats, path_to_cigar
    from swtpu_torch.core.io import load_fasta_batch
    from swtpu_torch.core.protein import BLOSUM62, decode_protein, random_protein
    from swtpu_torch.core.sam import sam_record
    from swtpu_torch.core.scoring import (
        DNA_10_30_15, ScoringParams, dna_matrix,
    )
    from swtpu_torch.kernels import (
        _build, sw_affine as ka, sw_batch as kb, sw_profile as kp,
    )
    from swtpu_torch.oracle.affine import (
        sw_affine_score_batch, sw_affine_traceback,
    )
    from swtpu_torch.oracle.sw import sw_score_batch, sw_traceback
    from swtpu_torch.ops import best_ends_engine, best_engine
    from swtpu_torch.utils import time_kernel

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    AFF = ScoringParams(dna_matrix(10, -30), gap_open=40, gap_extend=15)
    P_LIN = ScoringParams.linear(BLOSUM62, 11)
    P_GOTOH = ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)
    DNA_GENERAL = np.array(
        [[3, -2, -1, -2], [-2, 3, -2, -1], [-1, -2, 3, -2], [-2, -1, -2, 3]]
    )
    # kernel -> (wrapper, plain version, scoring its times are taken at)
    kernel_fns = {
        "sw_batch": (kb.sw_batch, kb.sw_batch_plain, DNA_10_30_15),
        "sw_batch_ends": (kb.sw_batch_ends, kb.sw_batch_ends_plain, DNA_10_30_15),
        "sw_affine": (ka.sw_affine, ka.sw_affine_plain, AFF),
        "sw_affine_ends": (ka.sw_affine_ends, ka.sw_affine_ends_plain, AFF),
        "sw_profile": (kp.sw_profile, kp.sw_profile_plain, P_LIN),
        "sw_profile_ends": (kp.sw_profile_ends, kp.sw_profile_ends_plain, P_LIN),
        "sw_profile_affine": (kp.sw_profile, kp.sw_profile_plain, P_GOTOH),
        "sw_profile_affine_ends": (kp.sw_profile_ends, kp.sw_profile_ends_plain,
                                   P_GOTOH),
    }

    def profile_name(ends, p):
        return "sw_profile" + ("" if p.is_linear else "_affine") + (
            "_ends" if ends else "")

    def launches(name):
        # the profile wrappers count all their launches and, apart, those
        # of the affine instantiation
        kern = kernel_fns[name][0]
        if name not in PROTEIN_PATH:
            return kern.launches
        return (kern.launches_affine if "affine" in name
                else kern.launches - kern.launches_affine)

    def zero_launches(names):
        for name in names:
            kern = kernel_fns[name][0]
            kern.launches = 0
            if name in PROTEIN_PATH:
                kern.launches_affine = 0

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
    _build.build_all([ROWSCAN, PROFILE])  # one nvcc per source, in parallel
    print(f"nvcc {ROWSCAN} and {PROFILE}: {time.perf_counter() - t0:.1f} s "
          f"(0.0 s means they were already built)", flush=True)
    seen = set()
    for source in (ROWSCAN, PROFILE):
        for e in re.split(r"Compiling entry function '", _build.build_log(source))[1:]:
            mangled = e.split("'")[0]
            name = next((k for k, v in KERNELS.items()
                         if v[0] == source and v[1] in mangled), None)
            check(name is not None, f"unknown kernel in nvcc report: {e[:80]}")
            regs = re.search(r"Used (\d+) registers", e)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", e)
            smem = re.search(r"(\d+) bytes smem", e)
            check(regs and spill, f"no register report for {name}")
            print(f"{name}: registers {regs.group(1)}, spill stores "
                  f"{spill.group(1)} B, spill loads {spill.group(2)} B, shared "
                  f"memory {smem.group(1) if smem else 0} B", flush=True)
            seen.add(name)
    check(seen == set(KERNELS), f"nvcc built {sorted(seen)}")

    # 3. kernels vs plain versions -----------------------------------------
    phase("3 kernels vs plain versions (exact)")
    rng = np.random.default_rng(SEED)
    max_err = {name: 0 for name in KERNELS}
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
                kern, plain, _ = kernel_fns[name]
                got = kern(qd, td, p)
                torch.cuda.synchronize()
                err = max_abs_err(got, plain(qd, td, p))
                max_err[name] = max(max_err[name], err)
                print(f"{label} ({int(p.matrix[0, 0])},{int(p.matrix[0, 1])},"
                      f"{p.gap_open},{p.gap_extend}) {name}: max |kernel - "
                      f"plain| = {err}", flush=True)
                check(err == 0, f"{name} differs from its plain version on {label}")
    # the profile kernels: protein and general DNA matrices (their own
    # generator, so the DNA phases keep their inputs)
    prng = np.random.default_rng(SEED + 1)
    prot_q = random_protein(prng, (32768, 128))
    prot_t = random_protein(prng, (32768, 128))
    ptail_q = random_protein(prng, (1000, 90))
    ptail_q[:, 70:] = 24
    ptail_t = random_protein(prng, (1000, 200))
    ptail_t[:500, 180:] = 25
    dna_n_q, dna_n_t = flag_q.copy(), flag_t.copy()  # internal N (code 4)
    dna_n_q[prng.random(dna_n_q.shape) < 0.05] = 4
    dna_n_t[prng.random(dna_n_t.shape) < 0.05] = 4
    profile_cases = [
        ("32768x128x128 protein", prot_q, prot_t, [P_LIN, P_GOTOH]),
        ("1000x90x200 protein pad tail", ptail_q, ptail_t, [P_LIN, P_GOTOH]),
        ("32768x128x128 DNA general matrix, internal N", dna_n_q, dna_n_t, [
            ScoringParams.linear(DNA_GENERAL, 2),
            ScoringParams(DNA_GENERAL, gap_open=3, gap_extend=1),
        ]),
        ("32768x128x128 protein tie-rich", prot_q, prot_t,
         [ScoringParams.linear(BLOSUM62, 1)]),
        ("4x40x2560 protein", random_protein(prng, (4, 40)),
         random_protein(prng, (4, 2560)), [P_LIN, P_GOTOH]),
        ("33x7x1 protein", random_protein(prng, (33, 7)),
         random_protein(prng, (33, 1)), [P_LIN, P_GOTOH]),
    ]
    for label, qh, th, plist in profile_cases:
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        for p in plist:
            for ends, kern, plain in ((False, kp.sw_profile, kp.sw_profile_plain),
                                      (True, kp.sw_profile_ends,
                                       kp.sw_profile_ends_plain)):
                name = profile_name(ends, p)
                got = kern(qd, td, p)
                torch.cuda.synchronize()
                err = max_abs_err(got, plain(qd, td, p))
                max_err[name] = max(max_err[name], err)
                print(f"{label} gap=({p.gap_open},{p.gap_extend}) {name}: max "
                      f"|kernel - plain| = {err}", flush=True)
                check(err == 0, f"{name} differs from its plain version on {label}")
    # the profile kernel on a uniform scoring equals the row-scan kernel
    qd, td = torch.from_numpy(flag_q).to(dev), torch.from_numpy(flag_t).to(dev)
    for p in (DNA_10_30_15, AFF):
        row = ((kb.sw_batch, kb.sw_batch_ends) if p.is_linear
               else (ka.sw_affine, ka.sw_affine_ends))
        for ends, kern, rkern in ((False, kp.sw_profile, row[0]),
                                  (True, kp.sw_profile_ends, row[1])):
            err = max_abs_err(kern(qd, td, p), rkern(qd, td, p))
            check(err == 0, f"{profile_name(ends, p)} differs from "
                  f"{rkern.__name__} on uniform scoring")
    print("32768x128x128 uniform DNA scoring: the profile kernels equal the "
          "row-scan kernels", flush=True)
    # 64-pair spot checks against the numpy oracle
    for label, qh, th, plist in (
        ("DNA", flag_q[:64], flag_t[:64], (DNA_10_30_15, AFF)),
        ("protein", prot_q[:64], prot_t[:64], (P_LIN, P_GOTOH)),
    ):
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        for p in plist:
            batch_oracle, walker = ((sw_score_batch, sw_traceback) if p.is_linear
                                    else (sw_affine_score_batch, sw_affine_traceback))
            if label == "DNA":
                fn_s, fn_e = ((kb.sw_batch, kb.sw_batch_ends) if p.is_linear
                              else (ka.sw_affine, ka.sw_affine_ends))
            else:
                fn_s, fn_e = kp.sw_profile, kp.sw_profile_ends
            want = batch_oracle(qh, th, p)
            check(np.array_equal(fn_s(qd, td, p).cpu().numpy(), want),
                  f"{fn_s.__name__} vs oracle")
            sc, ei, ej = (x.cpu().numpy() for x in fn_e(qd, td, p))
            for b in range(64):
                s0, path = walker(qh[b], th[b], p)
                check(s0 == sc[b] and (ei[b], ej[b]) == (path[-1] if s0 else (0, 0)),
                      f"{fn_e.__name__} vs oracle at pair {b}")
            print(f"oracle spot check, 64 {label} pairs, gap=({p.gap_open},"
                  f"{p.gap_extend}), {fn_s.__name__} and {fn_e.__name__}: "
                  f"scores and endpoints equal", flush=True)
    del flag_q, flag_t, prot_q, prot_t, dna_n_q, dna_n_t, qd, td
    torch.cuda.empty_cache()

    # DNA main path: counts from here to the end of phase 6 ----------------
    zero_launches(DNA_PATH)

    # 4. DNA main path, scores ---------------------------------------------
    phase("4 DNA main path, scores: best_engine at 1,048,576 x (128x128)")
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
        err = max_abs_err(scores, kernel_fns[name][1](qd, td, p))
        max_err[name] = max(max_err[name], err)
        print(f"best_engine gap=({p.gap_open},{p.gap_extend}) vs {name}'s "
              f"plain version over all {B} pairs: max |kernel - plain| = "
              f"{err} ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(err == 0, f"{name} differs from its plain version at 1M pairs")
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
    torch.cuda.empty_cache()

    # 5. DNA main path, traceback ------------------------------------------
    phase("5 DNA main path, traceback: sw_align_batch on 256 related pairs")

    def traceback_phase(qs, ts, plist, names_of, alphabet, seq_of):
        qs_d, ts_d = torch.from_numpy(qs).to(dev), torch.from_numpy(ts).to(dev)
        L = qs.shape[1]
        for p in plist:
            ends_fn = best_ends_engine(p)
            got = ends_fn(qs, ts)
            name = names_of(p)
            err = max_abs_err(got, kernel_fns[name][1](qs_d, ts_d, p))
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
                cig = path_to_cigar(path, qs[b], ts[b], query_len=L)
                st = cigar_stats(cig)
                check(st["query_consumed"] == L, f"CIGAR query length, pair {b}")
                check(st["target_consumed"] == path[-1][1] - path[0][1],
                      f"CIGAR target length, pair {b}")
                rec = sam_record(f"q{b}", f"t{b}", qs[b], ts[b], score, path,
                                 alphabet, query_len=L).split("\t")
                check(len(rec) == 13 and rec[5] == cig and rec[9] == seq_of(qs[b])
                      and rec[11] == f"AS:i:{score}", f"SAM record, pair {b}")
            check(n_mapped > 200, f"only {n_mapped} of 256 related pairs aligned")
            print(f"gap=({p.gap_open},{p.gap_extend}): device ends "
                  f"{ends_s * 1e3:.4f} ms, equal to {name}'s plain version; "
                  f"sw_align_batch {walk_s:.2f} s wall (host walk), {n_mapped} "
                  f"aligned, mean score {float(np.mean([r[0] for r in res])):.2f}; "
                  f"endpoints, rescoring, CIGAR and SAM checked", flush=True)

    qs, ts = related_pairs(rng, 256, 128)
    traceback_phase(
        qs, ts, (DNA_10_30_15, AFF),
        lambda p: "sw_batch_ends" if p.is_linear else "sw_affine_ends", "dna",
        lambda q: "".join("ACGT"[c] for c in q),
    )

    # 6. DNA CLI -----------------------------------------------------------
    phase("6 DNA CLI: swtpu_torch align")
    base = ["align", "--random", "64x128x128", "--scoring", "10,-30"]
    lines = run_cli(cli_main, base + ["--gap", "15", "--cigar"])
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
    recs = [json.loads(x) for x in run_cli(cli_main, base + ["--gap", "15"])]
    check([r["score"] for r in recs] == want.tolist(), "CLI score-only")
    lines = run_cli(cli_main, base + ["--gap-open", "40", "--gap-extend", "15", "--sam"])
    body = [x for x in lines if not x.startswith("@")]
    want = sw_affine_score_batch(cq, ct, AFF)
    check(len(body) == 64 and all(
        (x.split("\t")[11] == f"AS:i:{w}") if w else x.split("\t")[1] == "4"
        for x, w in zip(body, want)), "CLI affine --sam")
    print("align score-only and affine --sam: outputs equal the oracle", flush=True)

    launch_counts = {name: launches(name) for name in DNA_PATH}
    print(f"DNA main-path launches: {launch_counts}", flush=True)
    check(all(v > 0 for v in launch_counts.values()),
          f"a kernel was not launched on the DNA main path: {launch_counts}")

    # protein main path: counts from here to the end of phase 10 -----------
    zero_launches(PROTEIN_PATH)

    # 7. protein main path, scores -----------------------------------------
    phase("7 protein main path, scores: best_engine at 1,048,576 x (128x128)")
    B, n, m, chunk = 1 << 20, 128, 128, 1 << 17
    prng = np.random.default_rng(SEED)
    qh, th = random_protein(prng, (B, n)), random_protein(prng, (B, m))
    qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
    for p, batch_oracle in ((P_LIN, sw_score_batch), (P_GOTOH, sw_affine_score_batch)):
        fn = best_engine(p)
        scores = fn(qd, td)
        torch.cuda.synchronize()
        check(scores.shape == (B,) and scores.dtype == torch.int32
              and scores.device.type == "cuda", "best_engine output (protein)")
        name = profile_name(False, p)
        t0 = time.perf_counter()
        # the plain tier's [B, n + 1, 32] int32 profile is 17 GB at 1M
        # pairs: compare in chunks
        err = 0
        for lo in range(0, B, chunk):
            err = max(err, max_abs_err(
                scores[lo:lo + chunk],
                kp.sw_profile_plain(qd[lo:lo + chunk], td[lo:lo + chunk], p)))
        max_err[name] = max(max_err[name], err)
        torch.cuda.empty_cache()
        print(f"best_engine BLOSUM62 gap=({p.gap_open},{p.gap_extend}) vs "
              f"{name}'s plain version over all {B} pairs: max |kernel - "
              f"plain| = {err} ({time.perf_counter() - t0:.1f} s)", flush=True)
        check(err == 0, f"{name} differs from its plain version at 1M protein pairs")
        s_host = scores.cpu().numpy()
        check(s_host.min() >= 0 and s_host.max() <= 11 * n, "protein score range")
        idx = rng.choice(B, 64, replace=False)
        check(np.array_equal(s_host[idx], batch_oracle(qh[idx], th[idx], p)),
              "protein best_engine vs oracle on 64 random pairs")
        sec = time_kernel(fn, (qd, td), iters=10)
        cells = B * n * m
        print(f"best_engine BLOSUM62 gap=({p.gap_open},{p.gap_extend}): "
              f"{sec * 1e3:.3f} ms per call, {cells / sec / 1e9:.1f} GCUPS, "
              f"mean score {s_host.mean():.3f} [{smi}]", flush=True)
    del qd, td, qh, th, scores
    torch.cuda.empty_cache()

    # 8. protein main path, BASELINE config 3 ------------------------------
    phase("8 protein main path, BASELINE config 3: 64 queries x 256 "
          "SwissProt-like targets")
    _, db, lens = load_fasta_batch(str(SWISSPROT), "protein", pad_to=16,
                                   pad_code=25)
    crng = np.random.default_rng(SEED)  # the JAX bench's own draws
    nq, Lq = 64, 120
    cq = np.empty((nq, Lq), np.uint8)
    for i in range(nq):
        src = int(crng.integers(0, len(db)))
        start = int(crng.integers(0, max(1, lens[src] - Lq)))
        frag = db[src, start: start + Lq].copy()
        sub = crng.random(Lq) < 0.1
        frag[sub] = crng.integers(0, 20, int(sub.sum()))
        cq[i] = np.where(frag >= 24, crng.integers(0, 20, Lq), frag)
    nt = len(db)
    qq = np.broadcast_to(cq[:, None, :], (nq, nt, Lq)).reshape(-1, Lq)
    tt = np.broadcast_to(db[None], (nq, nt, db.shape[1])).reshape(-1, db.shape[1])
    real_cells = int(nq * lens.sum() * Lq)
    tl = np.broadcast_to(lens[None], (nq, nt)).reshape(-1)
    order = np.argsort(tl, kind="stable")
    nb = 6
    splits = [len(order) * i // nb for i in range(nb + 1)]
    bucket_idx = [order[lo:hi] for lo, hi in zip(splits[:-1], splits[1:])]
    buckets = []
    for idxs in bucket_idx:
        bm = int(-(-int(tl[idxs].max()) // 16) * 16)
        buckets.append((torch.from_numpy(np.ascontiguousarray(qq[idxs])).to(dev),
                        torch.from_numpy(np.ascontiguousarray(tt[idxs, :bm])).to(dev)))
    print(f"{nq} x {nt} = {nq * nt} pairs, target lengths {int(lens.min())}-"
          f"{int(lens.max())} (mean {lens.mean():.1f}), buckets of widths "
          f"{[int(b[1].shape[1]) for b in buckets]}; {real_cells} real cells",
          flush=True)
    for p, oracle in ((P_LIN, sw_score_batch), (P_GOTOH, sw_affine_score_batch)):
        fn = best_engine(p)
        got = np.zeros(nq * nt, np.int32)
        err = 0
        for idxs, (dq, dt) in zip(bucket_idx, buckets):
            s = fn(dq, dt)
            err = max(err, max_abs_err(s, kp.sw_profile_plain(dq, dt, p)))
            got[idxs] = s.cpu().numpy()
        name = profile_name(False, p)
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{name} differs from its plain version on config 3")
        want = np.array([int(oracle(qq[k: k + 1], tt[k: k + 1, : lens[k % nt]], p)[0])
                         for k in range(32)], np.int32)
        check(np.array_equal(got[:32], want), "config 3: first 32 pairs vs oracle")

        def run_all(fn=fn):
            return [fn(dq, dt) for dq, dt in buckets]

        sec = time_kernel(run_all, (), iters=5)
        print(f"config 3 BLOSUM62 gap=({p.gap_open},{p.gap_extend}): all "
              f"{nb} buckets {sec * 1e3:.3f} ms wall, {real_cells / sec / 1e9:.1f} "
              f"GCUPS over the real cells; every score equals the plain version, "
              f"the first 32 the oracle; mean score {got.mean():.2f} [{smi}]",
              flush=True)
    del buckets
    torch.cuda.empty_cache()

    # 9. protein main path, traceback --------------------------------------
    phase("9 protein main path, traceback: sw_align_batch on 256 related "
          "protein pairs")
    qs, ts = related_pairs(rng, 256, 128, letters=20)
    traceback_phase(qs, ts, (P_GOTOH, P_LIN),
                    lambda p: profile_name(True, p), "protein", decode_protein)

    # 10. protein CLI ------------------------------------------------------
    phase("10 protein CLI: swtpu_torch align --alphabet protein")
    base = ["align", "--alphabet", "protein", "--random", "64x128x128"]
    rs = np.random.default_rng(SEED)  # the CLI's --random inputs
    cq = rs.integers(0, 20, size=(64, 128)).astype(np.uint8)
    ct = rs.integers(0, 20, size=(64, 128)).astype(np.uint8)
    want = sw_score_batch(cq, ct, P_LIN)
    recs = [json.loads(x) for x in run_cli(cli_main, base + ["--gap", "11", "--cigar"])]
    check([r["score"] for r in recs] == want.tolist(), "protein CLI --cigar scores")
    check(all(cigar_stats(r["cigar"])["query_consumed"] == 128 for r in recs
              if r["score"]), "protein CLI CIGAR lengths")
    recs = [json.loads(x) for x in run_cli(cli_main, base + ["--gap", "11"])]
    check([r["score"] for r in recs] == want.tolist(), "protein CLI score-only")
    lines = run_cli(cli_main, base + ["--gap-open", "11", "--gap-extend", "1", "--sam"])
    body = [x.split("\t") for x in lines if not x.startswith("@")]
    want = sw_affine_score_batch(cq, ct, P_GOTOH)
    check(len(body) == 64 and all(
        ((r[11] == f"AS:i:{w}") if w else r[1] == "4") and r[9] == decode_protein(q)
        for r, w, q in zip(body, want, cq)), "protein CLI Gotoh --sam")
    print("align --alphabet protein --cigar, score-only and Gotoh --sam: "
          "outputs equal the oracle", flush=True)

    launch_counts.update({name: launches(name) for name in PROTEIN_PATH})
    print(f"protein main-path launches: "
          f"{ {k: launch_counts[k] for k in PROTEIN_PATH} }", flush=True)
    check(all(launch_counts[k] > 0 for k in PROTEIN_PATH),
          f"a kernel was not launched on the protein main path: {launch_counts}")

    # 11. kernel times -----------------------------------------------------
    phase("11 kernel times at 32768 x (128x128)")
    print(smi, flush=True)
    B, n, m = 32768, 128, 128
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    issue_rate = n_sm * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    lookup_rate = n_sm * SMEM_WORDS_PER_SM * sm_clock_mhz * 1e6
    inputs = {
        ROWSCAN: (random_codes(rng, (B, n)), random_codes(rng, (B, m))),
        PROFILE: (random_protein(rng, (B, n)), random_protein(rng, (B, m))),
    }
    rows = []
    for source, (qh, th) in inputs.items():
        qd, td = torch.from_numpy(qh).to(dev), torch.from_numpy(th).to(dev)
        # the wrapper's [B, L] -> [L, B] layout transposes alone, and the
        # codes in the kernel's layout for timing the launch alone
        layout_ms = time_kernel(
            lambda q, t: (q.t().contiguous(), t.t().contiguous()), (qd, td),
            iters=20) * 1e3
        print(f"{source} inputs: layout transposes {layout_ms:.4f} ms per call",
              flush=True)
        qT, tT = qd.t().contiguous(), td.t().contiguous()
        for name, (src, _, replaces, ops, lookups) in KERNELS.items():
            if src != source:
                continue
            kern, plain, p = kernel_fns[name]
            ends = name.endswith("_ends")
            ms = time_kernel(kern, (qd, td, p), iters=20) * 1e3
            if source == ROWSCAN:
                def bare(p=p, ends=ends):
                    return kb.rowscan_launch_t(
                        qT, tT, p, *kb._uniform_match_mismatch(p),
                        not p.is_linear, ends)
            else:
                table = kp.profile_table(p, dev)

                def bare(p=p, ends=ends, table=table):
                    return kp.profile_launch_t(qT, tT, table, p, ends)

            for g, w in zip(tup(bare()), tup(kern(qd, td, p))):
                check(torch.equal(g, w), f"{name}: bare launch vs wrapper")
            kernel_ms = time_kernel(bare, (), iters=20) * 1e3
            plain_ms = time_kernel(plain, (qd, td, p), iters=2, warmup=1, reps=2) * 1e3
            n_out = 3 if ends else 1
            table_bytes = 4 * kp.profile_table(p, dev).numel() if source == PROFILE else 0
            bytes_ = B * (n + m) + table_bytes + 4 * B * n_out
            op_ms = B * n * m * ops / issue_rate * 1e3
            lookup_ms = B * n * m * lookups / lookup_rate * 1e3
            byte_ms = bytes_ / HBM_BYTES_PER_S * 1e3
            bound = max(op_ms, lookup_ms, byte_ms)
            rows.append(dict(
                name=name, route="cuda", source=f"swtpu_torch/csrc/{source}",
                replaces=replaces, launches=launch_counts[name],
                max_abs_err=max_err[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if byte_ms >= max(op_ms, lookup_ms) else "operations",
                library_ms=None, kernel_ms=kernel_ms,
            ))
            binds = ("int32 ops" if op_ms >= max(lookup_ms, byte_ms) else
                     "shared-memory lookups" if lookup_ms >= byte_ms else "bytes")
            print(f"{name}: wrapper {ms:.4f} ms ({bound / ms:.1%} of the bound), "
                  f"launch alone {kernel_ms:.4f} ms ({bound / kernel_ms:.1%}), "
                  f"plain {plain_ms:.2f} ms, bound {bound:.4f} ms by {binds} "
                  f"({ops} int32 ops/cell: {op_ms:.4f} ms; {lookups} lookups/cell: "
                  f"{lookup_ms:.4f} ms; at {sm_clock_mhz:.0f} MHz), wrapper "
                  f"{B * n * m / ms / 1e6:.1f} GCUPS", flush=True)
        del qd, td, qT, tT
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
