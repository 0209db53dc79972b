"""Full benchmark suite on the card: every engine, JAX's record format.

Port of ``swtpu/bench_suite.py``: the same sections (``--suite``), the same
``"JSON: "`` records with the same fields and ``kernel`` names, the same
``--quick`` / ``--runs`` / ``--forever`` / ``--cpu-mesh`` flags, plus
``--device`` (``cuda``, the default, or ``cpu``). Each record's ``device``
field holds ``torch.cuda.get_device_name()`` (``"cpu"`` on the CPU).

    python -m swtpu_torch.bench_suite [--quick] [--suite all] [--runs N]
    python -m swtpu_torch bench [--quick] ...         # the same, as a subcommand

What runs where is decided once, from the device (``_route``, as
``models.mapper._route`` does): a CUDA device takes the records JAX fills
on a TPU, each through the card's kernels; the CPU takes the records JAX
fills on its CPU backend, each through the plain PyTorch tiers. A record
JAX fills on the TPU from its XLA (not Pallas) tier (``sw_*_xla_diag``,
``sw_*_colscan``, ``affine_xla_diag``, ``semiglobal_xla_diag``,
``banded_xdrop_32_70_xla``, ``protein_swissprot_colscan_*``) is filled on
the card by the card's engine for the same function (``best_engine``, the
per-round, semi-global or profile kernel), as ``align --engine`` does: the
plain tiers never run on the card, and nothing falls back to the CPU.
Each section takes ``route=`` ("card" / "cpu", by default the device's),
so tests run the card's records through the plain versions on the CPU.

Timing: on the card CUDA events (``utils.timing.time_kernel``, seconds a
call, best of 3) for device-resident units, host walls (min of reps, after
``torch.cuda.synchronize``) for end-to-end units; on the CPU the host's
min wall of two calls after a warm one, as JAX's ``_dist_time`` does on its
CPU mesh. No CPU number is a device number.

Two sections run in fresh processes, as in JAX: the 16K tracebacks
(``--suite semiglobal16k``) and the distributed curve (``--suite dist``):
its anchor is a world of one on the device (NCCL on the card), and its
curve at 1/2/4/8 ranks runs in gloo worlds of CPU ranks started with
``torchrun`` (``--cpu-mesh N``: up to N ranks), which take the place of
JAX's virtual CPU devices. A child that fails raises here (exit status 1).

``SIZES`` is the one table of sizes (full, ``--quick``); child processes
run at their parent's table (``SWTPU_TORCH_BENCH_SIZES``). ``--launches
PATH`` writes the kernels' launch counts of the run (children included),
by record, as JSON. Each section's wall goes to stderr as ``# section``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: name -> (full size, --quick size); child processes inherit the table
SIZES = {
    "sw_len": (128, 128),  # query / target length of the 128 x 128 sections
    "sw_pairs": (8192, 1024),  # sw variants, affine, protein, semiglobal_full
    "sw_oracle_pairs": (256, 64),
    "sw_wavefront_pairs": (128, 128),
    "band_len": (2048, 512),  # the banded section's related pairs
    "band_pairs": (256, 64),
    "block_wide_pairs": (1024, 1024),  # banded_block_w64_k64_b1024
    "fixed_pairs": (2048, 512),  # the fixed band's related pairs
    "fixed_1m_pairs": (1_000_000, 0),  # BASELINE config 2 (0: not run)
    "fixed_1m_chunk": (131072, 131072),
    "fixed_1m_len": (128, 128),
    "l16_card": (16384, 16384),  # the 16K tracebacks on the card
    "l16_cpu": (2048, 2048),  # ... their scaled-down stand-in on the CPU
    "b16": (8, 2),
    "b16_wide": (128, 0),  # the block walk's wide batch (0: not run)
    "varlen_pairs": (32768, 4096),
    "varlen_len": (300, 300),  # the longest read (reads are 100..len bp)
    "varlen_window": (320, 320),
    "traceback_sample": (64, 64),
    "unpack_seqs": (10000, 10000),
    "unpack_reps": (100, 10),
    "unpack_device_rows": (8192, 8192),
    "unpack_device_len": (2048, 2048),
    "swissprot_queries": (64, 16),
    "swissprot_targets": (0, 64),  # 0: the whole subset
    "swissprot_buckets": (6, 2),
    "swissprot_qlen": (120, 120),
    "search_chunk": (2048, 512),
    "search_targets": (131072, 16384),
    "search_e2e_chunk": (8192, 8192),
    "map_genome": (1_000_000, 200_000),
    "map_reads": (4096, 512),
    "msa_seqs": (48, 16),
    "msa_len": (256, 128),
    "msa_n256": (256, 0),  # the scale record (0: not run)
    "dist_pairs": (4096, 1024),  # a rank's batch
    "dist_targets": (2048, 512),  # a rank's database shard
    "dist_qlen": (4096, 2048),  # a rank's query strip
    "dist_tlen": (4096, 2048),
    "forever_pairs": (8192, 8192),
}

SIZES_ENV = "SWTPU_TORCH_BENCH_SIZES"
RANK_RECORD = "RANK0: "  # a dist world's records, before the 1-rank efficiencies
SWISSPROT = (Path(__file__).resolve().parent.parent / "swtpu" / "data"
             / "swissprot_like_256.fasta")
SUITES = ("all", "sw", "semiglobal", "semiglobal16k", "semiglobal_full", "affine",
          "protein", "swissprot", "unpack", "varlen", "dist", "search", "map", "msa")
#: the parity fields a record may carry; each must read true
PARITY_FIELDS = ("parity", "parity_vs_block_oracle", "projection_ok")


def _n(env, key):
    full, quick = SIZES[key]
    return quick if env.quick else full


def _inputs(batch, n, m, seed=10000):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 4, size=(batch, n)).astype(np.uint8),
        rng.integers(0, 4, size=(batch, m)).astype(np.uint8),
    )


def _route(device) -> str:
    """"card" on a CUDA device, else "cpu" (decided once, from the type)."""
    return "card" if torch.device(device).type == "cuda" else "cpu"


class _Env:
    """Where a section runs: the device, the route ("card": the records
    JAX fills on a TPU; "cpu": those of its CPU backend), --quick."""

    def __init__(self, quick=False, device=None, route=None):
        from swtpu_torch.utils.device import resolve_device

        self.quick = bool(quick)
        self.dev = resolve_device(device)
        self.card = (route or _route(self.dev)) == "card"
        self.kind = (torch.cuda.get_device_name(self.dev) if self.dev.type == "cuda"
                     else "cpu")

    def put(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.dev)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _time(fn, args, env, k=8):
    """Seconds a call: CUDA events on the card (``time_kernel``, ``k``
    calls a rep, best of 3); on the CPU the min wall of two calls after a
    warm one."""
    if env.dev.type == "cuda":
        from swtpu_torch.utils.timing import time_kernel

        return time_kernel(fn, args, iters=k)
    fn(*args)
    best = None
    for _ in range(2):
        t0 = time.perf_counter()
        fn(*args)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _wall(fn, env):
    """Host seconds of ``fn()`` with the device's queue drained on both
    sides (an end-to-end wall)."""
    env.sync()
    t0 = time.perf_counter()
    out = fn()
    env.sync()
    return time.perf_counter() - t0, out


# -- the kernels' launch counts -------------------------------------------

_LAUNCH_MODULES = ("sw_batch", "sw_affine", "sw_profile", "sw_bf16", "semiglobal_batch",
                   "semiglobal_profile", "sw_banded", "banded_batch", "banded_block",
                   "device_walk", "longpair_strip", "sw_wavefront", "sw_general")
#: record kernel name -> {wrapper count: launches while the record was made}
LAUNCHES = {}
_last_counts = {}


def launch_counts():
    """{"module.wrapper.count": n}: every kernel wrapper's launch counts."""
    import importlib

    out = {}
    for mod_name in _LAUNCH_MODULES:
        mod = importlib.import_module(f"swtpu_torch.kernels.{mod_name}")
        for name, fn in sorted(vars(mod).items()):
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                for k, v in sorted(vars(fn).items()):
                    if k.startswith("launches") and isinstance(v, int):
                        out[f"{mod_name}.{name}.{k}"] = v
    return out


def _mark_launches(kernel):
    """Charge the launches since the last record to ``kernel``."""
    global _last_counts
    now = launch_counts()
    delta = {k: v - _last_counts.get(k, 0) for k, v in now.items()
             if v != _last_counts.get(k, 0)}
    _last_counts = now
    if delta:
        mine = LAUNCHES.setdefault(kernel, {})
        for k, v in delta.items():
            mine[k] = mine.get(k, 0) + v


def _merge_launches(by_record):
    for kernel, counts in by_record.items():
        mine = LAUNCHES.setdefault(kernel, {})
        for k, v in counts.items():
            mine[k] = mine.get(k, 0) + v


def _emit(rec, out, line=None):
    if line is not None:
        print(line)
    print("JSON:", json.dumps(rec))
    _mark_launches(rec["kernel"])
    out.append(rec)


# -- child processes --------------------------------------------------------

def _child_env(extra=None):
    env = dict(os.environ, **(extra or {}))
    env[SIZES_ENV] = json.dumps(SIZES)
    return env


def _subprocess_records(argv, launcher=None, timeout=3600, prefix="JSON: ", env=None):
    """Run ``python -m swtpu_torch.bench_suite ARGV`` (or under
    ``launcher``, a command prefix such as torchrun's) in a fresh process
    at this process's size table; returns the records it printed after
    ``prefix`` (echoing its other lines, and its ``JSON:`` records as they
    are) and merges its launch counts; ``env``: variables to set for it.
    A child that fails raises RuntimeError with the tail of its output."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        counts = os.path.join(tmp, "launches.json")
        cmd = (launcher or [sys.executable, "-m"]) + ["swtpu_torch.bench_suite"] + list(
            argv) + ["--launches", counts]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                              env=_child_env(env))
        if proc.returncode:
            raise RuntimeError(
                f"bench_suite child {' '.join(argv)} failed (exit {proc.returncode}):\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        if os.path.exists(counts):
            with open(counts) as f:
                _merge_launches(json.load(f)["by_record"])
    out = []
    for line in proc.stdout.splitlines():
        if line == "[":  # the child's closing list of every record
            break
        if line.startswith(prefix):
            out.append(json.loads(line[len(prefix):]))
            if prefix != "JSON: ":
                continue
        if not line.startswith("WARNING"):
            print(line)
    return out


# -- the sections -----------------------------------------------------------

def _variant(name, params, env):
    """fn(qs, ts) of variant ``name``: on the card a plain tier's name
    runs ``best_engine`` (module note)."""
    from swtpu_torch.ops.variants import PLAIN_TIERS, VARIANTS, best_engine

    if env.card and name in PLAIN_TIERS:
        return best_engine(params, env.dev)
    fn = VARIANTS[name]
    return lambda q, t: fn(q, t, params, env.dev)


def bench_sw_variants(quick=False, device=None, route=None):
    from swtpu_torch.core.scoring import DNA_10_30_15, DNA_111
    from swtpu_torch.ops.variants import VARIANTS
    from swtpu_torch.oracle import sw_score_batch

    env = _Env(quick, device, route)
    n = m = _n(env, "sw_len")
    results = []
    for params, pname in ((DNA_10_30_15, "10_-30_15"), (DNA_111, "111")):
        for name in VARIANTS:
            if name == "oracle":
                batch = _n(env, "sw_oracle_pairs")
                qs, ts = _inputs(batch, n, m)
                t0 = time.perf_counter()
                sw_score_batch(qs, ts, params)
                dt = (time.perf_counter() - t0) / batch
                parity = True  # oracle is the definition
            else:
                batch = _n(env, "sw_wavefront_pairs" if name == "wavefront" else "sw_pairs")
                qs, ts = _inputs(batch, n, m)
                dq, dt_ = env.put(qs), env.put(ts)
                fn = _variant(name, params, env)
                out = _host(fn(dq, dt_))
                parity = bool(np.array_equal(
                    out[:64], sw_score_batch(qs[:64], ts[:64], params).astype(np.int32)))
                dt = _time(fn, (dq, dt_), env, k=8) / batch
            ms_per_1m = dt * 1e6 * 1e3
            gcups = n * m / dt / 1e9
            line_name = f"sw_{pname}_{name}"
            rec = dict(
                kernel=line_name,
                batch=batch,
                dtype="int32",
                wall_ms_per_1m=round(ms_per_1m, 1),
                gcups=round(gcups, 2),
                parity=parity,
                device=env.kind,
            )
            _emit(rec, results, f"{line_name}: {ms_per_1m:.0f} ms / 1M")
    return results


def _protein_pairs(rng, B, L):
    """~70%-identity amino-acid pairs (JAX's protein band workload)."""
    pq = rng.integers(0, 24, size=(B, L)).astype(np.uint8)
    pt = pq.copy()
    for b in range(B):
        idx = rng.integers(0, L, L // 3)
        pt[b, idx] = rng.integers(0, 24, L // 3)
    return pq, pt


def bench_semiglobal(quick=False, device=None, route=None):
    from swtpu_torch.core.encode import mutate
    from swtpu_torch.kernels.banded_batch import banded_batch
    from swtpu_torch.kernels.banded_scan import banded_xdrop_batch

    env = _Env(quick, device, route)
    rng = np.random.default_rng(10000)
    L = _n(env, "band_len")
    B = _n(env, "band_pairs")
    qs = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    ts = np.stack([mutate(rng, qs[b], out_len=L) for b in range(B)])

    # the per-round band, score only: on the card every tier is the
    # per-round kernel (JAX's XLA, Pallas and packed tiers in one), on the
    # CPU the plain tier
    tiers = [("banded_xdrop_32_70_xla", qs, ts, {})]
    if env.card:
        from swtpu_torch.core.protein import BLOSUM62

        tiers.append(("banded_xdrop_32_70_pallas", qs, ts, {}))
        # protein homology extension: BLOSUM62 + BLAST-default Gotoh, X=120
        pq, pt = _protein_pairs(rng, B, L)
        tiers.append(("banded_xdrop_blosum62_affine_pallas", pq, pt,
                      dict(matrix=BLOSUM62, gap_open=11, gap_extend=1, x_threshold=120)))
        tiers.append(("banded_xdrop_32_70_packed", qs, ts, {}))
        tiers.append(("banded_affine_xdrop_32_70_packed", qs, ts,
                      dict(gap_open=3, gap_extend=1)))
        # early exit on non-homologous pairs under harsh scoring
        nt = np.stack([rng.integers(0, 4, L).astype(np.uint8) for _ in range(B)])
        tiers.append(("banded_xdrop_early_exit_packed", qs, nt,
                      dict(early_exit=True, mismatch=3, gap=2, x_threshold=40)))
        forward = banded_batch
    else:
        tiers.append(("banded_affine_xdrop_32_70_xla", qs, ts,
                      dict(gap_open=3, gap_extend=1)))
        forward = banded_xdrop_batch
    out = []
    for name, bq, bt, kw in tiers:
        dq, dt_ = env.put(bq), env.put(bt)
        res = forward(dq, dt_, with_history=False, device=env.dev, **kw)
        cells = int(_host(res.n_rounds).astype(np.int64).sum()) * 32
        per = _time(lambda a, b, kw=kw: forward(a, b, with_history=False, device=env.dev,
                                                **kw), (dq, dt_), env, k=8)
        rec = dict(
            kernel=name,
            batch=B,
            seq_len=L,
            wall_ms=round(per * 1e3, 2),
            band_gcups=round(cells / per / 1e9, 3),
            alignments_per_s=round(B / per, 1),
            device=env.kind,
        )
        _emit(rec, out, f"{name}: {per*1e3/B*1e4:.0f} ms / 10K")

    if env.card:
        out += _block_rows(env, rng, qs, ts, B, L)
        out += _fixed_rows(env, rng, L)

    # the reference-scale 16K tracebacks in a fresh process, as in JAX
    out += _subprocess_records(
        ["--suite", "semiglobal16k", "--device", env.dev.type]
        + (["--quick"] if env.quick else []), timeout=1800)
    return out


def _block_rows(env, rng, qs, ts, B, L):
    """The block tier (B9, B10): its contract is the block oracle."""
    from swtpu_torch.core.protein import BLOSUM62
    from swtpu_torch.kernels import banded_block as bblock
    from swtpu_torch.oracle import banded_xdrop_block, banded_xdrop_block_affine

    out = []
    for Kb, Bb in ((32, B), (64, B), (64, _n(env, "block_wide_pairs"))):
        bq = (qs if Bb <= B else np.tile(qs, (-(-Bb // B), 1)))[:Bb]
        bt = (ts if Bb <= B else np.tile(ts, (-(-Bb // B), 1)))[:Bb]
        res = bblock.banded_block_batch(bq, bt, width=64, block=Kb, device=env.dev)
        score = _host(res.score)
        parity = all(
            int(score[p]) == banded_xdrop_block(bq[p], bt[p], width=64, block=Kb)[0]
            for p in range(min(3, Bb)))
        cells = int(_host(res.n_rows).astype(np.int64).sum()) * 64
        # JAX times at an unreachable X (its salted chain X-drops at once);
        # the forward runs every block (early_exit off) either way
        fn, args = bblock.bench_forward_fn(bq, bt, width=64, block=Kb,
                                           x_threshold=1 << 20, device=env.dev)
        per = _time(fn, args, env, k=8)
        rec = dict(
            kernel=f"banded_block_w64_k{Kb}_b{Bb}",
            batch=Bb,
            seq_len=L,
            wall_ms=round(per * 1e3, 2),
            band_gcups=round(cells / per / 1e9, 1),
            alignments_per_s=round(Bb / per, 1),
            parity_vs_block_oracle=parity,
            timing_note="alive-band path (X unreachable in the salted chain)",
            device=env.kind,
        )
        _emit(rec, out, f"banded_block_w64_k{Kb}_b{Bb}: {per*1e3/Bb*1e4:.1f} ms / 10K")

    # affine (Gotoh 3/1) and protein (BLOSUM62 + 11/1, X=120) on the block tier
    res = bblock.banded_block_batch(qs, ts, width=64, block=64, gap_open=3, gap_extend=1,
                                    device=env.dev)
    score = _host(res.score)
    parity = all(
        int(score[p]) == banded_xdrop_block_affine(
            qs[p], ts[p], gap_open=3, gap_extend=1, width=64, block=64)[0]
        for p in range(min(2, B)))
    fn, args = bblock.bench_forward_fn(qs, ts, width=64, block=64, gap_open=3,
                                       gap_extend=1, device=env.dev)
    per = _time(fn, args, env, k=8)
    rec = dict(
        kernel="banded_block_affine_w64_k64", batch=B, seq_len=L,
        wall_ms=round(per * 1e3, 2),
        band_gcups=round(int(_host(res.n_rows).astype(np.int64).sum()) * 64 / per / 1e9, 1),
        alignments_per_s=round(B / per, 1),
        parity_vs_block_oracle=parity,
        device=env.kind,
    )
    _emit(rec, out, f"banded_block_affine_w64_k64: {per*1e3/B*1e4:.1f} ms / 10K")

    pq64, pt64 = _protein_pairs(rng, B, L)
    res = bblock.banded_block_batch(pq64, pt64, width=64, block=64, matrix=BLOSUM62,
                                    x_threshold=120, device=env.dev)
    fn, args = bblock.bench_forward_fn(pq64, pt64, width=64, block=64, matrix=BLOSUM62,
                                       x_threshold=120, device=env.dev)
    per = _time(fn, args, env, k=8)
    rec = dict(
        kernel="banded_block_blosum62_w64_k64", batch=B, seq_len=L,
        wall_ms=round(per * 1e3, 2),
        band_gcups=round(int(_host(res.n_rows).astype(np.int64).sum()) * 64 / per / 1e9, 1),
        alignments_per_s=round(B / per, 1),
        device=env.kind,
    )
    _emit(rec, out, f"banded_block_blosum62_w64_k64: {per*1e3/B*1e4:.1f} ms / 10K")
    return out


def _fixed_rows(env, rng, L):
    """The fixed band (row 10): related pairs and BASELINE config 2."""
    from swtpu_torch.core.encode import mutate
    from swtpu_torch.core.scoring import DNA_111, ScoringParams, dna_matrix
    from swtpu_torch.kernels.sw_banded import sw_banded_static

    out = []
    Bf = _n(env, "fixed_pairs")
    qf = rng.integers(0, 4, size=(Bf, L)).astype(np.uint8)
    tf = np.stack([mutate(rng, qf[b], out_len=L) for b in range(Bf)])
    Wf = 32
    dqf, dtf = env.put(qf), env.put(tf)
    fn = lambda a, b: sw_banded_static(a, b, DNA_111, bandwidth=Wf, device=env.dev)  # noqa: E731
    per = _time(fn, (dqf, dtf), env, k=4)
    cells = Bf * L * (2 * Wf + 1)
    rec = dict(
        kernel="banded_fixed_rowscan_w32",
        batch=Bf,
        seq_len=L,
        wall_ms=round(per * 1e3, 2),
        band_gcups=round(cells / per / 1e9, 1),
        alignments_per_s=round(Bf / per, 1),
        device=env.kind,
    )
    _emit(rec, out, f"banded_fixed_rowscan_w32: {per*1e3/Bf*1e4:.2f} ms / 10K")

    # BASELINE config 2 verbatim: 1M random 128 x 128 pairs at the fixed
    # band, one chunk timed, times the chunks of 1M
    B1 = _n(env, "fixed_1m_pairs")
    if B1:
        L1 = _n(env, "fixed_1m_len")
        CH = _n(env, "fixed_1m_chunk")
        q1 = env.put(rng.integers(0, 4, size=(CH, L1)).astype(np.uint8))
        t1 = env.put(rng.integers(0, 4, size=(CH, L1)).astype(np.uint8))
        per_chunk = _time(fn, (q1, t1), env, k=4)
        wall = per_chunk * -(-B1 // CH)
        rec = dict(
            kernel="banded_fixed_1m_128x128_w32",  # JAX's name at any length
            batch=B1,
            wall_ms=round(wall * 1e3, 1),
            ms_per_1m=round(wall * 1e3, 1),
            band_gcups=round(B1 * L1 * (2 * Wf + 1) / wall / 1e9, 1),
            device=env.kind,
        )
        _emit(rec, out, f"banded_fixed_1m_128x128_w32: {rec['ms_per_1m']} ms / 1M "
                        "(reference simd9 full-matrix: 1884)")
        del q1, t1

    aff = ScoringParams(dna_matrix(1, -1), gap_open=3, gap_extend=1)
    fn = lambda a, b: sw_banded_static(a, b, aff, bandwidth=Wf, device=env.dev)  # noqa: E731
    per = _time(fn, (dqf, dtf), env, k=4)
    rec = dict(
        kernel="banded_fixed_affine_rowscan_w32",
        batch=Bf,
        seq_len=L,
        wall_ms=round(per * 1e3, 2),
        band_gcups=round(cells / per / 1e9, 1),
        alignments_per_s=round(Bf / per, 1),
        device=env.kind,
    )
    _emit(rec, out, f"banded_fixed_affine_rowscan_w32: {per*1e3/Bf*1e4:.2f} ms / 10K")
    return out


def bench_semiglobal_16k(quick=False, device=None, route=None):
    """Reference-scale geometry: 16384-mers end to end WITH traceback,
    forward and walk on the device, split into stages: the device
    forward and walk with the wire's fetch (one host wall), then the host
    decode. The walk's work depends on the data, so each of the three
    timed reps runs a fresh set of related pairs (after a warm one)."""
    from swtpu_torch import native
    from swtpu_torch.core.encode import mutate
    from swtpu_torch.kernels import banded_block as bblock
    from swtpu_torch.kernels.banded_batch import banded_batch
    from swtpu_torch.kernels.banded_scan import _prep_padded, decode_device_walk
    from swtpu_torch.kernels.device_walk import block_walk, xdrop_walk

    env = _Env(quick, device, route)
    rng = np.random.default_rng(10000)
    out = []
    B16 = _n(env, "b16")
    # reference geometry on the card; a scaled-down stand-in on the CPU
    L16 = _n(env, "l16_card" if env.card else "l16_cpu")

    def pair_sets(Bb):
        sets = []
        for _ in range(4):  # a warm set and three timed ones
            q = rng.integers(0, 4, size=(Bb, L16)).astype(np.uint8)
            t = np.stack([mutate(rng, q[b], out_len=L16) for b in range(Bb)])
            sets.append((env.put(q), env.put(t)))
        return sets

    def run_e2e(name, Bb, dispatch):
        dispatch(0)  # build and warm
        env.sync()
        walls, fetches, decodes = [], [], []
        wireb = plenb = None
        for rep in range(1, 4):
            t0 = time.perf_counter()
            wire = dispatch(rep)
            env.sync()
            t_disp = time.perf_counter()
            wireb = _host(wire)
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            fetches.append(t1 - t_disp)
            t0 = time.perf_counter()
            _, plenb, _ = decode_device_walk(wireb, as_arrays=True)
            decodes.append(time.perf_counter() - t0)
        t_fused, t_fetch, t_decode = min(walls), min(fetches), min(decodes)
        wall = t_fused + t_decode
        rec = dict(
            kernel=name,
            batch=Bb,
            seq_len=L16,
            wall_ms=round(wall * 1e3, 1),
            device_fwd_walk_plus_fetch_ms=round(t_fused * 1e3, 1),
            fetch_portion_ms=round(t_fetch * 1e3, 1),
            moves_kb=round(wireb.nbytes / 1024, 1),
            host_decode_ms=round(t_decode * 1e3, 2),
            decode_mode="native" if native.available() else "numpy",
            alignments_per_s=round(Bb / wall, 2),
            mean_path_len=round(float(np.mean(plenb[:Bb])), 1),
            timing="e2e wall: dispatch->wire fetch (+decode); min of 3 "
                   "perturbed reps",
            device=env.kind,
        )
        _emit(rec, out,
              f"{name}: {wall*1e3:.0f} ms / {Bb} (device fwd+walk+fetch "
              f"{t_fused*1e3:.0f} [fetch ~{t_fetch*1e3:.0f}] + decode "
              f"{t_decode*1e3:.1f})")

    # the per-round tier (W = 32): forward with history, then the walk;
    # the card's kernels, the plain versions on the CPU
    sets = pair_sets(B16)

    def round_dispatch(rep):
        q, t = sets[rep]
        res = banded_batch(q, t, with_history=True, compress_history=False,
                           device=env.dev)
        padded = _prep_padded(q, t, None, None, 32, env.dev, torch.int16)
        return xdrop_walk(res, padded, 32, 70, 1, 1, 1)

    run_e2e("banded_16k_traceback_e2e", B16, round_dispatch)

    # the block tier (W = 64 corridor, K = 64 blocks) and its device walk;
    # also at 128 pairs
    if env.card:
        wide = _n(env, "b16_wide")
        for Bb in (B16,) + ((wide,) if wide else ()):
            bsets = sets if Bb == B16 else pair_sets(Bb)

            def block_dispatch(rep, bsets=bsets):
                q, t = bsets[rep]
                run = bblock._setup(q, t, 1, 1, 1, 64, 64, 70, None, None, True, None,
                                    None, None, None, env.dev)
                bblock._forward(run)
                return block_walk(run)

            run_e2e(f"banded_block_16k_traceback_e2e_b{Bb}", Bb, block_dispatch)
    return out


def bench_affine(quick=False, device=None, route=None):
    """Affine (Gotoh) engines."""
    from swtpu_torch.core.scoring import ScoringParams, dna_matrix
    from swtpu_torch.kernels.affine_scan import sw_affine_batch_diag
    from swtpu_torch.kernels.sw_affine import sw_affine
    from swtpu_torch.ops.variants import best_engine

    env = _Env(quick, device, route)
    params = ScoringParams(matrix=dna_matrix(10, -30), gap_open=40, gap_extend=15)
    n = m = _n(env, "sw_len")
    batch = _n(env, "sw_pairs")
    qs, ts = _inputs(batch, n, m)
    dq, dt = env.put(qs), env.put(ts)
    if env.card:
        engines = [("affine_xla_diag", best_engine(params, env.dev)),
                   ("affine_rowscan", lambda a, b: sw_affine(a, b, params, env.dev))]
    else:
        engines = [("affine_xla_diag", lambda a, b: sw_affine_batch_diag(a, b, params,
                                                                          env.dev))]
    out = []
    for name, fn in engines:
        per = _time(fn, (dq, dt), env, k=4)
        rec = dict(
            kernel=name,
            batch=batch,
            gcups=round(batch * n * m / per / 1e9, 2),
            ms_per_1m=round(per / batch * 1e6 * 1e3),
            device=env.kind,
        )
        _emit(rec, out, f"{name}: {rec['ms_per_1m']} ms / 1M")
    return out


def bench_protein(quick=False, device=None, route=None):
    """Protein/BLOSUM62 local alignment."""
    from swtpu_torch.core.protein import BLOSUM62
    from swtpu_torch.core.scoring import ScoringParams
    from swtpu_torch.ops.variants import best_engine

    env = _Env(quick, device, route)
    n = m = _n(env, "sw_len")
    batch = _n(env, "sw_pairs")
    rng = np.random.default_rng(10000)
    qs = rng.integers(0, 24, size=(batch, n)).astype(np.uint8)
    ts = rng.integers(0, 24, size=(batch, m)).astype(np.uint8)
    dq, dt = env.put(qs), env.put(ts)
    cases = [
        ("protein_blosum62_best", ScoringParams.linear(BLOSUM62, 11)),
        # BLAST-default affine protein scoring
        ("protein_blosum62_affine_best", ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)),
    ]
    out = []
    for name, params in cases:
        fn = best_engine(params, env.dev)
        per = _time(fn, (dq, dt), env, k=4)
        rec = dict(
            kernel=name,
            batch=batch,
            gcups=round(batch * n * m / per / 1e9, 2),
            ms_per_1m=round(per / batch * 1e6 * 1e3),
            device=env.kind,
        )
        _emit(rec, out, f"{name}: {rec['ms_per_1m']} ms / 1M")
    return out


def bench_semiglobal_full(quick=False, device=None, route=None):
    """Full-matrix semi-global with endpoints."""
    from swtpu_torch.kernels.semiglobal_batch import semiglobal_batch
    from swtpu_torch.kernels.semiglobal_scan import semiglobal_batch_diag

    env = _Env(quick, device, route)
    n = m = _n(env, "sw_len")
    batch = _n(env, "sw_pairs")
    qs, ts = _inputs(batch, n, m)
    dq, dt = env.put(qs), env.put(ts)
    if env.card:
        from swtpu_torch.core.protein import BLOSUM62
        from swtpu_torch.core.scoring import ScoringParams
        from swtpu_torch.kernels.semiglobal_profile import semiglobal_profile

        rng = np.random.default_rng(10000)
        pq = env.put(rng.integers(0, 24, size=(batch, n)).astype(np.uint8))
        pt = env.put(rng.integers(0, 24, size=(batch, m)).astype(np.uint8))
        aff = ScoringParams(BLOSUM62, gap_open=11, gap_extend=1)
        kernel = lambda a, b: semiglobal_batch(a, b, device=env.dev)[0]  # noqa: E731
        engines = [
            ("semiglobal_xla_diag", kernel),
            ("semiglobal_rowscan", kernel),
            ("semiglobal_prof_blosum62_affine",
             lambda a, b: semiglobal_profile(pq, pt, aff, device=env.dev)[0]),
        ]
    else:
        engines = [("semiglobal_xla_diag",
                    lambda a, b: semiglobal_batch_diag(a, b, device=env.dev)[0])]
    out = []
    for name, fn in engines:
        per = _time(fn, (dq, dt), env, k=4)
        rec = dict(
            kernel=name,
            batch=batch,
            gcups=round(batch * n * m / per / 1e9, 2),
            ms_per_1m=round(per / batch * 1e6 * 1e3),
            device=env.kind,
        )
        _emit(rec, out, f"{name}: {rec['ms_per_1m']} ms / 1M")
    return out


def bench_varlen(quick=False, device=None, route=None):
    """BASELINE config 4: variable-length DNA reads (100-300 bp) against
    fixed reference windows, bucketed dispatch on the 2-bit wire, with the
    overflow-promotion tier and a traceback sample."""
    from swtpu_torch.batch import sw_align_batch, sw_scores_varlen
    from swtpu_torch.batch.bucketing import _fused_masked_engine
    from swtpu_torch.batch.promote import promoted_split, sw_scores_promoted_device
    from swtpu_torch.core.encode import mutate, pack_2bit
    from swtpu_torch.core.scoring import DNA_111
    from swtpu_torch.ops.variants import resolve_engine

    env = _Env(quick, device, route)
    rng = np.random.default_rng(10000)
    B = _n(env, "varlen_pairs")
    n = _n(env, "varlen_len")
    m = _n(env, "varlen_window")
    chunks = 4 if B >= 16384 else 1

    def read_set(seed):
        r = np.random.default_rng(seed)
        lens = r.integers(100 * n // 300, n + 1, B)
        qs = pack_2bit(r.integers(0, 4, size=(B, n)).astype(np.uint8))
        ts = pack_2bit(r.integers(0, 4, size=(B, m)).astype(np.uint8))
        return qs, ts, lens

    # the whole call (upload, decode, masks, engine, score fetch) on a
    # distinct read set a rep, after a warm set
    sets = [read_set(s) for s in (10000, 10001, 10002)]
    sw_scores_varlen(sets[0][0], sets[0][1], DNA_111, sets[0][2], packed=True,
                     stream_chunks=chunks, device=env.dev)
    walls = []
    for qs, ts, lens in sets[1:]:
        walls.append(_wall(lambda: sw_scores_varlen(
            qs, ts, DNA_111, lens, packed=True, stream_chunks=chunks, device=env.dev),
            env)[0])
    wall = min(walls)
    lens = sets[-1][2]
    cells = int(lens.sum()) * m
    out = [
        dict(
            kernel="varlen_reads_bucketed",
            batch=B,
            wire="2bit-packed",
            wall_ms=round(wall * 1e3, 1),
            gcups=round(cells / wall / 1e9, 2),
            alignments_per_s=round(B / wall, 1),
            stream_chunks=chunks,
            device=env.kind,
        )
    ]
    _mark_launches("varlen_reads_bucketed")
    # wire floor: the upload of the same bytes alone (fresh copies a rep)
    # and one [B] score fetch
    floors = []
    for qs_f, ts_f, _ in sets[1:]:
        qf, tf = qs_f.copy(), ts_f.copy()
        floors.append(_wall(lambda: (env.put(qf), env.put(tf)), env)[0])
    zeros = torch.zeros(B, dtype=torch.int32, device=env.dev)
    _host(zeros + 0)  # warm the fetch path
    env.sync()
    t0 = time.perf_counter()
    _host(zeros + 1)
    t_fetch = time.perf_counter() - t0
    floor = min(floors) + t_fetch
    out.append(
        dict(
            kernel="varlen_wire_floor",
            batch=B,
            upload_bytes=int(sets[1][0].nbytes + sets[1][1].nbytes),
            upload_ms=round(min(floors) * 1e3, 1),
            fetch_ms=round(t_fetch * 1e3, 1),
            floor_ms=round(floor * 1e3, 1),
            e2e_over_floor=round(wall / floor, 3),
            device=env.kind,
        )
    )
    _mark_launches("varlen_wire_floor")

    # device-resident rate of the same fused unit (decode, masks, engine)
    engine, ekey = resolve_engine(DNA_111, None, env.dev)
    fn = _fused_masked_engine(engine, ekey, n, m, 4, 5, packed=True)
    qs, ts, lens = sets[-1]
    dq, dt_ = env.put(qs), env.put(ts)
    lq_d = env.put(lens.astype(np.int32))
    lt_d = torch.full((B,), m, dtype=torch.int32, device=env.dev)
    per = _time(lambda a, b: fn(a, b, lq_d, lt_d), (dq, dt_), env, k=8)
    out.append(
        dict(
            kernel="varlen_device_resident",
            batch=B,
            wall_ms=round(per * 1e3, 2),
            gcups=round(cells / per / 1e9, 2),
            alignments_per_s=round(B / per, 1),
            device=env.kind,
        )
    )
    _mark_launches("varlen_device_resident")

    # the promotion tier on a workload that promotes: 1/8 of the pairs are
    # near-identical (scores past the bf16 exact bound), the rest random
    qs = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    ts = rng.integers(0, 4, size=(B, m)).astype(np.uint8)
    for b in range(B // 8):
        ts[b, :n] = mutate(rng, qs[b], p_mismatch=0.02, p_insert=0, p_delete=0)
    qs_w = rng.integers(0, 4, size=(B, n)).astype(np.uint8)
    sw_scores_promoted_device(qs_w, ts, DNA_111, device=env.dev)
    wall, (_, promoted) = _wall(lambda: sw_scores_promoted_device(qs, ts, DNA_111,
                                                                  device=env.dev), env)
    out.append(
        dict(
            kernel="varlen_promoted_bf16_int32",
            batch=B,
            wall_ms=round(wall * 1e3, 1),
            promoted_frac=round(float(promoted.mean()), 4),
            alignments_per_s=round(B / wall, 1),
            mode="device_fused_e2e",
            device=env.kind,
        )
    )
    _mark_launches("varlen_promoted_bf16_int32")
    # device-resident rate of the fused split itself
    npad = -(-n // 8) * 8
    qs_p = np.full((B, npad), 4, np.uint8)
    qs_p[:, :n] = qs
    cap = max(1, B // 4)
    dqs, dts = env.put(qs_p), env.put(ts)
    per = _time(lambda a, b: promoted_split(a, b, DNA_111, cap)[0], (dqs, dts), env, k=8)
    out.append(
        dict(
            kernel="varlen_promoted_device_resident",
            batch=B,
            wall_ms=round(per * 1e3, 2),
            cap_frac=0.25,
            alignments_per_s=round(B / per, 1),
            device=env.kind,
        )
    )
    _mark_launches("varlen_promoted_device_resident")
    # traceback for a sample of pairs (device endpoints, bounded host walk)
    nb = _n(env, "traceback_sample")
    sw_align_batch(qs[:nb], ts[:nb], DNA_111, device=env.dev)  # warm
    wall, _ = _wall(lambda: sw_align_batch(qs[:nb], ts[:nb], DNA_111, device=env.dev), env)
    out.append(
        dict(
            kernel="varlen_traceback_sample",
            batch=nb,
            wall_ms=round(wall * 1e3, 1),
            alignments_per_s=round(nb / wall, 1),
            device=env.kind,
        )
    )
    _mark_launches("varlen_traceback_sample")
    for rec in out:
        ms = rec.get("wall_ms", rec.get("floor_ms"))
        print(f"{rec['kernel']}: {ms} ms / {rec['batch']}")
        print("JSON:", json.dumps(rec))
    return out


def bench_unpack(quick=False, device=None, route=None):
    """2-bit codec: the host path and the device decode, decoded GB/s."""
    from swtpu_torch.core.encode import pack_2bit, unpack_2bit
    from swtpu_torch.kernels.unpack import unpack_2bit_device

    env = _Env(quick, device, route)
    rng = np.random.default_rng(10000)
    seqs = rng.integers(0, 4, size=(_n(env, "unpack_seqs"), 128)).astype(np.uint8)
    packed = pack_2bit(seqs)
    reps = _n(env, "unpack_reps")
    t0 = time.perf_counter()
    for _ in range(reps):
        unpack_2bit(packed)
    wall = (time.perf_counter() - t0) / reps
    rec = dict(
        kernel="unpack_2bit_host",
        bytes_per_s=round(seqs.size / wall / 1e9, 3),
        unit="GB/s",
    )
    out = []
    _emit(rec, out, f"unpack: {wall*1e3:.2f} ms / {len(seqs)} x 128")

    rows, cols = _n(env, "unpack_device_rows"), _n(env, "unpack_device_len")
    dp = env.put(pack_2bit(rng.integers(0, 4, size=(rows, cols)).astype(np.uint8)))
    per = _time(lambda p: unpack_2bit_device(p, env.dev), (dp,), env, k=16)
    rec = dict(
        kernel="unpack_2bit_device",
        wall_ms=round(per * 1e3, 3),
        bytes_per_s=round(rows * cols / per / 1e9, 1),
        unit="GB/s",
        device=env.kind,
    )
    _emit(rec, out, f"unpack_2bit_device: {per*1e3:.3f} ms / {rows} x {cols}")
    return out


def bench_protein_swissprot(quick=False, device=None, route=None):
    """BASELINE config 3: protein queries against a small SwissProt-like
    subset (``swtpu/data/swissprot_like_256.fasta``, read as data) with
    BLOSUM62, linear 11 and Gotoh 11/1 gaps, the pairs sorted by target
    length into a few buckets staged on the device. Queries are mutated
    120-mer fragments of the subset."""
    from swtpu_torch.core.io import load_fasta_batch
    from swtpu_torch.core.protein import BLOSUM62
    from swtpu_torch.core.scoring import ScoringParams
    from swtpu_torch.kernels.colscan import sw_batch_colscan
    from swtpu_torch.kernels.sw_profile import sw_profile
    from swtpu_torch.ops.variants import best_engine
    from swtpu_torch.oracle import sw_affine_score_batch, sw_score_batch

    env = _Env(quick, device, route)
    names, db, lens = load_fasta_batch(str(SWISSPROT), alphabet="protein", pad_to=16,
                                       pad_code=25)
    rng = np.random.default_rng(10000)
    nq = _n(env, "swissprot_queries")
    Lq = _n(env, "swissprot_qlen")
    qs = np.empty((nq, Lq), np.uint8)
    for i in range(nq):
        src = int(rng.integers(0, len(db)))
        start = int(rng.integers(0, max(1, lens[src] - Lq)))
        frag = db[src, start : start + Lq].copy()
        sub = rng.random(Lq) < 0.1
        frag[sub] = rng.integers(0, 20, int(sub.sum()))
        qs[i] = np.where(frag >= 24, rng.integers(0, 20, Lq), frag)
    nt = _n(env, "swissprot_targets") or len(db)
    Nq, Nt = nq, nt
    qq = np.broadcast_to(qs[:, None, :], (Nq, Nt, Lq)).reshape(-1, Lq)
    tt = np.broadcast_to(db[None, :nt], (Nq, Nt, db.shape[1])).reshape(-1, db.shape[1])
    real_cells = int(Nq * lens[:nt].sum() * Lq)

    # pairs sorted by target length into buckets, each padded to its own
    # longest target and staged on the device
    tl = np.broadcast_to(lens[None, :nt], (Nq, Nt)).reshape(-1).astype(np.int64)
    order = np.argsort(tl, kind="stable")
    nb = _n(env, "swissprot_buckets")
    splits = [len(order) * i // nb for i in range(nb + 1)]
    bucket_idx = [order[lo:hi] for lo, hi in zip(splits[:-1], splits[1:])]
    bucket_dev = []
    for idxs in bucket_idx:
        bm = int(-(-int(tl[idxs].max()) // 16) * 16)
        bucket_dev.append((env.put(qq[idxs]), env.put(tt[idxs, :bm])))

    results = []
    for gaps, gname in ((dict(gap_open=11, gap_extend=11), "linear11"),
                        (dict(gap_open=11, gap_extend=1), "gotoh11_1")):
        params = ScoringParams(BLOSUM62, **gaps)
        oracle = sw_score_batch if params.is_linear else sw_affine_score_batch
        # the oracle indexes the 24 x 24 matrix directly: pads trimmed a pair
        npar = min(32, Nq * Nt)
        want = np.array([int(oracle(qq[p : p + 1], tt[p : p + 1, : lens[p % Nt]],
                                    params)[0]) for p in range(npar)], np.int32)
        if env.card:
            engines = [("colscan", best_engine(params, env.dev)),
                       ("rowscan_prof", lambda a, b, p=params: sw_profile(a, b, p, env.dev))]
        else:
            engines = [("colscan", lambda a, b, p=params: sw_batch_colscan(a, b, p, env.dev))]
        for ename, fn in engines:
            got = np.zeros(Nq * Nt, np.int32)
            for idxs, (dq, dt_) in zip(bucket_idx, bucket_dev):
                got[idxs] = _host(fn(dq, dt_))
            parity = bool(np.array_equal(got[:npar], want))

            def run_all(b0q, b0t, fn=fn):
                tot = fn(b0q, b0t).sum()
                for dq2, dt2 in bucket_dev[1:]:
                    tot = tot + fn(dq2, dt2).sum()
                return tot

            per_call = _time(run_all, bucket_dev[0], env, k=4)
            rec = dict(
                kernel=f"protein_swissprot_{ename}_{gname}",
                queries=Nq, targets=Nt,
                pairs=Nq * Nt,
                buckets=nb,
                wall_ms=round(per_call * 1e3, 1),
                gcups=round(real_cells / per_call / 1e9, 2),
                parity=parity,
                device=env.kind,
            )
            _emit(rec, results, f"protein_swissprot_{ename}_{gname}: "
                                f"{per_call*1e3:.1f} ms / {Nq * Nt}")
    return results


def bench_search(quick=False, device=None, route=None):
    """BASELINE config 5's one-card anchor: one streaming search step
    (engine, the chunk's top-k and the merge) timed on the device, a
    brute-force check of the streaming loop, and the streaming loop's
    walls on a database of 131,072 sequences: uploaded chunk by chunk,
    device-resident, and resident as one sweep with no host sync."""
    from swtpu_torch.core.scoring import DNA_111
    from swtpu_torch.ops.variants import best_engine
    from swtpu_torch.oracle import sw_score_batch
    from swtpu_torch.parallel.search import _ID_SENTINEL, _Step, all_vs_all_topk, to_keys

    env = _Env(quick, device, route)
    Nq, L, k = 16, _n(env, "sw_len"), 10
    C = _n(env, "search_chunk")
    rng = np.random.default_rng(10000)
    Q = rng.integers(0, 4, size=(Nq, L)).astype(np.uint8)
    T = rng.integers(0, 4, size=(C, L)).astype(np.uint8)
    engine = best_engine(DNA_111, env.dev)
    step = _Step(engine, Nq, L, C, L, k, k, C, False, False, env.dev)
    state = to_keys(torch.full((Nq, k), -1, dtype=torch.int32),
                    torch.full((Nq, k), _ID_SENTINEL, dtype=torch.int32)).to(env.dev)
    per = _time(lambda q, t, s: step(q, t, s, 0), (env.put(Q), env.put(T), state), env,
                k=16)
    pairs = Nq * C
    gcups = pairs * L * L / per / 1e9

    # parity: the streaming loop (a tail chunk) against brute force
    Tsub = T[: C - C // 4 + 3]
    sp, ip = all_vs_all_topk(Q, Tsub, DNA_111, k=k, chunk_size=C // 4, engine=engine,
                             device=env.dev)
    ref = np.stack([sw_score_batch(np.repeat(Q[i : i + 1], len(Tsub), 0), Tsub, DNA_111)
                    for i in range(Nq)])
    rids = np.arange(len(Tsub))[None, :].repeat(Nq, 0)
    order = np.lexsort((rids, -ref), axis=1)[:, :k]
    parity = bool(np.array_equal(ip, order) and np.array_equal(
        sp, np.take_along_axis(ref, order, axis=1).astype(np.int32)))
    rec = dict(
        kernel="search_step_fused", queries=Nq, chunk=C, topk=k,
        wall_ms=round(per * 1e3, 3),
        aln_per_s=round(pairs / per),
        gcups=round(gcups, 1), parity=parity,
        device=env.kind,
    )
    out = []
    _emit(rec, out, f"search_step_fused: {per*1e3:.3f} ms / {pairs} pairs "
                    f"= {pairs/per/1e6:.2f} M aln/s ({gcups:.1f} GCUPS), parity={parity}")

    Nt_e2e = _n(env, "search_targets")
    Ce2e = _n(env, "search_e2e_chunk")
    T2 = rng.integers(0, 4, size=(Nt_e2e, L)).astype(np.uint8)
    pairs_e2e = Nq * Nt_e2e

    def e2e(seed, **kw):
        walls = []
        for rep in range(3):  # a distinct query set a rep; the first warms
            Qr = np.random.default_rng(seed + rep).integers(0, 4, size=(Nq, L)).astype(
                np.uint8)
            wall, _ = _wall(lambda: all_vs_all_topk(
                Qr, T2, DNA_111, k=k, chunk_size=Ce2e, engine=engine, device=env.dev, **kw),
                env)
            if rep:
                walls.append(wall)
        return min(walls)

    wall = e2e(777, resident=False)
    rec = dict(
        kernel="search_e2e_wall", queries=Nq, targets=Nt_e2e,
        chunk=Ce2e, topk=k,
        wall_ms=round(wall * 1e3, 1),
        aln_per_s=round(pairs_e2e / wall),
        gcups=round(pairs_e2e * L * L / wall / 1e9, 1),
        device=env.kind,
    )
    _emit(rec, out, f"search_e2e_wall: {wall*1e3:.1f} ms / {pairs_e2e} pairs "
                    f"= {pairs_e2e/wall/1e6:.2f} M aln/s wall")

    wall2 = e2e(1777, resident=True)
    rec = dict(
        kernel="search_e2e_resident", queries=Nq, targets=Nt_e2e,
        chunk=Ce2e, topk=k,
        wall_ms=round(wall2 * 1e3, 1),
        aln_per_s=round(pairs_e2e / wall2),
        gcups=round(pairs_e2e * L * L / wall2 / 1e9, 1),
        packed_wire=True,
        note=("packed DB device-resident (uploaded once a call), chunks "
              "sliced on the device: zero per-chunk wire"),
        device=env.kind,
    )
    _emit(rec, out, f"search_e2e_resident: {wall2*1e3:.1f} ms / {pairs_e2e} pairs "
                    f"= {pairs_e2e/wall2/1e6:.2f} M aln/s wall")

    wall3 = e2e(2777, resident=True, max_retries=0)
    rec = dict(
        kernel="search_e2e_fused_sweep", queries=Nq, targets=Nt_e2e,
        chunk=Ce2e, topk=k,
        wall_ms=round(wall3 * 1e3, 1),
        aln_per_s=round(pairs_e2e / wall3),
        gcups=round(pairs_e2e * L * L / wall3 / 1e9, 1),
        packed_wire=True,
        note=("resident DB, every step queued behind the last with no host "
              "sync (max-throughput: no mid-sweep checkpoint windows)"),
        device=env.kind,
    )
    _emit(rec, out, f"search_e2e_fused_sweep: {wall3*1e3:.1f} ms / {pairs_e2e} "
                    f"pairs = {pairs_e2e/wall3/1e6:.2f} M aln/s wall")
    return out


def bench_map(quick=False, device=None, route=None):
    """Seed-and-extend read mapping end to end (``models.mapper``): the
    k-mer index (host), seeding (host), the batched banded extension
    (device); walls on fresh read sets after a warm one; quality = the
    fraction of reads mapped back to their true locus."""
    from swtpu_torch.core.encode import mutate
    from swtpu_torch.models.mapper import (
        _seed_rows, build_index, map_reads, map_reads_pipelined,
    )

    env = _Env(quick, device, route)
    kw = dict(min_score=20, device=env.dev, route="card" if env.card else "cpu")
    G = _n(env, "map_genome")
    R = _n(env, "map_reads")
    L = 152
    rng = np.random.default_rng(10000)
    genome = rng.integers(0, 4, size=G).astype(np.uint8)
    t0 = time.perf_counter()
    idx = build_index([genome], k=9)
    t_index = time.perf_counter() - t0

    def read_set(seed):
        r = np.random.default_rng(seed)
        starts = r.integers(0, G - L, size=R)
        reads = np.stack([mutate(r, genome[s : s + L], out_len=L) for s in starts])
        return reads, starts

    def n_correct(hits, starts):
        return sum(1 for i, h in enumerate(hits)
                   if h is not None and abs(h.pos - int(starts[i])) <= 32)

    sets = [read_set(s) for s in (1, 2, 3)]
    map_reads(sets[0][0], index=idx, **kw)  # warm
    walls, correct = [], 0
    for reads, starts in sets[1:]:
        wall, hits = _wall(lambda: map_reads(reads, index=idx, **kw), env)
        walls.append(wall)
        correct = n_correct(hits, starts)
    wall = min(walls)
    rec = dict(
        kernel="map_seed_extend", genome_bp=G, reads=R, read_len=L,
        index_s=round(t_index, 3), wall_ms=round(wall * 1e3, 1),
        reads_per_s=round(R / wall),
        correct_locus_frac=round(correct / R, 4),
        device=env.kind,
    )
    out = []
    _emit(rec, out, f"map_seed_extend: {wall*1e3:.1f} ms / {R} reads vs {G/1e6:.1f} "
                    f"Mbp = {R/wall/1e3:.1f} K reads/s (index {t_index:.2f} s, "
                    f"correct locus {correct/R:.1%})")

    # the host seeding alone (what the pipelined mapper overlaps)
    reads, starts = sets[-1]
    t0 = time.perf_counter()
    _seed_rows(reads, np.full(R, L, dtype=np.int64), idx, False, 2, 64, 8, 32)
    t_seed = time.perf_counter() - t0
    # the pipelined mapper: a worker thread seeds chunk i + 1 while the
    # device extends chunk i
    map_reads_pipelined(sets[0][0], index=idx, **kw)  # warm
    walls_p, hits_p = [], None
    for reads, starts in sets[1:]:
        wall_p, hits_p = _wall(lambda: map_reads_pipelined(reads, index=idx, **kw), env)
        walls_p.append(wall_p)
    wall_p = min(walls_p)
    correct_p = n_correct(hits_p, starts)
    rec = dict(
        kernel="map_seed_extend_pipelined", genome_bp=G, reads=R,
        read_len=L, chunk_reads=max(1024, -(-R // 2)),
        wall_ms=round(wall_p * 1e3, 1),
        reads_per_s=round(R / wall_p),
        seed_only_ms=round(t_seed * 1e3, 1),
        overlapped_ms=round((wall - wall_p) * 1e3, 1),
        correct_locus_frac=round(correct_p / R, 4),
        device=env.kind,
    )
    _emit(rec, out, f"map_seed_extend_pipelined: {wall_p*1e3:.1f} ms / {R} reads = "
                    f"{R/wall_p/1e3:.1f} K reads/s (seeding alone {t_seed*1e3:.0f} "
                    f"ms; overlap reclaimed {max(wall-wall_p,0)*1e3:.0f} ms)")
    return out


def _projection_ok(res, n_seqs):
    """The exact projection invariant: each row pair's induced alignment
    scores what the center-star NW gave it."""
    from swtpu_torch.models.msa import GAP

    ok = True
    for k in range(n_seqs):
        if k == res.center:
            continue
        ra, rb = res.rows[res.center], res.rows[k]
        keep = ~((ra == GAP) & (rb == GAP))
        a, b = ra[keep], rb[keep]
        both = (a != GAP) & (b != GAP)
        proj = int(np.where(a[both] == b[both], 2, -3).sum()) - 2 * int(
            ((a != GAP) ^ (b != GAP)).sum())
        ok &= proj == res.scores[k]
    return bool(ok)


def bench_msa(quick=False, device=None, route=None):
    """Center-star MSA end to end (``models.msa``): two batched NW calls
    on the device (the center pick over N(N-1)/2 pairs, the star) and the
    host's walks and merge; walls on fresh families after a warm one."""
    from swtpu_torch.core.encode import mutate
    from swtpu_torch.models.msa import msa_center_star

    env = _Env(quick, device, route)
    N = _n(env, "msa_seqs")
    L = _n(env, "msa_len")

    def family(seed):
        r = np.random.default_rng(seed)
        anc = r.integers(0, 4, size=L).astype(np.uint8)
        return [mutate(r, anc) for _ in range(N)]

    def msa(seqs):
        return msa_center_star(seqs, match=2, mismatch=3, gap=2, device=env.dev)

    fams = [family(s) for s in (1, 2, 3)]
    msa(fams[0])  # warm
    walls, ok = [], True
    for seqs in fams[1:]:
        wall, res = _wall(lambda: msa(seqs), env)
        walls.append(wall)
        ok &= _projection_ok(res, N)
    wall = min(walls)
    rec = dict(
        kernel="msa_center_star", n_seqs=N, seq_len=L,
        wall_ms=round(wall * 1e3, 1),
        seqs_per_s=round(N / wall, 1),
        projection_ok=bool(ok),
        device=env.kind,
    )
    out = []
    _emit(rec, out, f"msa_center_star: {wall*1e3:.1f} ms / {N} x {L}-mers "
                    f"(projection invariant {'ok' if ok else 'FAILED'})")

    N2 = _n(env, "msa_n256")
    if N2:
        # the scale record: the center pick scores N2 (N2 - 1) / 2 pairs
        r = np.random.default_rng(7)
        anc = r.integers(0, 4, size=L).astype(np.uint8)
        seqs = [mutate(r, anc) for _ in range(N2)]
        wall2, res = _wall(lambda: msa(seqs), env)
        ok2 = _projection_ok(res, N2)
        rec = dict(
            kernel="msa_center_star_n256", n_seqs=N2, seq_len=L,
            wall_ms=round(wall2 * 1e3, 1),
            pairs_scored=N2 * (N2 - 1) // 2,
            seqs_per_s=round(N2 / wall2, 1),
            projection_ok=ok2,
            device=env.kind,
        )
        _emit(rec, out, f"msa_center_star_n256: {wall2*1e3:.1f} ms / {N2} x "
                        f"{L}-mers (projection invariant {'ok' if ok2 else 'FAILED'})")
    return out


# -- the distributed curve --------------------------------------------------

def bench_dist(quick=False, device=None, route=None, cpu_mesh=8):
    """Weak scaling at 1..D ranks: data-parallel scores (dp), sharded
    all-vs-all top-k search (search) and the sequence-parallel long-pair
    sweep (sp); efficiency = (aligns/s at d) / (d * aligns/s at 1 rank).

    The anchor is a world of one on the device (NCCL on the card, records
    ``virtual=false``); the curve runs in ``torchrun`` gloo worlds of 1, 2,
    4, 8 CPU ranks (up to ``cpu_mesh``), records ``virtual=true``: the d
    ranks of a world share the host's cores (cores / d threads a rank), as
    JAX's virtual CPU devices do, so ``efficiency_vs_1dev`` measures the
    host's oversubscription, ``aggregate_efficiency`` ~1.0 a clean
    mechanism, and the fixed-work ratios whether the sharding adds work."""
    import torch.distributed as dist

    env = _Env(quick, device, route)
    # the anchor in the caller's world, or in a world of one started (and
    # ended) here
    started = not dist.is_initialized()
    try:
        anchor = _bench_dist_curve(env, virtual=False)[0]
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    results = []
    for rec in anchor:
        rec.pop("_rate")
        _emit(rec, results)
    sizes = [d for d in (1, 2, 4, 8) if d <= cpu_mesh]
    curve, fixed = [], {}
    for d in sizes:
        recs = _subprocess_records(
            ["--suite", "dist", "--cpu-mesh", str(d), "--device", "cpu"]
            + (["--quick"] if env.quick else []),
            launcher=[sys.executable, "-m", "torch.distributed.run", "--standalone",
                      "--nproc-per-node", str(d), "-m"], prefix=RANK_RECORD,
            env={"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // d))})
        fixed[d] = [r for r in recs if r["kernel"] == "dist_fixed_work"][0]
        curve += [r for r in recs if r["kernel"] != "dist_fixed_work"]
    results += _fill_efficiency(curve)
    if len(sizes) > 1:
        results += _fixed_work_records(fixed[1], fixed[sizes[-1]])
    return results


def _bench_dist_curve(env, virtual):
    """This world's weak-scaling records (efficiencies left to the
    caller, which holds the 1-rank anchor) and its fixed-work walls."""
    from swtpu_torch.core.scoring import DNA_10_30_15
    from swtpu_torch.ops.variants import best_engine
    from swtpu_torch.parallel.longpair import (
        _auto_block, _resolve_engine, _run_longpair, longpair_sw_score,
    )
    from swtpu_torch.parallel.mesh import data_parallel_scores, make_mesh
    from swtpu_torch.parallel.search import sharded_all_vs_all_topk

    params = DNA_10_30_15
    mesh = make_mesh(device=env.dev)
    spmesh = make_mesh(axis="sp", device=env.dev)
    d = mesh.size()
    rank = mesh.get_rank()
    per_dev_b = _n(env, "dist_pairs")
    n = m = _n(env, "sw_len")
    results = []
    engine = best_engine(params, env.dev)

    def dp_time(B):
        qs, ts = _inputs(B, n, m)
        run = lambda a, b: data_parallel_scores(a, b, params, mesh, engine=engine,  # noqa
                                                device=env.dev).to_local()
        return _time(run, (env.put(qs), env.put(ts)), env, k=4)

    # dp: the batch a rank constant (weak scaling)
    B = per_dev_b * d
    per_call = dp_time(B)
    aps = B / per_call
    results.append(dict(
        kernel="dist_dp_weak", devices=d, batch=B,
        alignments_per_s=round(aps, 1),
        gcups=round(B * n * m / per_call / 1e9, 2),
        efficiency_vs_1dev=1.0 if d == 1 else None,
        aggregate_efficiency=1.0 if d == 1 else None,
        comm_bytes_per_step=0,
        comm_pattern="none (pairs sharded, scores stay sharded)",
        physical_cores=os.cpu_count(),
        virtual=virtual,
        device=env.kind,
        _rate=aps,
    ))
    if rank == 0:
        print(f"dist_dp_weak[{d}dev]: {per_call*1e3:.2f} ms / {B}")

    # search: the database shard a rank constant
    nt_per = _n(env, "dist_targets")
    Nq = 8
    rng = np.random.default_rng(10000)
    Q = rng.integers(0, 4, size=(Nq, n)).astype(np.uint8)
    T = rng.integers(0, 4, size=(nt_per * d, m)).astype(np.uint8)
    sharded_all_vs_all_topk(Q, T, params, mesh, k=8, device=env.dev)  # warm
    wall, _ = _wall(lambda: sharded_all_vs_all_topk(Q, T, params, mesh, k=8,
                                                    device=env.dev), env)
    aps = Nq * len(T) / wall
    results.append(dict(
        kernel="dist_search_weak", devices=d, queries=Nq,
        targets=len(T), alignments_per_s=round(aps, 1),
        efficiency_vs_1dev=1.0 if d == 1 else None,
        aggregate_efficiency=1.0 if d == 1 else None,
        comm_bytes_per_device=2 * Nq * 8 * 4 * d,
        comm_pattern="all_gather of per-shard top-k (scores+ids)",
        physical_cores=os.cpu_count(),
        virtual=virtual,
        device=env.kind,
        _rate=aps,
    ))
    if rank == 0:
        print(f"dist_search_weak[{d}dev]: {wall*1e3:.1f} ms / {Nq*len(T)}")

    # sp (the long pair): the query grows with the world
    Lq = _n(env, "dist_qlen") * d
    Lt = _n(env, "dist_tlen")
    q1 = rng.integers(0, 4, size=Lq).astype(np.uint8)
    t1 = rng.integers(0, 4, size=Lt).astype(np.uint8)
    sp_engine = _resolve_engine("auto", env.dev)
    longpair_sw_score(q1, t1, params, spmesh, device=env.dev)  # warm
    wall, _ = _wall(lambda: longpair_sw_score(q1, t1, params, spmesh, device=env.dev), env)
    run_lp = lambda q_, t_: _run_longpair(q_, t_, params, spmesh, "sp", None,  # noqa
                                          device=env.dev)[:, 0]
    per_dev_sec = _time(run_lp, (env.put(q1), env.put(t1)), env, k=4)
    cps = Lq * Lt / per_dev_sec
    blk = _auto_block(Lq, Lt, d)
    nsteps = Lt // blk + d - 1
    results.append(dict(
        kernel="dist_longpair_weak", devices=d, shape=f"{Lq}x{Lt}",
        gcups=round(cps / 1e9, 2),
        efficiency_vs_1dev=1.0 if d == 1 else None,
        aggregate_efficiency=1.0 if d == 1 else None,
        engine=sp_engine,
        wall_ms=round(wall * 1e3, 1),
        honest_ms=round(per_dev_sec * 1e3, 2),
        pipeline_steps=nsteps,
        comm_bytes_per_device=nsteps * (blk + 1) * 4,
        comm_pattern="isend / irecv of the strip boundary row per step",
        physical_cores=os.cpu_count(),
        virtual=virtual, device=env.kind,
        _rate=cps,
    ))
    if rank == 0:
        print(f"dist_longpair_weak[{d}dev]: {wall*1e3:.1f} ms / {Lq}x{Lt}")

    # fixed total work (strong scaling): the dp batch and one long pair
    Bf = per_dev_b * 2
    Lqf = Ltf = _n(env, "dist_tlen")
    qf = rng.integers(0, 4, size=Lqf).astype(np.uint8)
    tf = rng.integers(0, 4, size=Ltf).astype(np.uint8)
    lp_wall = _time(lambda q_, t_: _run_longpair(q_, t_, params, spmesh, "sp", None,
                                                      device=env.dev)[:, 0],
                         (env.put(qf), env.put(tf)), env, k=4)
    fixed = dict(kernel="dist_fixed_work", devices=d, batch=Bf, dp_wall=dp_time(Bf),
                 shape=f"{Lqf}x{Ltf}", lp_wall=lp_wall,
                 lp_blocks=Ltf // _auto_block(Lqf, Ltf, d))
    return results, fixed


def _fill_efficiency(curve):
    """Fill each curve record's efficiencies from its 1-rank record's rate
    (``_rate``, unrounded, dropped from the records)."""
    anchor = {r["kernel"]: r["_rate"] for r in curve if r["devices"] == 1}
    out = []
    for r in curve:
        a, v, d = anchor.get(r["kernel"]), r.pop("_rate"), r["devices"]
        if a:
            r["efficiency_vs_1dev"] = round(v / (d * a), 3)
            r["aggregate_efficiency"] = round(v / a, 3)
        _emit(r, out)
    return out


def _fixed_work_records(one, hi):
    """The fixed-work shape checks: the same total work on the widest
    world against one rank (ideal ~1.0 on shared cores; longpair's ideal
    is its pipeline bubble (nb + d - 1) / nb)."""
    out = []
    d_hi = hi["devices"]
    ratio = hi["dp_wall"] / one["dp_wall"]
    rec = dict(
        kernel="dist_fixed_work_dp", devices=d_hi, batch=hi["batch"],
        wall_1dev_ms=round(one["dp_wall"] * 1e3, 2),
        wall_ddev_ms=round(hi["dp_wall"] * 1e3, 2),
        ratio=round(ratio, 3),
        ideal_ratio=1.0,
        sharding_clean=bool(ratio < 1.5),
        note=("fixed total work; on ranks sharing the host's cores ideal ~1.0 "
              "— a ratio >> 1 falsifies the dp sharding mechanism"),
        physical_cores=os.cpu_count(), virtual=True,
        device="cpu",
    )
    _emit(rec, out, f"dist_fixed_work_dp[{d_hi}dev]: ratio {ratio:.2f} (ideal 1.0)")
    ratio = hi["lp_wall"] / one["lp_wall"]
    nb = hi["lp_blocks"]
    ideal = (nb + d_hi - 1) / nb
    rec = dict(
        kernel="dist_fixed_work_longpair", devices=d_hi,
        shape=hi["shape"],
        wall_1dev_ms=round(one["lp_wall"] * 1e3, 2),
        wall_ddev_ms=round(hi["lp_wall"] * 1e3, 2),
        ratio=round(ratio, 3),
        ideal_ratio=round(ideal, 3),
        sharding_clean=bool(ratio < 2.0 * ideal),
        note=(f"fixed {hi['shape']} matrix; ideal = pipeline bubble factor "
              "(nb+d-1)/nb"),
        physical_cores=os.cpu_count(), virtual=True,
        device="cpu",
    )
    _emit(rec, out, f"dist_fixed_work_longpair[{d_hi}dev]: ratio {ratio:.2f} "
                    f"(ideal {ideal:.2f})")
    return out


def _dist_rank_main(env):
    """A rank of a ``torchrun`` gloo world (``--suite dist --cpu-mesh``):
    rank 0 prints the world's records and fixed-work walls."""
    import torch.distributed as dist

    from swtpu_torch.parallel.mesh import init_distributed

    init_distributed(device=env.dev)
    try:
        recs, fixed = _bench_dist_curve(env, virtual=True)
    finally:
        rank = dist.get_rank() if dist.is_initialized() else 0
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        for r in recs + [fixed]:
            print(RANK_RECORD + json.dumps(r))
    return []


# -- the driver -------------------------------------------------------------

def forever(variant_name: str, device=None):
    """An endless loop of one variant for an external profiler (nsys,
    ncu). Ctrl-C to stop."""
    from swtpu_torch.core.scoring import DNA_10_30_15
    from swtpu_torch.ops.variants import get_variant

    get_variant(variant_name)
    env = _Env(False, device)
    fn = _variant(variant_name, DNA_10_30_15, env)
    qs, ts = _inputs(_n(env, "forever_pairs"), 128, 128)
    dq, dts = env.put(qs), env.put(ts)
    i = 0
    while True:
        fn(dq, dts)
        env.sync()
        i += 1
        if i % 100 == 0:
            print(i, flush=True)


def variance_summary(runs):
    """Merge N runs' records into per-kernel rows: for every numeric perf
    field its min / median / spread (max - min over the median). The MIN
    is the quotable figure (noise only adds time)."""
    perf_fields = (
        "wall_ms", "wall_ms_per_1m", "ms_per_1m", "gcups", "band_gcups",
        "alignments_per_s", "reads_per_s", "device_fwd_walk_plus_fetch_ms",
        "host_decode_ms",
    )
    by_kernel = {}
    for run in runs:
        for rec in run:
            by_kernel.setdefault(rec.get("kernel", "?"), []).append(rec)
    out = []
    for kernel, recs in by_kernel.items():
        row = dict(kernel=kernel, runs=len(recs))
        for f in perf_fields:
            vals = [r[f] for r in recs if isinstance(r.get(f), (int, float))]
            if not vals:
                continue
            med = float(np.median(vals))
            row[f + "_min"] = min(vals)
            row[f + "_median"] = round(med, 3)
            row[f + "_spread"] = (
                round((max(vals) - min(vals)) / med, 4) if med else None
            )
        out.append(row)
        print("VARIANCE:", json.dumps(row))
    return out


#: section -> its function, in the order ``--suite all`` runs them
BENCHES = {
    "sw": bench_sw_variants,
    "semiglobal": bench_semiglobal,
    "semiglobal_full": bench_semiglobal_full,
    "affine": bench_affine,
    "protein": bench_protein,
    "swissprot": bench_protein_swissprot,
    "varlen": bench_varlen,
    "search": bench_search,
    "map": bench_map,
    "msa": bench_msa,
    "unpack": bench_unpack,
}


def expected_kernels(suite="all", card=True, quick=False, cpu_mesh=8):
    """The ``kernel`` names, in order, a run of ``suite`` emits at this
    size table: JAX's names for a TPU (``card``) or for its CPU backend
    (``dist``: the anchor, each world of the curve up to ``cpu_mesh``
    ranks, the fixed-work pair)."""
    from swtpu_torch.ops.variants import VARIANTS

    q = 1 if quick else 0
    size = {k: v[q] for k, v in SIZES.items()}
    names = {}
    names["sw"] = [f"sw_{p}_{v}" for p in ("10_-30_15", "111") for v in VARIANTS]
    band = ["banded_xdrop_32_70_xla"]
    if card:
        band += ["banded_xdrop_32_70_pallas", "banded_xdrop_blosum62_affine_pallas",
                 "banded_xdrop_32_70_packed", "banded_affine_xdrop_32_70_packed",
                 "banded_xdrop_early_exit_packed"]
        B = size["band_pairs"]
        band += [f"banded_block_w64_k32_b{B}", f"banded_block_w64_k64_b{B}",
                 f"banded_block_w64_k64_b{size['block_wide_pairs']}",
                 "banded_block_affine_w64_k64", "banded_block_blosum62_w64_k64",
                 "banded_fixed_rowscan_w32"]
        band += ["banded_fixed_1m_128x128_w32"] if size["fixed_1m_pairs"] else []
        band += ["banded_fixed_affine_rowscan_w32"]
    else:
        band += ["banded_affine_xdrop_32_70_xla"]
    k16 = ["banded_16k_traceback_e2e"]
    if card:
        k16 += [f"banded_block_16k_traceback_e2e_b{b}"
                for b in (size["b16"], size["b16_wide"]) if b]
    names["semiglobal16k"] = k16
    names["semiglobal"] = band + k16
    names["semiglobal_full"] = ["semiglobal_xla_diag"] + (
        ["semiglobal_rowscan", "semiglobal_prof_blosum62_affine"] if card else [])
    names["affine"] = ["affine_xla_diag"] + (["affine_rowscan"] if card else [])
    names["protein"] = ["protein_blosum62_best", "protein_blosum62_affine_best"]
    names["swissprot"] = [f"protein_swissprot_{e}_{g}" for g in ("linear11", "gotoh11_1")
                          for e in (("colscan", "rowscan_prof") if card else ("colscan",))]
    names["varlen"] = ["varlen_reads_bucketed", "varlen_wire_floor",
                       "varlen_device_resident", "varlen_promoted_bf16_int32",
                       "varlen_promoted_device_resident", "varlen_traceback_sample"]
    names["search"] = ["search_step_fused", "search_e2e_wall", "search_e2e_resident",
                       "search_e2e_fused_sweep"]
    names["map"] = ["map_seed_extend", "map_seed_extend_pipelined"]
    names["msa"] = ["msa_center_star"] + (["msa_center_star_n256"] if size["msa_n256"]
                                          else [])
    names["unpack"] = ["unpack_2bit_host", "unpack_2bit_device"]
    weak = ["dist_dp_weak", "dist_search_weak", "dist_longpair_weak"]
    sizes = [d for d in (1, 2, 4, 8) if d <= cpu_mesh]
    names["dist"] = weak * (1 + len(sizes)) + (
        ["dist_fixed_work_dp", "dist_fixed_work_longpair"] if len(sizes) > 1 else [])
    if suite == "all":
        return [k for s in BENCHES for k in names[s]]
    return names[suite]


def add_arguments(ap):
    """The suite's options (``python -m swtpu_torch bench`` takes them too)."""
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--runs", type=int, default=1, metavar="N",
        help="repeat the suite N times and append per-kernel "
        "min/median/spread variance rows",
    )
    ap.add_argument("--forever", default=None, metavar="VARIANT")
    ap.add_argument("--suite", default="all", choices=SUITES)
    ap.add_argument(
        "--cpu-mesh", type=int, default=None, metavar="N",
        help="the dist suite's curve: gloo worlds of CPU ranks up to N (a "
        "rank of such a world when started by torchrun)",
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the suite runs (default: the card; cpu: the "
                    "plain tiers, for tests)")
    ap.add_argument("--launches", default=None, metavar="PATH",
                    help="write the kernels' launch counts of the run, by "
                    "record, to PATH as JSON")
    return ap


def build_parser():
    return add_arguments(argparse.ArgumentParser(prog="swtpu_torch.bench_suite"))


def main(argv=None):
    global _last_counts
    args = build_parser().parse_args(argv)
    if os.environ.get(SIZES_ENV):
        SIZES.update({k: tuple(v) for k, v in json.loads(os.environ[SIZES_ENV]).items()})
    env = _Env(args.quick, args.device)  # raises without a card
    if env.dev.type == "cuda":  # every kernel at once: one nvcc a source
        from swtpu_torch.kernels import _build

        _build.build_all(_build.SOURCES)
    if args.forever:
        forever(args.forever, env.dev)
        return
    LAUNCHES.clear()  # the launches file holds this run's alone
    _last_counts = launch_counts()
    torchrun_rank = "LOCAL_RANK" in os.environ and args.suite == "dist" and args.cpu_mesh

    def one_run():
        if args.suite == "dist":
            if torchrun_rank:
                return _dist_rank_main(env)
            return bench_dist(args.quick, env.dev, cpu_mesh=args.cpu_mesh or 8)
        if args.suite == "semiglobal16k":  # the fresh-process 16K section
            return bench_semiglobal_16k(args.quick, env.dev)
        results = []
        for name, fn in BENCHES.items():
            if args.suite in ("all", name):
                t0 = time.perf_counter()
                results += fn(args.quick, env.dev)
                print(f"# section {name}: {time.perf_counter() - t0:.1f} s wall",
                      file=sys.stderr, flush=True)
        return results

    runs = []
    for r in range(args.runs):
        if args.runs > 1:
            print(f"=== run {r + 1}/{args.runs} ===")
        runs.append(one_run())
    results = [rec for run in runs for rec in run]
    if args.runs > 1:
        results += variance_summary(runs)
    if args.launches:
        with open(args.launches, "w") as f:
            json.dump({"by_record": LAUNCHES}, f)
    if torchrun_rank:
        return
    json.dump(results, sys.stdout, indent=1)
    print()
    bad = [r["kernel"] for r in results
           if any(r.get(f) is False for f in PARITY_FIELDS)]
    if bad:
        print(f"bench_suite: parity false in {bad}", file=sys.stderr)


if __name__ == "__main__":
    main()
