"""Build the CUDA sources with nvcc at first use and load them with ctypes.

Each source under ``swtpu_torch/csrc/`` has a plain ``extern "C"``
interface and includes no PyTorch header, so nvcc compiles it in seconds
into a shared library under ``swtpu_torch/_build/`` (listed in
.gitignore), named by the hash of the source, the ``csrc/`` headers it
includes (``#include "..."``) and the flags: an edited source or header
builds anew, an unchanged one loads from disk. ``-Xptxas -v``
makes nvcc report each kernel's registers, spills and shared memory; the
report is kept beside the library (``build_log``).

There is no fallback: with no nvcc, a failed build or a failed load the
call raises. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: every CUDA source of the port: the row-scan (uniform scoring), the
#: profile (general matrix), the bf16 tier, semi-global / global, the
#: fixed band, the per-round adaptive band (warp and wide forms), the block
#: tier (gather and rows), the banded device walkers, the long-pair strip
#: tile, the wavefront schedule and the general local engine (any scoring
#: the plain tier takes)
SOURCES = ("sw_rowscan.cu", "sw_profile.cu", "sw_bf16.cu", "sw_semiglobal.cu",
           "sw_banded.cu", "sw_xdrop.cu", "sw_block.cu", "sw_walk.cu",
           "sw_strip.cu", "sw_wavefront.cu", "sw_general.cu")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # optimise a source's kernels on several threads (sw_block.cu has 60)
    "--split-compile=0",
]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
    )


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC / source
    text = src.read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', text, re.M)
    digest = hashlib.sha256(
        text + b"".join((CSRC / h.decode()).read_bytes() for h in headers)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all(sources: Iterable[str]) -> Dict[str, Path]:
    """Build every missing library, one nvcc process per source, all
    started together. Returns {source: library path}; raises on the first
    failed compile, with nvcc's output."""
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for s, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs[s] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    failed = []
    for s, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {s} (rc {proc.returncode}):\n{out}")
            continue
        p = paths[s]
        p.with_suffix(".log").write_text(out)
        os.replace(tmp, p)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(source: str) -> str:
    """nvcc's report (``-Xptxas -v``) for the library of ``source``."""
    return library_path(source).with_suffix(".log").read_text()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    lib = _libs.get(source)
    if lib is None:
        path = build_all([source])[source]
        lib = ctypes.CDLL(str(path))
        lib.swtpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.swtpu_cuda_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.swtpu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
