"""The port's C++ host code: traceback walkers, the device walk's wire
decoder, the mapper's seeding twin and the 2-bit codec.

Port of ``swtpu/native/``: ``src/swnative.cpp`` is the JAX package's
source as it stands, built with g++ at first use into
``swtpu_torch/_build/`` (listed in .gitignore) with the same flags (and
OpenMP where the toolchain has it) and bound with ctypes, with the same
signatures. Each function gives what its numpy twin in
``swtpu_torch/oracle`` / ``swtpu_torch/core/encode.py`` gives; the walk
sites of ``batch/traceback.py``, ``batch/lowmem.py`` and
``kernels/banded_scan.py`` call them wherever the JAX package calls its
own.

There is no quiet fallback: a failed build raises with g++'s output, so
a walk is never a numpy walk in disguise. ``available()`` builds the
library (raising if it cannot) and says True; the walk sites consult it,
so replacing it (a test's monkeypatch) selects the numpy walkers.

The full-matrix walkers (local, semi-global under a matrix, the fixed
band, the low-memory walk) compute every cell, so a code outside the
matrix would index it out of bounds: their bindings raise IndexError
there, as the numpy walkers do (ROADMAP.md queue C, in-length pads).
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "swnative.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def _target() -> str:
    """What ``-march=native`` means on this host (part of the library's
    name, so a library built for another CPU is never loaded)."""
    out = subprocess.run(
        ["g++", "-march=native", "-Q", "--help=target"],
        capture_output=True, text=True, check=True,
    ).stdout
    return next((ln.split()[-1] for ln in out.splitlines()
                 if ln.strip().startswith("-march=")), "")


def library_path() -> Path:
    """Where the library lives: named by the hash of the source, the
    flags and the host's target."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode() + _target().encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libswnative-{digest}.so"


def build() -> Path:
    """Build the library unless it is built; raises RuntimeError with
    g++'s output when neither the OpenMP build nor the serial one
    compiles."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    errors = []
    # OpenMP parallelizes the per-read seeding loop; a toolchain without
    # libgomp builds the serial library
    for extra in (["-fopenmp"], []):
        try:
            proc = subprocess.run(
                ["g++", *extra, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                capture_output=True, text=True,
            )
        except OSError as e:  # no g++ at all
            raise RuntimeError(f"g++ could not run: {e}") from e
        if proc.returncode == 0:
            os.replace(tmp, path)
            return path
        errors.append(f"g++ {' '.join(extra + GXX_FLAGS)} (rc {proc.returncode}):\n"
                      f"{proc.stderr}")
    raise RuntimeError("the native walkers failed to build:\n" + "\n".join(errors))


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32

    lib.sw_pack_2bit.argtypes = [i8p, i64, i8p]
    lib.sw_unpack_2bit.argtypes = [i8p, i64, i8p]
    lib.sw_traceback.restype = i64
    lib.sw_traceback.argtypes = [i8p, i64, i8p, i64, i32p, i32, i32, i32p, i32p]
    lib.banded_static_traceback.restype = i64
    lib.banded_static_traceback.argtypes = [
        i8p, i64, i8p, i64, i32p, i32, i32, i32, i32, i32p, i32p,
    ]
    lib.sw_affine_traceback.restype = i64
    lib.sw_affine_traceback.argtypes = [
        i8p, i64, i8p, i64, i32p, i32, i32, i32, i32p, i32p,
    ]
    lib.semiglobal_traceback.restype = i64
    lib.semiglobal_traceback.argtypes = [
        i8p, i64, i8p, i64, i32, i32, i32, i32, i32p, i32p,
    ]
    lib.semiglobal_traceback_matrix.restype = i64
    lib.semiglobal_traceback_matrix.argtypes = [
        i8p, i64, i8p, i64, i32p, i32, i32, i32, i32p, i32p,
    ]
    lib.semiglobal_affine_traceback.restype = i64
    lib.semiglobal_affine_traceback.argtypes = [
        i8p, i64, i8p, i64, i32p, i32, i32, i32, i32, i32p, i32p,
    ]
    lib.banded_traceback.restype = i64
    lib.banded_traceback.argtypes = [
        i8p, i64, i8p, i64, i32p, i32p, i64, i64, i32, i32p, i32, i32, i32, i32p,
    ]
    lib.banded_affine_traceback.restype = i64
    lib.banded_affine_traceback.argtypes = [
        i8p, i64, i8p, i64, i32p, i32p, i64, i64, i32, i32p, i32, i32, i32, i32,
        i32p,
    ]
    lib.sw_traceback_lowmem.restype = i64
    lib.sw_traceback_lowmem.argtypes = [
        i8p, i64, i8p, i64, i32p, i32, i32, i32, i64, i64, i32, i32p, i32p,
    ]
    lib.seed_candidates.restype = i64
    lib.seed_candidates.argtypes = [
        i64p, i64, i64, i64, i32p, i32p, i64, i64, i64, i64, i64p, i64p, i32p,
    ]
    lib.decode_move_wire.restype = i64
    lib.decode_move_wire.argtypes = [i8p, i64, i64, i32p, i32p, i32p, i64]
    _lib = lib
    return lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    return _get_lib() is not None


def _u8(a):
    a = np.ascontiguousarray(a, dtype=np.uint8)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(a):
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(a):
    a = np.ascontiguousarray(a, dtype=np.int64)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _matrix(matrix, *codes):
    """The matrix as int32 [A * A] with its A; IndexError when a code of
    ``codes`` lies outside it (a full-matrix walk would read past it)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.int32)
    A = matrix.shape[0]
    for c in codes:
        if len(c) and int(c.max()) >= A:
            raise IndexError(
                f"code {int(c.max())} is outside the {A} x {A} scoring matrix"
            )
    mat, mp = _i32(matrix.reshape(-1))
    return mat, mp, A


def _uniform_matrix_for(q, t, match, mismatch) -> np.ndarray:
    """Uniform match/mismatch as a matrix sized to the observed alphabet
    (the C++ walkers index matrix[q*A + t], and the uniform contract is
    any-alphabet: score = match iff chars equal)."""
    A = int(max(4, (int(q.max()) + 1) if len(q) else 4,
                (int(t.max()) + 1) if len(t) else 4))
    m = np.full((A, A), -int(mismatch), dtype=np.int32)
    np.fill_diagonal(m, int(match))
    return m


def _path(path, ln, what):
    if ln < 0:
        raise AssertionError(f"inconsistent native {what}")
    return [tuple(map(int, p)) for p in path[: 2 * ln].reshape(-1, 2)]


def _path_buffer(n, m, extra=2):
    path = np.empty(2 * (n + m + extra), np.int32)
    return path, path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def pack_2bit(seq: np.ndarray) -> np.ndarray:
    lib = _get_lib()
    seq, sp = _u8(np.asarray(seq).reshape(-1))
    out = np.empty(len(seq) // 4, np.uint8)
    lib.sw_pack_2bit(sp, len(seq), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def unpack_2bit(packed: np.ndarray) -> np.ndarray:
    lib = _get_lib()
    packed, pp = _u8(np.asarray(packed).reshape(-1))
    out = np.empty(len(packed) * 4, np.uint8)
    lib.sw_unpack_2bit(pp, len(packed), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def sw_traceback(
    q: np.ndarray, t: np.ndarray, matrix: np.ndarray, gap: int
) -> Tuple[int, List[Tuple[int, int]]]:
    """Local linear-gap walk over the full matrix (twin of
    ``oracle.sw.sw_traceback``)."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    mat, mp, A = _matrix(matrix, q, t)
    path, pp = _path_buffer(len(q), len(t))
    score = ctypes.c_int32(0)
    ln = lib.sw_traceback(qp, len(q), tp, len(t), mp, int(A), int(gap), pp,
                          ctypes.byref(score))
    return int(score.value), _path(path, ln, "traceback")


def banded_static_traceback(
    q: np.ndarray, t: np.ndarray, matrix: np.ndarray, gap_open: int,
    gap_extend: int, bandwidth: int = 32,
) -> Tuple[int, List[Tuple[int, int]]]:
    """Fixed-band walk (linear when gap_open == gap_extend, else Gotoh;
    twin of ``oracle.banded_static.sw_banded_static_traceback``)."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    mat, mp, A = _matrix(matrix, q, t)
    path, pp = _path_buffer(len(q), len(t))
    score = ctypes.c_int32(0)
    ln = lib.banded_static_traceback(
        qp, len(q), tp, len(t), mp, int(A), int(gap_open), int(gap_extend),
        int(bandwidth), pp, ctypes.byref(score),
    )
    return int(score.value), _path(path, ln, "fixed-band traceback")


def sw_affine_traceback(
    q: np.ndarray, t: np.ndarray, matrix: np.ndarray, gap_open: int,
    gap_extend: int,
) -> Tuple[int, List[Tuple[int, int]]]:
    """Local Gotoh walk over the full matrix (twin of
    ``oracle.affine.sw_affine_traceback``)."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    mat, mp, A = _matrix(matrix, q, t)
    path, pp = _path_buffer(len(q), len(t))
    score = ctypes.c_int32(0)
    ln = lib.sw_affine_traceback(
        qp, len(q), tp, len(t), mp, int(A), int(gap_open), int(gap_extend), pp,
        ctypes.byref(score),
    )
    return int(score.value), _path(path, ln, "affine traceback")


def sw_traceback_lowmem(
    q: np.ndarray, t: np.ndarray, matrix: np.ndarray, gap_open: int,
    gap_extend: int, ends: Optional[Tuple[int, int]] = None, row_block: int = 512,
) -> Tuple[int, List[Tuple[int, int]]]:
    """Checkpointed low-memory local walk (twin of
    ``batch.lowmem.sw_traceback_lowmem``; the C++ serial recurrences are
    exact for any gap model, the caller keeps the numpy walker's guard)."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    mat, mp, A = _matrix(matrix, q, t)
    ei, ej = (-1, -1) if ends is None else (int(ends[0]), int(ends[1]))
    path, pp = _path_buffer(len(q), len(t))
    score = ctypes.c_int32(0)
    ln = lib.sw_traceback_lowmem(
        qp, len(q), tp, len(t), mp, int(A), int(gap_open), int(gap_extend), ei,
        ej, int(row_block), pp, ctypes.byref(score),
    )
    return int(score.value), _path(path, ln, "lowmem traceback")


def semiglobal_traceback(
    q: np.ndarray, t: np.ndarray, match: int, mismatch: int, gap: int,
    pin_end: bool = False,
) -> Tuple[int, List[Tuple[int, int]]]:
    """Uniform linear-gap semi-global walk (twin of
    ``oracle.semiglobal.semiglobal_full``); ``pin_end`` pins the endpoint
    at the (n, m) corner: global (twin of ``oracle.semiglobal.nw_full``)."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    path, pp = _path_buffer(len(q), len(t))
    score = ctypes.c_int32(0)
    ln = lib.semiglobal_traceback(
        qp, len(q), tp, len(t), int(match), int(mismatch), int(gap),
        int(pin_end), pp, ctypes.byref(score),
    )
    return int(score.value), _path(path, ln, "semiglobal traceback")


def semiglobal_traceback_matrix(
    q: np.ndarray, t: np.ndarray, matrix: np.ndarray, gap: int,
    pin_end: bool = False,
) -> Tuple[int, List[Tuple[int, int]]]:
    """General-matrix linear-gap semi-global walk (twin of
    ``oracle.semiglobal.semiglobal_full`` with ``matrix=``); ``pin_end``:
    global."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    mat, mp, A = _matrix(matrix, q, t)
    path, pp = _path_buffer(len(q), len(t))
    score = ctypes.c_int32(0)
    ln = lib.semiglobal_traceback_matrix(
        qp, len(q), tp, len(t), mp, int(A), int(gap), int(pin_end), pp,
        ctypes.byref(score),
    )
    return int(score.value), _path(path, ln, "semiglobal matrix traceback")


def semiglobal_affine_traceback(
    q: np.ndarray, t: np.ndarray, matrix: np.ndarray, gap_open: int,
    gap_extend: int, pin_end: bool = False,
) -> Tuple[int, List[Tuple[int, int]]]:
    """Gotoh semi-global walk (twin of
    ``oracle.semiglobal.semiglobal_affine_full``); ``pin_end``: global
    (twin of ``oracle.semiglobal.nw_affine_full``)."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    mat, mp, A = _matrix(matrix, q, t)
    path, pp = _path_buffer(len(q), len(t))
    score = ctypes.c_int32(0)
    ln = lib.semiglobal_affine_traceback(
        qp, len(q), tp, len(t), mp, int(A), int(gap_open), int(gap_extend),
        int(pin_end), pp, ctypes.byref(score),
    )
    return int(score.value), _path(path, ln, "affine semiglobal traceback")


def banded_traceback(
    q: np.ndarray, t: np.ndarray, band_history: np.ndarray, pos_y: np.ndarray,
    n_rounds: int, max_round: int, max_score_off: int, match: int = 1,
    mismatch: int = 1, gap: int = 1, bandwidth: int = 32, matrix=None,
) -> List[Tuple[int, int]]:
    """Linear walk over a per-round band history (twin of
    ``batch.traceback.banded_traceback``)."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    hist, hp = _i32(band_history[:n_rounds])
    py, pyp = _i32(pos_y[:n_rounds])
    if matrix is None:
        matrix = _uniform_matrix_for(q, t, match, mismatch)
    mat, mp, A = _matrix(matrix)
    path, pp = _path_buffer(len(q), len(t), 2 * bandwidth + 4)
    ln = lib.banded_traceback(
        qp, len(q), tp, len(t), hp, pyp, int(n_rounds), int(max_round),
        int(max_score_off), mp, int(A), int(gap), int(bandwidth), pp,
    )
    return _path(path, ln, "banded traceback")


def banded_affine_traceback(
    q: np.ndarray, t: np.ndarray, band_history: np.ndarray, pos_y: np.ndarray,
    n_rounds: int, max_round: int, max_score_off: int, match: int, mismatch: int,
    gap_open: int, gap_extend: int, bandwidth: int = 32, matrix=None,
) -> List[Tuple[int, int]]:
    """Gotoh walk over a per-round band history, E/F rebuilt in C++ (twin
    of ``batch.traceback.banded_affine_traceback``)."""
    lib = _get_lib()
    q, qp = _u8(q)
    t, tp = _u8(t)
    hist, hp = _i32(band_history[:n_rounds])
    py, pyp = _i32(pos_y[:n_rounds])
    if matrix is None:
        matrix = _uniform_matrix_for(q, t, match, mismatch)
    mat, mp, A = _matrix(matrix)
    path, pp = _path_buffer(len(q), len(t), 2 * bandwidth + 4)
    ln = lib.banded_affine_traceback(
        qp, len(q), tp, len(t), hp, pyp, int(n_rounds), int(max_round),
        int(max_score_off), mp, int(A), int(gap_open), int(gap_extend),
        int(bandwidth), pp,
    )
    return _path(path, ln, "affine banded traceback")


def decode_move_wire(wire: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode the device walkers' 2-bit move wire (twin of the numpy path
    of ``kernels.banded_scan.decode_device_walk``).

    wire: [B, row_bytes] uint8, 20 bytes of meta + packed moves a pair.
    Returns (scores int32 [B], path_len int32 [B], paths int32
    [B, max_points, 2]), paths start -> end and zero past each pair's
    path_len. Raises AssertionError on an unset ok flag.
    """
    lib = _get_lib()
    wire, wp = _u8(wire)
    B, row_bytes = wire.shape
    stride = 4 * (row_bytes - 20) + 1  # max path points
    scores = np.empty(B, np.int32)
    plen = np.empty(B, np.int32)
    paths = np.zeros((B, stride, 2), np.int32)
    rc = lib.decode_move_wire(
        wp, B, row_bytes,
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        plen.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        stride,
    )
    if rc < 0:
        raise AssertionError(f"inconsistent device banded traceback at pair {-rc - 1}")
    return scores, plen, paths


def seed_candidates(
    qcodes: np.ndarray, csr: np.ndarray, pos: np.ndarray, L: int, dw: int,
    max_occ: int, min_seeds: int, max_loci: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The mapper's seeding and diagonal clustering (twin of the JAX
    package's ``models.mapper.find_candidates``), OpenMP across reads.
    qcodes: [R, nk] int64 (-1 invalid), csr: the index's direct-addressed
    int32 row starts, pos: int32 positions ordered by code. Returns
    (read, anchor, n_seeds) int64 arrays."""
    lib = _get_lib()
    qcodes, qp = _i64(qcodes)
    csr, cp = _i32(csr)
    pos, pp = _i32(pos)
    R, nk = qcodes.shape
    out_anchor = np.empty(R * max_loci, np.int64)
    out_nseeds = np.empty(R * max_loci, np.int64)
    out_cnt = np.zeros(R, np.int32)
    lib.seed_candidates(
        qp, R, nk, int(L), cp, pp, int(dw), int(max_occ), int(min_seeds),
        int(max_loci),
        out_anchor.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_nseeds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    read = np.repeat(np.arange(R, dtype=np.int64), out_cnt)
    keep = (np.arange(max_loci)[None, :] < out_cnt[:, None]).reshape(-1)
    return read, out_anchor[keep], out_nseeds[keep]
