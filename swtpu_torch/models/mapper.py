"""Seed-and-extend read mapping on the banded kernels.

Port of ``swtpu/models/mapper.py``: the index and the seeding are host
work (numpy, or the C++ seeder of ``swtpu_torch.native``), the screening
of every candidate locus is one batched kernel call, and the winners'
paths come from the banded family's traceback engines.

1. **Index** (host): sorted k-mer table over the reference, contigs
   joined by runs of the target pad code (5), so no k-mer spans a
   boundary and extensions lose at every separator column.
2. **Seed** (host): every read k-mer is looked up; hits become (read,
   diagonal) seeds, repeats above ``max_occ`` are dropped, seeds are
   clustered by quantized diagonal and clusters with >= ``min_seeds``
   seeds become candidate loci.
3. **Extend** (device, batched): each locus is the read against a
   reference window anchored at the cluster's earliest-seed diagonal.
4. **Traceback** (winners only): the winning locus of each read re-runs
   through a traceback engine when a path is asked for.

The route. One function, :func:`_route`, picks it from the device type,
and the pieces (:func:`extend_candidates`, :func:`map_reads`) take it as
``route=`` so that the card's route can run on the CPU's plain tiers:

- ``"card"`` (a CUDA device): ``extend="auto"`` screens in the fixed
  corridor (``kernels/sw_banded.py``, row 10), pure-ACGT reads on the
  2-bit wire (``kernels/unpack.py`` decodes on the device, the index's
  separator bitmask restores the target pad); linear winners walk on the
  block tier (``banded_block_align_device``: B9 forward, device walk)
  when its geometry takes width 2W and block W (2W a multiple of 16, 3W
  <= 129), every other winner on ``banded_align_batch`` (the per-round
  kernel, row 14/15, and the host walk). This is the TPU's route in the
  JAX package, which the kernels were built for.
- ``"cpu"``: the JAX package's route off the TPU, so results are
  bit-equal to ``swtpu`` on the CPU: ``"auto"`` screens with the
  per-round X-drop band and every winner walks on ``banded_align_batch``.

The rule is decided from shapes before anything launches; no launch
failure is caught. Bandwidths the per-round kernel does not take raise
NotImplementedError on the card, naming their ROADMAP item.

gap_open == gap_extend is linear: :func:`map_reads` collapses it once to
``gap`` (the JAX package's off-TPU traceback passes ``gap`` twice there
and raises TypeError).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from swtpu_torch.kernels.banded_batch import _gaps
from swtpu_torch.utils.device import resolve_device

#: Reference separator/pad: the DNA target pad code (pads can only lose).
REF_PAD = 5
#: block + width of the block tier's gather window (kernels/banded_block.py)
BLOCK_WINDOW = 129


# ---------------------------------------------------------------------------
# 1. Index


@dataclasses.dataclass
class KmerIndex:
    """Sorted k-mer table over a (concatenated) reference."""

    k: int
    ref: np.ndarray  # [N] uint8 concatenated reference (REF_PAD separators)
    codes: np.ndarray  # [P] int64 k-mer codes, sorted
    #: [P] positions ordered by code: int32 unless the reference exceeds
    #: int32 range
    pos: np.ndarray
    contig_starts: np.ndarray  # [C] int64 offset of each contig in ref
    contig_names: List[str]
    contig_lens: np.ndarray  # [C] int64
    #: direct-addressed int32 CSR row starts ([4^k + 1]) when k <= 11
    starts: Optional[np.ndarray] = None
    #: 2-bit packed ref (length rounded to 8; separators pack as base 0,
    #: see ref_sepmask): the screening gathers packed window bytes
    ref_packed: Optional[np.ndarray] = None
    #: 1 bit per char (little-endian), set where ref holds a separator or
    #: pad (> 3): the device restores the target pad there
    ref_sepmask: Optional[np.ndarray] = None

    def locate(self, ref_pos: np.ndarray):
        """Map concatenated positions -> (contig_id, local_pos)."""
        p = np.asarray(ref_pos, dtype=np.int64)
        cid = np.searchsorted(self.contig_starts, p, side="right") - 1
        return cid, p - self.contig_starts[cid]


def _kmer_codes(rows: np.ndarray, k: int) -> np.ndarray:
    """[.., L] uint8 -> [.., L-k+1] int64 base-4 codes; windows containing
    any char >= 4 (pads/separators) get code -1."""
    rows = np.asarray(rows)
    L = rows.shape[-1]
    n = L - k + 1
    if n <= 0:
        return np.full(rows.shape[:-1] + (0,), -1, dtype=np.int64)
    codes = np.zeros(rows.shape[:-1] + (n,), dtype=np.int64)
    bad = np.zeros(rows.shape[:-1] + (n,), dtype=bool)
    for j in range(k):
        c = rows[..., j : j + n].astype(np.int64)
        codes = (codes << 2) | (c & 3)
        bad |= c >= 4
    return np.where(bad, -1, codes)


def build_index(
    contigs: Sequence[np.ndarray],
    names: Optional[Sequence[str]] = None,
    k: int = 13,
    lens: Optional[Sequence[int]] = None,
) -> KmerIndex:
    """Build the sorted k-mer table. ``contigs`` are uint8 code arrays
    (0..3); ``lens`` trims padded rows (e.g. from load_fasta_batch)."""
    from swtpu_torch.core.encode import pack_2bit

    names = (
        list(names) if names is not None
        else [f"contig{i}" for i in range(len(contigs))]
    )
    sep = np.full(k, REF_PAD, dtype=np.uint8)
    parts, starts, clens = [], [], []
    off = 0
    for i, c in enumerate(contigs):
        c = np.asarray(c, dtype=np.uint8)
        if lens is not None:
            c = c[: int(lens[i])]
        starts.append(off)
        clens.append(len(c))
        parts.append(c)
        parts.append(sep)
        off += len(c) + k
    ref = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    codes = _kmer_codes(ref, k)
    valid = np.nonzero(codes >= 0)[0]
    order = valid[np.argsort(codes[valid], kind="stable")]
    sorted_codes = codes[order]
    csr = None
    small = len(ref) < 2**31 - 1 and len(order) < 2**31 - 1
    if k <= 11:  # 4^11 + 1 entries = 16 MB of int32
        counts = np.bincount(sorted_codes, minlength=4**k)
        csr = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
        csr = csr.astype(np.int32) if small else csr
    pad8 = (-len(ref)) % 8
    ref8 = np.pad(ref, (0, pad8), constant_values=REF_PAD)
    return KmerIndex(
        k=k,
        ref=ref,
        codes=sorted_codes,
        pos=order.astype(np.int32 if small else np.int64),
        contig_starts=np.asarray(starts, dtype=np.int64),
        contig_names=names,
        contig_lens=np.asarray(clens, dtype=np.int64),
        starts=csr,
        ref_packed=pack_2bit(np.where(ref8 > 3, 0, ref8)),
        ref_sepmask=np.packbits(ref8 > 3, bitorder="little"),
    )


# ---------------------------------------------------------------------------
# 2. Seeding


@dataclasses.dataclass
class Candidates:
    """Candidate loci: one row per (read, reference window) to extend."""

    read: np.ndarray  # [C] int64 read row index
    tstart: np.ndarray  # [C] int64 window start in the concatenated ref
    n_seeds: np.ndarray  # [C] int64 seeds supporting the cluster


def find_candidates(
    index: KmerIndex,
    reads: np.ndarray,
    lens: Optional[np.ndarray] = None,
    min_seeds: int = 2,
    max_occ: int = 64,
    max_loci: int = 8,
    diag_window: Optional[int] = None,
) -> Candidates:
    """Seeding: k-mer lookups -> (read, diagonal) clusters.

    Diagonals (tpos - qpos) are quantized to ``diag_window`` buckets
    (default 32, the extension bandwidth); adjacent buckets of one read
    merge into one cluster. Clusters need >= min_seeds seeds; each read
    keeps its top ``max_loci`` clusters by seed count, and drops those
    below a third of its best. The anchor is the diagonal of the
    cluster's earliest seed (minimum qpos). Where the index has its
    direct-addressed table and the C++ library is built, the C++ seeder
    (``native.seed_candidates``) runs; else the numpy path below, the
    reference the C++ one is held to (the same candidates)."""
    from swtpu_torch import native

    reads = np.asarray(reads, dtype=np.uint8)
    R, L = reads.shape
    dw = 32 if diag_window is None else int(diag_window)
    qcodes = _kmer_codes(reads, index.k)  # [R, n]
    n = qcodes.shape[1]
    if lens is not None:
        lens = np.asarray(lens)
        in_len = np.arange(n)[None, :] <= (lens[:, None] - index.k)
        qcodes = np.where(in_len, qcodes, -1)
    if (
        index.starts is not None
        and native.available()
        and n > 0
        and index.pos.dtype == np.int32
        and index.starts.dtype == np.int32
    ):
        read, anchor, nseeds = native.seed_candidates(
            qcodes, index.starts, index.pos, L, dw, max_occ, min_seeds, max_loci,
        )
        return Candidates(read=read, tstart=anchor, n_seeds=nseeds)
    rid, qpos = np.nonzero(qcodes >= 0)
    flat = qcodes[rid, qpos]
    if index.starts is not None:  # O(1) direct-addressed lookup
        lo = index.starts[flat]
        occ = index.starts[flat + 1] - lo
    else:
        lo = np.searchsorted(index.codes, flat, side="left")
        occ = np.searchsorted(index.codes, flat, side="right") - lo
    keep = (occ > 0) & (occ <= max_occ)
    rid, qpos, lo, occ = rid[keep], qpos[keep], lo[keep], occ[keep]
    if len(rid) == 0:
        z = np.zeros(0, dtype=np.int64)
        return Candidates(read=z, tstart=z.copy(), n_seeds=z.copy())
    total = int(occ.sum())
    # expand [lo, lo+occ) ranges without a Python loop
    ends = np.cumsum(occ, dtype=np.int64)
    within = np.arange(total) - np.repeat(ends - occ, occ)
    tpos = index.pos[np.repeat(lo, occ) + within]
    h_rid = np.repeat(rid, occ)
    h_qpos = np.repeat(qpos, occ)
    diag = tpos - h_qpos  # can be negative near contig starts
    # cluster on (read, diag bucket); bucket ids made non-negative
    bucket = (diag + L) // dw
    key = h_rid * np.int64(2**40) + bucket
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    # per-seed packed (qpos, diag): a min reduction yields the diagonal of
    # the earliest seed; diag + L >= 0 keeps the low field non-negative
    packed = (h_qpos[order] << np.int64(32)) | (diag[order] + L)
    first = np.concatenate([[0], np.nonzero(np.diff(key_s))[0] + 1])
    uniq = key_s[first]
    counts = np.diff(np.append(first, len(key_s)))
    pmin = np.minimum.reduceat(packed, first)
    # merge runs of adjacent buckets (same read, consecutive bucket ids)
    new_cluster = np.ones(len(uniq), dtype=bool)
    new_cluster[1:] = np.diff(uniq) != 1
    firsts = np.nonzero(new_cluster)[0]
    cl_counts = np.add.reduceat(counts, firsts)
    cl_pmin = np.minimum.reduceat(pmin, firsts)
    cl_anchor = (cl_pmin & np.int64(2**32 - 1)) - L
    cl_read = (uniq[firsts] // np.int64(2**40)).astype(np.int64)
    ok = cl_counts >= min_seeds
    cl_read, cl_anchor, cl_counts = cl_read[ok], cl_anchor[ok], cl_counts[ok]
    # top max_loci clusters per read by (read, -count, anchor); clusters
    # below a third of the read's best are k-mer noise
    order = np.lexsort((cl_anchor, -cl_counts, cl_read))
    cl_read, cl_anchor, cl_counts = cl_read[order], cl_anchor[order], cl_counts[order]
    grp0 = np.searchsorted(cl_read, cl_read, side="left")
    rank = np.arange(len(cl_read)) - grp0
    ok = (rank < max_loci) & (
        cl_counts >= np.maximum(min_seeds, cl_counts[grp0] // 3)
    )
    return Candidates(read=cl_read[ok], tstart=cl_anchor[ok], n_seeds=cl_counts[ok])


# ---------------------------------------------------------------------------
# 3. Extension


def _route(device) -> str:
    """The mapper's route on ``device``: "card" on a CUDA device (the
    fixed corridor and the 2-bit wire for screening, the block tier for
    linear winners), "cpu" elsewhere (the JAX package's off-TPU route)."""
    return "card" if resolve_device(device).type == "cuda" else "cpu"


def _params(match, mismatch, gap, gap_open, gap_extend, matrix):
    from swtpu_torch.core.scoring import ScoringParams, dna_matrix

    go = int(gap_open) if gap_open is not None else int(gap)
    ge = int(gap_extend) if gap_open is not None else int(gap)
    mat = dna_matrix(match, -mismatch) if matrix is None else np.asarray(matrix)
    return ScoringParams(mat, go, ge)


def _fixed_fn(params, dev):
    """The fixed-band scorer for ``params`` on ``dev``: on the card the
    kernel's uniform or profile form (row 10); on the CPU the plain
    version both forms run there, which takes every scoring (the JAX
    package's scalar oracle does)."""
    from swtpu_torch.kernels import sw_banded
    from swtpu_torch.kernels.sw_batch import _uniform_match_mismatch

    if dev.type == "cpu":
        return sw_banded.sw_banded_plain
    if _uniform_match_mismatch(params) is not None:
        return sw_banded.sw_banded_static
    return sw_banded.sw_banded_profile


def _banded_scores(qs, ts, lens_q, lens_t, device=None, **kw):
    """Adaptive-banded X-drop forward, scores only: the per-round kernel
    (row 14/15) on the card, its plain version on the CPU."""
    from swtpu_torch.kernels.banded_batch import banded_batch

    res = banded_batch(qs, ts, lens_q, lens_t, with_history=False, device=device, **kw)
    return res.score.cpu().numpy()


def _fixed_scores(
    qs, ts, lens_q, lens_t, match, mismatch, gap, gap_open, gap_extend,
    bandwidth, matrix, device=None,
):
    """Fixed-corridor (|i - j| <= W) local scores of the screening stage,
    per ``oracle.banded_static`` with pads at matrix.min() (pads can only
    lose). Winners that need paths are re-scored by a traceback engine
    (map_reads), so hits with paths carry X-drop scores."""
    dev = resolve_device(device)
    params = _params(match, mismatch, gap, gap_open, gap_extend, matrix)
    fwd = _fixed_fn(params, dev)
    out = fwd(qs, ts, params, bandwidth, lens_q=lens_q, lens_t=lens_t, device=dev)
    return out.cpu().numpy().astype(np.int64)


def _fixed_scores_packed(
    qbytes, wbytes, mbytes, lens_q, lens_t, params, bandwidth, n, m, device=None
):
    """Fixed-corridor scores from the 2-bit wire: packed read bytes,
    packed window bytes and the windows' separator bitmask go to the
    device, which decodes them, restores the target pad at separator
    positions and runs the fixed-band scorer with the lengths. The wire
    is ~4x smaller than raw codes."""
    from swtpu_torch.kernels.unpack import unpack_2bit_device

    dev = resolve_device(device)
    t_pad = params.alphabet_size + 1
    qs = unpack_2bit_device(qbytes, dev)[:, :n]
    ts = unpack_2bit_device(wbytes, dev)[:, :m]
    mb = torch.from_numpy(np.ascontiguousarray(mbytes, dtype=np.uint8)).to(dev)
    bits = (mb[:, :, None] >> torch.arange(8, dtype=torch.uint8, device=dev)) & 1
    sep = bits.reshape(mb.shape[0], -1)[:, :m]
    ts = torch.where(sep == 1, torch.tensor(t_pad, dtype=torch.uint8, device=dev), ts)
    fwd = _fixed_fn(params, dev)
    out = fwd(qs, ts, params, bandwidth, lens_q=lens_q, lens_t=lens_t, device=dev)
    return out.cpu().numpy()


@dataclasses.dataclass
class MapHit:
    read: int
    contig: str
    #: 0-based alignment start on the contig: the extension window origin,
    #: refined to the first aligned column when a path was requested
    pos: int
    score: int
    strand: str = "+"
    n_seeds: int = 0
    path: Optional[List[Tuple[int, int]]] = None  # read/contig coords, 1-based
    #: window origin in the concatenated reference (debug/parity checks)
    window_start: int = 0


def _window_geometry(read_width: int, bandwidth: int):
    """(margin, window_len): the window origin sits on the anchor diagonal
    (margin 0) and spans the read plus band drift."""
    return 0, read_width + 2 * bandwidth


def extend_candidates(
    index: KmerIndex,
    reads: np.ndarray,
    lens: np.ndarray,
    cands: Candidates,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    bandwidth: int = 32,
    x_threshold: int = 70,
    matrix: Optional[np.ndarray] = None,
    extend: str = "auto",
    device=None,
    route: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Score every candidate locus in ONE batched device call.

    ``extend``: "fixed" = the fixed-corridor kernel (scores per
    ``oracle.banded_static``; on the card's route pure-ACGT reads go on
    the 2-bit wire), "fixed-packed" = force the 2-bit wire, "adaptive" =
    the per-round X-drop band (scores per the X-drop oracle), "auto" =
    fixed on the card's route, adaptive on the CPU's. ``route`` ("card"
    or "cpu") defaults to :func:`_route` of ``device``.

    Returns (scores [C], tstart [C]): tstart is the window origin the
    path coordinates are relative to (8-aligned on the 2-bit wire)."""
    from swtpu_torch.core.encode import pack_2bit

    dev = resolve_device(device)
    route = _route(dev) if route is None else route
    reads = np.asarray(reads, dtype=np.uint8)
    R, L = reads.shape
    margin, Lw = _window_geometry(L, bandwidth)
    tstart = np.clip(cands.tstart - margin, 0, max(len(index.ref) - 1, 0))
    if extend == "auto":
        extend = "fixed" if route == "card" else "adaptive"
    C = len(cands.read)
    if C == 0:
        return np.zeros(0, np.int32), tstart
    lq = np.asarray(lens)[cands.read]
    # the 2-bit wire carries A/C/G/T only: reads with in-length ambiguity
    # codes go on the raw wire (they score as mismatches there)
    ambig = bool(
        ((reads > 3) & (np.arange(L)[None, :] < np.asarray(lens)[:, None])).any()
    )
    use_packed_wire = extend == "fixed-packed" or (
        extend == "fixed" and not ambig and index.ref_packed is not None
        and route == "card"
    )
    if use_packed_wire:
        # window origins aligned to 8 (whole bytes of the packed chars and
        # of the bitmask), the window widened to keep its right edge
        tstart = tstart & ~np.int64(7)
        Lwp = -(-(Lw + 8) // 8) * 8
        cols, mcols = Lwp // 4, Lwp // 8
        wbytes = np.take(
            index.ref_packed, (tstart // 4)[:, None] + np.arange(cols)[None, :],
            mode="clip",
        )
        mbytes = np.take(
            index.ref_sepmask, (tstart // 8)[:, None] + np.arange(mcols)[None, :],
            mode="clip",
        )
        lens_t = np.minimum(Lwp, len(index.ref) - tstart)
        L4 = -(-L // 4) * 4
        reads4 = reads if L4 == L else np.pad(reads, ((0, 0), (0, L4 - L)))
        qbytes = pack_2bit(np.where(reads4 > 3, 0, reads4))[cands.read]
        params = _params(match, mismatch, gap, gap_open, gap_extend, matrix)
        scores = _fixed_scores_packed(
            qbytes, wbytes, mbytes, lq.astype(np.int32), lens_t.astype(np.int32),
            params, bandwidth, L4, Lwp, dev,
        )
        return scores, tstart
    idx = tstart[:, None] + np.arange(Lw)[None, :]
    windows = np.take(index.ref, idx, mode="clip")
    lens_t = np.minimum(Lw, len(index.ref) - tstart)
    qsel = reads[cands.read]
    if extend != "adaptive":
        scores = _fixed_scores(
            qsel, windows, lq, lens_t, match, mismatch, gap, gap_open, gap_extend,
            bandwidth, matrix, dev,
        )
        return scores, tstart
    kw = dict(bandwidth=bandwidth, x_threshold=x_threshold)
    if matrix is not None:
        kw["matrix"] = matrix
    else:
        kw.update(match=match, mismatch=mismatch, gap=gap)
    if gap_open is not None and gap_open != gap_extend:
        kw.update(gap_open=gap_open, gap_extend=gap_extend)
    elif gap_open is not None:
        kw["gap"] = gap_open
    return _banded_scores(qsel, windows, lq, lens_t, device=dev, **kw), tstart


def _on_block_tier(route: str, gap_open, bandwidth: int) -> bool:
    """Whether the winners walk on the block tier: the card's route,
    linear gaps, and a geometry the tier takes (width 2W a multiple of
    16, block + width = 3W <= 129)."""
    W = int(bandwidth)
    return (route == "card" and gap_open is None and (2 * W) % 16 == 0
            and 3 * W <= BLOCK_WINDOW)


def _winner_paths(qsel, windows, lens_q, lens_t, match, mismatch, gap, gap_open,
                  gap_extend, bandwidth, x_threshold, route, device):
    """[(score, path)] of the winners: the block tier on the card's route
    where :func:`_on_block_tier` says so (block-oracle X-drop scores),
    else ``banded_align_batch`` (per-round X-drop scores). Gaps come
    collapsed (gap_open None for linear)."""
    if _on_block_tier(route, gap_open, bandwidth):
        from swtpu_torch.kernels.banded_block import banded_block_align_device

        return banded_block_align_device(
            qsel, windows, match=match, mismatch=mismatch, gap=gap,
            width=bandwidth * 2, block=bandwidth, x_threshold=x_threshold,
            lens_q=lens_q, lens_t=lens_t, device=device,
        )
    from swtpu_torch.batch.traceback import banded_align_batch

    return banded_align_batch(
        qsel, windows, lens_q, lens_t, match=match, mismatch=mismatch, gap=gap,
        bandwidth=bandwidth, x_threshold=x_threshold, gap_open=gap_open,
        gap_extend=gap_extend, device=device,
    )


# ---------------------------------------------------------------------------
# 4. The pipeline


def _seed_rows(
    reads, lens, index, both_strands, min_seeds, max_occ, max_loci, bandwidth,
):
    """Host seeding stage: per strand (reads, lens, strand, candidates).

    Pure host work (revcomp + k-mer seeding), split out so
    :func:`map_reads_pipelined` can run it for chunk i+1 while the device
    extends chunk i."""
    rows = [(reads, lens, "+")]
    if both_strands:
        from swtpu_torch.core.encode import revcomp

        rc = np.stack([revcomp(reads[i], int(lens[i])) for i in range(len(reads))])
        rows.append((rc, lens, "-"))
    return [
        (
            q, ql, strand,
            find_candidates(
                index, q, ql, min_seeds=min_seeds, max_occ=max_occ,
                max_loci=max_loci, diag_window=bandwidth,
            ),
        )
        for q, ql, strand in rows
    ]


def map_reads_pipelined(
    reads: np.ndarray,
    lens: Optional[Sequence[int]] = None,
    index: Optional[KmerIndex] = None,
    chunk_reads: int = 1024,
    **kw,
) -> List[Optional[MapHit]]:
    """map_reads with a two-stage software pipeline over read chunks.

    A one-worker thread seeds chunk i+1 (host work; the C++ seeder
    releases the GIL) while the main thread runs chunk i's device
    extension. Hit-for-hit identical to ``map_reads`` (chunks only
    partition reads). At most two chunks: each extra chunk costs a call's
    fixed overhead. Workloads of <= chunk_reads reads take map_reads."""
    import concurrent.futures as cf

    reads = np.asarray(reads, dtype=np.uint8)
    R, L = reads.shape
    lens = (
        np.full(R, L, dtype=np.int64) if lens is None
        else np.asarray(lens, dtype=np.int64)
    )
    if index is None:
        if "contigs" not in kw:
            raise ValueError("need index= or contigs=")
        index = build_index(kw.pop("contigs"), kw.pop("contig_names", None),
                            k=kw.get("k", 13))
    if R <= chunk_reads:
        return map_reads(reads, lens, index=index, **kw)
    chunk_reads = max(chunk_reads, -(-R // 2))  # at most two chunks
    seed_kw = dict(
        both_strands=kw.get("both_strands", False),
        min_seeds=kw.get("min_seeds", 2),
        max_occ=kw.get("max_occ", 64),
        max_loci=kw.get("max_loci", 8),
        bandwidth=kw.get("bandwidth", 32),
    )
    bounds = list(range(0, R, chunk_reads))
    hits: List[Optional[MapHit]] = []
    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(_seed_rows, reads[:chunk_reads], lens[:chunk_reads], index,
                        **seed_kw)
        for ci, lo in enumerate(bounds):
            hi = min(lo + chunk_reads, R)
            seeded = fut.result()
            if ci + 1 < len(bounds):
                lo2 = bounds[ci + 1]
                hi2 = min(lo2 + chunk_reads, R)
                fut = ex.submit(_seed_rows, reads[lo2:hi2], lens[lo2:hi2], index,
                                **seed_kw)
            chunk_hits = map_reads(reads[lo:hi], lens[lo:hi], index=index,
                                   _seeded=seeded, **kw)
            hits.extend(
                h if h is None else dataclasses.replace(h, read=h.read + lo)
                for h in chunk_hits
            )
    return hits


def map_reads(
    reads: np.ndarray,
    lens: Optional[Sequence[int]] = None,
    index: Optional[KmerIndex] = None,
    contigs: Optional[Sequence[np.ndarray]] = None,
    contig_names: Optional[Sequence[str]] = None,
    k: int = 13,
    min_seeds: int = 2,
    max_occ: int = 64,
    max_loci: int = 8,
    match: int = 1,
    mismatch: int = 1,
    gap: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    bandwidth: int = 32,
    x_threshold: int = 70,
    min_score: int = 1,
    both_strands: bool = False,
    traceback: bool = False,
    extend: str = "auto",
    device=None,
    route: Optional[str] = None,
    _seeded: Optional[list] = None,
) -> List[Optional[MapHit]]:
    """Map every read to its best reference locus; None = unmapped.

    Per read the best (score desc, tstart asc, '+' before '-') candidate
    at or above min_score wins. ``extend`` picks the screening engine
    (see extend_candidates). With ``traceback=True`` the winners re-run
    through a traceback engine (:func:`_winner_paths`), so hits with
    paths carry X-drop scores: the block oracle's on the card's route
    (linear gaps, bandwidths the block tier takes), the per-round
    oracle's otherwise. ``route`` ("card" / "cpu") defaults to
    :func:`_route` of ``device``. ``_seeded`` (internal, used by
    :func:`map_reads_pipelined`) injects ``_seed_rows`` output."""
    dev = resolve_device(device)
    route = _route(dev) if route is None else route
    gap, gap_open, gap_extend = _gaps(gap, gap_open, gap_extend)  # go == ge: linear
    reads = np.asarray(reads, dtype=np.uint8)
    R, L = reads.shape
    lens = (
        np.full(R, L, dtype=np.int64) if lens is None
        else np.asarray(lens, dtype=np.int64)
    )
    if index is None:
        if contigs is None:
            raise ValueError("need index= or contigs=")
        index = build_index(contigs, contig_names, k=k)
    seeded = (
        _seed_rows(reads, lens, index, both_strands, min_seeds, max_occ, max_loci,
                   bandwidth)
        if _seeded is None else _seeded
    )
    all_read, all_tstart, all_scores, all_seeds, all_strand = [], [], [], [], []
    strand_rows = {}
    for q, ql, strand, cands in seeded:
        strand_rows[strand] = q
        if len(cands.read) == 0:
            continue
        scores, tstart = extend_candidates(
            index, q, ql, cands, match=match, mismatch=mismatch, gap=gap,
            gap_open=gap_open, gap_extend=gap_extend, bandwidth=bandwidth,
            x_threshold=x_threshold, extend=extend, device=dev, route=route,
        )
        all_read.append(cands.read)
        all_tstart.append(tstart)
        all_scores.append(scores.astype(np.int64))
        all_seeds.append(cands.n_seeds)
        all_strand.append(np.full(len(cands.read), int(strand == "-"), np.int64))
    hits: List[Optional[MapHit]] = [None] * R
    if not all_read:
        return hits
    read = np.concatenate(all_read)
    tstart = np.concatenate(all_tstart)
    scores = np.concatenate(all_scores)
    seeds = np.concatenate(all_seeds)
    strands = np.concatenate(all_strand)
    ok = scores >= min_score
    read, tstart, scores, seeds, strands = (
        read[ok], tstart[ok], scores[ok], seeds[ok], strands[ok],
    )
    if len(read) == 0:
        return hits
    order = np.lexsort((strands, tstart, -scores, read))
    first = np.searchsorted(read[order], np.arange(R), side="left")
    last = np.searchsorted(read[order], np.arange(R), side="right")
    win = [order[f] for f, l in zip(first, last) if f < l]
    win_reads = [int(read[w]) for w in win]
    paths = [None] * len(win)
    if traceback and win:
        margin, Lw = _window_geometry(L, bandwidth)
        w_tstart = tstart[win]
        idx = w_tstart[:, None] + np.arange(Lw)[None, :]
        windows = index.ref[np.clip(idx, 0, len(index.ref) - 1)]
        qsel = np.stack([
            strand_rows["-" if strands[w] else "+"][r] for w, r in zip(win, win_reads)
        ])
        w_lens_q = [int(lens[r]) for r in win_reads]
        w_lens_t = list(np.minimum(Lw, len(index.ref) - w_tstart))
        out = _winner_paths(
            qsel, windows, w_lens_q, w_lens_t, match, mismatch, gap, gap_open,
            gap_extend, bandwidth, x_threshold, route, dev,
        )
        # winners carry the traceback engine's X-drop score for the same
        # window: a rescore of the screening score
        scores = scores.copy()
        for w, (s, _) in zip(win, out):
            scores[w] = s
        paths = [p for _, p in out]
    if win:
        cids, locals_ = index.locate(tstart[np.asarray(win)])
    for j, (w, rd, path) in enumerate(zip(win, win_reads, paths)):
        cid, local = int(cids[j]), int(locals_[j])
        pos = local
        rel_path = None
        if path:
            # path cells are 1-based (y=read, x=window) after a (0, 0)
            # origin; pos is the column where read char 1 aligns, x is
            # rebased onto the contig
            first_x = next((x for y, x in path if y == 1), path[0][1] + 1)
            pos = local + first_x - 1
            rel_path = [(y, x + local) for y, x in path]
        hits[rd] = MapHit(
            read=rd,
            contig=index.contig_names[cid],
            pos=pos,
            score=int(scores[w]),
            strand="-" if strands[w] else "+",
            n_seeds=int(seeds[w]),
            path=rel_path,
            window_start=int(tstart[w]),
        )
    return hits
