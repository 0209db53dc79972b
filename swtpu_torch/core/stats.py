"""Karlin-Altschul alignment statistics: bit scores and E-values.

Copy of ``swtpu/core/stats.py`` (numpy only), kept in the port so that it
imports nothing of the JAX package. ``calibrate_stats`` and
``resolve_stats`` take ``device`` (the card unless the caller passes
``device="cpu"``) and score with the port's ``best_engine``, whose scores
equal the JAX package's, so a fit at the same seed and geometry gives
bit-equal (lambda, K).

Database search (BASELINE config 5) needs a significance layer over raw
Smith-Waterman scores: for ungapped local alignment of random sequences,
score maxima follow an extreme-value (Gumbel) law

    P(S >= x) ~ 1 - exp(-K * m * n * e^(-lambda * x))

(Karlin & Altschul 1990), and the same form holds empirically for gapped
alignment with simulation-fitted parameters, which is how BLAST obtains
its gapped (lambda, K) tables. This module provides:

- exact ungapped ``lambda`` and relative entropy ``H`` for any scoring
  matrix + background frequencies (1-D root solve of
  sum_ij p_i q_j exp(lambda * s_ij) = 1);
- tabulated NCBI presets for the standard protein configuration
  (BLOSUM62, gap 11/1), so ``search`` matches BLAST out of the box;
- an empirical calibrator for everything else: score a few thousand
  random pairs with the production engine, maximum-likelihood-fit the
  Gumbel, read off (lambda, K), on the user's exact scoring parameters;
- bit-score / E-value conversion with BLAST's iterative effective-length
  correction.

Raw scores, lambda and K compose as:
    bit  = (lambda * S - ln K) / ln 2
    E    = K * m' * n' * exp(-lambda * S)     (m', n' effective lengths)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from swtpu_torch.core.scoring import ScoringParams

# ---------------------------------------------------------------------------
# Background frequencies

#: Robinson & Robinson (1991) amino-acid frequencies — the background model
#: NCBI BLAST uses for protein Karlin-Altschul parameters. Order matches the
#: first 20 letters of PROTEIN_ALPHABET (ARNDCQEGHILKMFPSTWYV); sums to 1.
ROBINSON_FREQS = np.array(
    [
        0.07805, 0.05129, 0.04487, 0.05364, 0.01925,  # A R N D C
        0.04264, 0.06295, 0.07377, 0.02199, 0.05142,  # Q E G H I
        0.09019, 0.05744, 0.02243, 0.03856, 0.05203,  # L K M F P
        0.07120, 0.05841, 0.01330, 0.03216, 0.06441,  # S T W Y V
    ]
)

#: Uniform DNA background (the reference's own random model,
#: source.cpp:2945: uniform_int_distribution dna(0,3)).
DNA_UNIFORM_FREQS = np.full(4, 0.25)


def background_freqs(alphabet: str) -> np.ndarray:
    if alphabet == "dna":
        return DNA_UNIFORM_FREQS
    if alphabet == "protein":
        return ROBINSON_FREQS / ROBINSON_FREQS.sum()
    raise ValueError(f"unknown alphabet {alphabet!r}")


# ---------------------------------------------------------------------------
# Exact ungapped lambda / H

def _restrict(matrix: np.ndarray, p: np.ndarray, q: np.ndarray):
    """Clip the matrix to the leading |p| x |q| block (protein matrices
    carry ambiguity rows B/Z/X/* beyond the 20 canonical residues)."""
    m = np.asarray(matrix, dtype=np.float64)
    return m[: len(p), : len(q)]


def karlin_lambda(
    matrix: np.ndarray,
    p: np.ndarray,
    q: Optional[np.ndarray] = None,
    tol: float = 1e-10,
) -> float:
    """The unique positive root of sum_ij p_i q_j exp(lambda s_ij) = 1.

    Requires a valid local-alignment scoring system: expected score < 0
    and at least one positive score (Karlin & Altschul 1990 conditions).
    """
    p = np.asarray(p, dtype=np.float64)
    p = p / p.sum()
    q = p if q is None else np.asarray(q, dtype=np.float64) / np.sum(q)
    s = _restrict(matrix, p, q)
    w = np.outer(p, q)
    es = float((w * s).sum())
    if es >= 0:
        raise ValueError(
            f"expected score {es:.4f} >= 0: not a valid local scoring system"
        )
    if s.max() <= 0:
        raise ValueError("no positive score in matrix")

    def f(lam):
        # sum w * exp(lam*s) - 1, computed stably
        return float((w * np.exp(lam * s)).sum()) - 1.0

    # f(0) = 0 (up to roundoff), f'(0) = E[s] < 0, f convex, f(inf) = inf:
    # the positive root lambda* has f < 0 strictly on (0, lambda*)
    hi = 0.5
    while f(hi) < 0:
        hi *= 2.0
        if hi > 1e4:
            raise ValueError("failed to bracket lambda")
    lo = hi / 2.0
    while f(lo) > 0:
        lo /= 2.0
        if lo < 1e-12:
            raise ValueError("lambda root collapsed to 0")
    # bisection (robust; the function is convex in lambda)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0:
            hi = mid
        else:
            lo = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


def karlin_H(
    matrix: np.ndarray,
    p: np.ndarray,
    q: Optional[np.ndarray] = None,
    lam: Optional[float] = None,
) -> float:
    """Relative entropy H = lambda * sum_ij p_i q_j s_ij exp(lambda s_ij)
    (nats per aligned pair) of the ungapped scoring system."""
    p = np.asarray(p, dtype=np.float64)
    p = p / p.sum()
    q = p if q is None else np.asarray(q, dtype=np.float64) / np.sum(q)
    if lam is None:
        lam = karlin_lambda(matrix, p, q)
    s = _restrict(matrix, p, q)
    w = np.outer(p, q)
    return float(lam * (w * s * np.exp(lam * s)).sum())


# ---------------------------------------------------------------------------
# Parameter container + presets

@dataclasses.dataclass(frozen=True)
class KAStats:
    """Gumbel parameters of a scoring system.

    lam:    scale (1/nats-per-score-unit)
    K:      search-space prefactor
    H:      relative entropy (nats/position); None when unknown (pure
            empirical calibration) — disables the effective-length
            correction
    source: 'preset' | 'ungapped-exact' | 'calibrated'
    """

    lam: float
    K: float
    H: Optional[float] = None
    source: str = "preset"


#: NCBI BLAST's simulation-fitted gapped parameters for the standard
#: protein configuration (blast_stat.c): BLOSUM62, gap open 11, extend 1.
_BLOSUM62_GAPPED_PRESETS = {
    (11, 1): KAStats(lam=0.267, K=0.041, H=0.14, source="preset"),
}


def _is_blosum62(matrix: np.ndarray) -> bool:
    from swtpu_torch.core.protein import BLOSUM62

    m = np.asarray(matrix)
    return m.shape == BLOSUM62.shape and bool((m == BLOSUM62).all())


def preset_stats(params: ScoringParams, alphabet: str) -> Optional[KAStats]:
    """Tabulated (lambda, K) for standard configurations, or None."""
    if alphabet == "protein" and _is_blosum62(params.matrix):
        if not params.is_linear:
            return _BLOSUM62_GAPPED_PRESETS.get(
                (int(params.gap_open), int(params.gap_extend))
            )
    return None


def ungapped_stats(
    matrix: np.ndarray, alphabet: str, K: Optional[float] = None
) -> KAStats:
    """Exact ungapped lambda/H; K must be supplied (tabulated) or comes
    from `calibrate_stats`. For BLOSUM62 the NCBI value K=0.134 is used."""
    p = background_freqs(alphabet)
    lam = karlin_lambda(matrix, p)
    H = karlin_H(matrix, p, lam=lam)
    if K is None:
        if alphabet == "protein" and _is_blosum62(matrix):
            K = 0.134  # NCBI blast_stat.c, BLOSUM62 ungapped
        else:
            raise ValueError(
                "no tabulated K for this matrix; use calibrate_stats"
            )
    return KAStats(lam=lam, K=K, H=H, source="ungapped-exact")


# ---------------------------------------------------------------------------
# Empirical Gumbel calibration (the gapped path; runs on the card's engine)

def gumbel_fit_ml(scores: np.ndarray, tol: float = 1e-10):
    """Maximum-likelihood Gumbel(mu, beta) fit.

    Solves the profile-likelihood equation for beta by bisection:
        g(beta) = beta - mean(x) + sum(x e^{-x/beta}) / sum(e^{-x/beta}) = 0
    then mu = -beta * ln(mean(e^{-x/beta})).  Returns (mu, beta).
    """
    x = np.asarray(scores, dtype=np.float64)
    if x.size < 16:
        raise ValueError("need >= 16 samples for a Gumbel fit")
    shift = x.mean()  # shift-equivariance: fit around 0 for stability
    xs = x - shift
    std = float(xs.std())
    if std == 0:
        raise ValueError("degenerate (constant) score sample")

    def g(beta):
        e = np.exp(-xs / beta)
        return beta - xs.mean() + float((xs * e).sum() / e.sum())

    # MLE beta is near std*sqrt(6)/pi; bracket generously
    lo, hi = std * 0.05, std * 4.0
    glo, ghi = g(lo), g(hi)
    while glo > 0 and lo > 1e-9 * std:
        lo *= 0.5
        glo = g(lo)
    while ghi < 0 and hi < 1e4 * std:
        hi *= 2.0
        ghi = g(hi)
    if not (glo <= 0 <= ghi):
        raise ValueError("Gumbel MLE bracket failed")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if g(mid) < 0:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * std:
            break
    beta = 0.5 * (lo + hi)
    mu = -beta * math.log(float(np.exp(-xs / beta).mean())) + shift
    return mu, beta


def calibrate_stats(
    params: ScoringParams,
    alphabet: str = "dna",
    m: int = 128,
    n: Optional[int] = None,
    pairs: int = 8192,
    seed: int = 10000,
    engine=None,
    chunk: int = 8192,
    device=None,
) -> KAStats:
    """Fit (lambda, K) for ANY scoring system by aligning random pairs.

    Random m x n pairs drawn from the background model are scored with
    the production engine (``best_engine(params, device)``: the kernels
    on the card by default, the plain tier with ``device="cpu"``; or the
    caller's ``engine``) and the score sample is
    ML-fitted to a Gumbel; K = exp(lambda*mu) / (m*n).  This is the
    methodology behind BLAST's gapped parameter tables, executed on the
    user's exact scoring parameters.

    Calibrate at the GEOMETRY you will search at: the fit directly
    models the score distribution at (m, n), so finite-size edge effects
    are inside the fitted (lambda, K) and no length adjustment applies
    (H is left None).  Asymptotic published values differ at short
    lengths for exactly this reason; using the matched geometry makes
    E-values empirically correct where asymptotic (lambda, K) + edge
    correction only approximate.
    """
    rng = np.random.default_rng(seed)
    p = background_freqs(alphabet)
    n = m if n is None else n
    qs = rng.choice(len(p), size=(pairs, m), p=p).astype(np.uint8)
    ts = rng.choice(len(p), size=(pairs, n), p=p).astype(np.uint8)
    if engine is None:
        from swtpu_torch.ops.variants import best_engine

        engine = best_engine(params, device)
    out = []
    for i in range(0, pairs, chunk):
        s = engine(qs[i : i + chunk], ts[i : i + chunk])
        out.append(s.cpu().numpy() if hasattr(s, "cpu") else np.asarray(s))
    scores = np.concatenate(out).astype(np.float64)
    mu, beta = gumbel_fit_ml(scores)
    lam = 1.0 / beta
    K = math.exp(lam * mu) / (float(m) * float(n))
    return KAStats(lam=lam, K=K, H=None, source="calibrated")


def resolve_stats(
    params: ScoringParams,
    alphabet: str,
    mode: str = "auto",
    calibrate_pairs: int = 8192,
    seed: int = 10000,
    m: int = 128,
    n: Optional[int] = None,
    device=None,
) -> Optional[KAStats]:
    """CLI-facing resolution: 'none' | 'preset' | 'calibrate' | 'auto'.

    auto = preset when tabulated, else calibration on ``device`` at the
    caller-supplied (m, n) search geometry."""
    if mode == "none":
        return None
    if mode in ("preset", "auto"):
        st = preset_stats(params, alphabet)
        if st is not None:
            return st
        if mode == "preset":
            raise ValueError(
                "no tabulated Karlin-Altschul preset for this scoring; "
                "use --stats calibrate"
            )
    return calibrate_stats(
        params, alphabet, m=m, n=n, pairs=calibrate_pairs, seed=seed,
        device=device,
    )


# ---------------------------------------------------------------------------
# Score conversion

def bit_score(raw, stats: KAStats):
    """Normalized bit score: (lambda*S - ln K) / ln 2."""
    return (stats.lam * np.asarray(raw, dtype=np.float64)
            - math.log(stats.K)) / math.log(2.0)


def length_adjustment(stats: KAStats, m: int, n: int, iters: int = 5) -> int:
    """BLAST's simple iterative edge-effect correction: the expected
    alignment length l = ln(K m' n')/H removed from both sequences."""
    if not stats.H or stats.H <= 0:
        return 0
    ell = 0.0
    for _ in range(iters):
        s = stats.K * max(m - ell, 1.0) * max(n - ell, 1.0)
        ell = max(math.log(s), 0.0) / stats.H if s > 1 else 0.0
    ell = int(ell)
    # never eat a whole sequence
    return min(ell, min(m, n) - 1) if min(m, n) > 1 else 0


def e_value(
    raw,
    m: int,
    n: int,
    stats: KAStats,
    db_seqs: int = 1,
    effective: bool = True,
):
    """E = K * m' * n' * exp(-lambda * S), summed over db_seqs targets of
    (representative) length n. m = query length, n = per-target length."""
    ell = length_adjustment(stats, m, n) if effective else 0
    mp = max(m - ell, 1)
    np_ = max(n - ell, 1)
    s = np.asarray(raw, dtype=np.float64)
    return stats.K * mp * np_ * db_seqs * np.exp(-stats.lam * s)
