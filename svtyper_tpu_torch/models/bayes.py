"""Scalar Bayesian genotype model — the float64 parity definition.

Reconstruction of ``classic.py::bayes_gt`` and ``log_choose``
(SURVEY.md §2.2, §8.1–2; SPEC.md §5). The engine's batched JAX/Pallas
kernels (``svtyper_tpu/ops/gl.py``, ``svtyper_tpu/ops/pallas_gl.py``)
must reproduce these values to output-format precision;
``tests/test_pallas_gl.py`` and ``tests/test_engine_parity.py``
enforce it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

# per-genotype alt-allele probabilities for (0/0, 0/1, 1/1) — SPEC.md §5
ALT_PROBS = (1e-3, 0.5, 0.9)
ALT_PROBS_DUP = (1e-2, 0.2, 1.0 / 3.0)

GT_STRINGS = ("0/0", "0/1", "1/1")
MAX_GQ = 200.0


def log_choose(n: int, k: int) -> float:
    """Iterative log10 binomial coefficient (SPEC.md §5).

    Matches the reference's summation order: symmetrize then
    ``sum_{d=1..k} log10(n-d+1) - log10(d)``.
    """
    r = 0.0
    if 2 * k > n:
        k = n - k
    for d in range(1, k + 1):
        r += math.log10(n - d + 1)
        r -= math.log10(d)
    return r


def bayes_gt(ref: int, alt: int, is_dup: bool) -> List[float]:
    """log10 genotype likelihoods for (0/0, 0/1, 1/1)."""
    probs = ALT_PROBS_DUP if is_dup else ALT_PROBS
    n = ref + alt
    lc = log_choose(n, alt)
    return [
        lc + alt * math.log10(p) + ref * math.log10(1 - p) for p in probs
    ]


class GenotypeResult:
    """One sample × variant genotype call + all FORMAT ingredients."""

    __slots__ = (
        "null",
        "gt_idx",
        "gt_string",
        "gl",
        "gq",
        "sq",
        "qr",
        "qa",
        "counts",
        "ab",
    )

    def __init__(self) -> None:
        self.null = True
        self.gt_idx = -1
        self.gt_string = "./."
        self.gl: Optional[List[float]] = None
        self.gq: Optional[int] = None
        self.sq: Optional[float] = None
        self.qr = 0
        self.qa = 0
        self.counts: Optional[Tuple[float, float, float, float, float]] = None
        self.ab: Optional[float] = None


def genotype_from_counts(
    ref_seq: float,
    alt_seq: float,
    alt_clip: float,
    ref_span: float,
    alt_span: float,
    is_dup: bool,
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
) -> GenotypeResult:
    """SPEC.md §5: weighted counts → QR/QA → GL → GT/GQ/SQ."""
    out = GenotypeResult()
    out.counts = (ref_seq, alt_seq, alt_clip, ref_span, alt_span)
    if ref_seq + alt_seq + alt_clip + ref_span + alt_span <= 0:
        return out
    alt_splitters = alt_seq + alt_clip
    qr = int(split_weight * ref_seq) + int(disc_weight * ref_span)
    qa = int(split_weight * alt_splitters) + int(disc_weight * alt_span)
    out.qr, out.qa = qr, qa
    gl = bayes_gt(qr, qa, is_dup)
    order = sorted(range(3), key=lambda i: (-gl[i], i))
    best, second = order[0], order[1]
    gt_sum = sum(10.0**g for g in gl)
    if gt_sum <= 0:
        return out
    gt_sum_log = math.log10(gt_sum)
    out.sq = abs(-10.0 * (gl[0] - gt_sum_log))
    out.gq = int(min(-10.0 * (gl[second] - gl[best]), MAX_GQ))
    out.gl = gl
    out.gt_idx = best
    out.gt_string = GT_STRINGS[best]
    out.null = False
    denom = ref_seq + ref_span + alt_splitters + alt_span
    if denom > 0:
        out.ab = (alt_splitters + alt_span) / denom
    return out
