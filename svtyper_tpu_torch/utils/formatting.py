"""Byte-exact numeric formatting for the VCF output surface (SPEC.md §6).

These mirror the printf-style formats of the reference output contract
(SURVEY.md §2.4): GL `%.0f`, SQ/QUAL `%.2f`, AB `%.2g`, integer counts
truncated toward zero.
"""

from __future__ import annotations

import math


def trunc_int(x: float) -> int:
    """Python ``int()`` semantics: truncation toward zero.

    ref_span can legitimately be negative after the DEL re-partition
    (SPEC.md §4.3), so this must not be floor().
    """
    return int(x)


def fmt_gl(values) -> str:
    """GL field: comma-joined `%.0f` per genotype likelihood."""
    return ",".join("%.0f" % v for v in values)


def fmt_f2(x: float) -> str:
    return "%.2f" % x


def fmt_g2(x: float) -> str:
    return "%.2g" % x


def phred_from_log10(lp: float) -> float:
    return -10.0 * lp


def log10_sum_exp10(values) -> float:
    """log10(sum(10**v)) computed stably in float64."""
    m = max(values)
    if math.isinf(m):
        return m
    return m + math.log10(sum(10.0 ** (v - m) for v in values))
