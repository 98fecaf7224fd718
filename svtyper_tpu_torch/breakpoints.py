"""Breakpoint resolution from VCF records (SPEC.md §2, SURVEY.md §3.2).

Shared by the oracle, the vectorized evidence engine, and the CLIs.
Reconstruction of the per-variant preamble of ``classic.py::sv_genotype``.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

from svtyper_tpu_torch.vcfio.model import Variant

SUPPORTED_SVTYPES = ("DEL", "DUP", "INV", "BND")

_BND_RE = re.compile(r"([\[\]])([^\[\]:]+):(\d+)([\[\]])")


class Breakpoint:
    """Resolved A/B breakpoint pair with orientations and CIs.

    Positions are 0-based (``pos0 = VCF POS - 1``). ``o1_rev/o2_rev``
    encode strand orientation at A/B ('-' when True).
    """

    __slots__ = (
        "svtype",
        "chrom_a",
        "pos_a",
        "ci_a",
        "chrom_b",
        "pos_b",
        "ci_b",
        "o1_rev",
        "o2_rev",
        "var_length",
    )

    def __init__(self, svtype, chrom_a, pos_a, ci_a, chrom_b, pos_b, ci_b,
                 o1_rev, o2_rev, var_length):
        self.svtype = svtype
        self.chrom_a = chrom_a
        self.pos_a = pos_a
        self.ci_a = ci_a
        self.chrom_b = chrom_b
        self.pos_b = pos_b
        self.ci_b = ci_b
        self.o1_rev = o1_rev
        self.o2_rev = o2_rev
        self.var_length = var_length

    @property
    def is_del(self) -> bool:
        return self.svtype == "DEL"

    @property
    def is_dup(self) -> bool:
        return self.svtype == "DUP"

    @property
    def is_inv(self) -> bool:
        return self.svtype == "INV"

    def ci_width(self) -> int:
        # computed fresh each call: callers may copy+mutate ci_a/ci_b, so
        # a memo here goes stale (it crashed round 2 — VERDICT.md Weak #3)
        return max(abs(v) for v in (*self.ci_a, *self.ci_b))


def parse_ci(text: Optional[str]) -> Tuple[int, int]:
    if not text:
        return (0, 0)
    parts = text.split(",")
    return (int(parts[0]), int(parts[1]) if len(parts) > 1 else int(parts[0]))


def parse_bnd_alt(alt: str) -> Optional[Tuple[str, int, bool, bool]]:
    """ALT bracket notation → (chrom_b, pos_b0, o1_rev, o2_rev).

    ``t[p[``→(F,T)  ``t]p]``→(F,F)  ``]p]t``→(T,F)  ``[p[t``→(T,T)
    (SPEC.md §2).
    """
    m = _BND_RE.search(alt)
    if not m:
        return None
    chrom_b = m.group(2)
    pos_b = int(m.group(3)) - 1
    o1_rev = alt[0] in "[]"
    o2_rev = "[" in alt
    return chrom_b, pos_b, o1_rev, o2_rev


def fetch_windows(bp: Breakpoint, flank: int) -> list:
    """Disjoint fetch windows for both breakpoints (SPEC.md §3).

    A and B windows are merged when they overlap on the same chromosome
    so every read is decoded exactly once; the merged list preserves the
    A-then-B read order of the reference's two-fetch gather (overlap
    reads appear at their sorted position, which coincides — see
    evidence/extract.py). Used by both the oracle and the engine so
    their batches are row-identical.
    """
    wins = []
    for chrom, p0, ci in ((bp.chrom_a, bp.pos_a, bp.ci_a),
                          (bp.chrom_b, bp.pos_b, bp.ci_b)):
        wins.append((chrom, p0 + ci[0] - flank, p0 + ci[1] + flank + 1))
    (ca, la, ha), (cb, lb, hb) = wins
    if ca == cb and la <= hb and lb <= ha:
        return [(ca, min(la, lb), max(ha, hb))]
    if ca == cb and lb < la:
        # same chrom with B left of A (possible for BND): fetch in
        # coordinate order so the batch stays coordinate-sorted per
        # variant
        return [wins[1], wins[0]]
    return wins


class _BndMeta:
    __slots__ = ("idx", "chrom", "pos", "alt", "cipos", "ciend",
                 "secondary", "mate_id")

    def __init__(self, idx, chrom, pos, alt, cipos, ciend, secondary,
                 mate_id):
        self.idx = idx
        self.chrom = chrom
        self.pos = pos
        self.alt = alt
        self.cipos = cipos
        self.ciend = ciend
        self.secondary = secondary
        self.mate_id = mate_id


class BndRegistry:
    """Mate-aware BND resolution (SURVEY.md §3.2; SPEC.md §8.8).

    A cheap pre-scan of the VCF body records every BND's coordinates,
    ALT brackets, CIPOS and SECONDARY/MATEID flags. ``resolve`` then
    maps BOTH records of a breakend pair to one shared ``Breakpoint``,
    anchored at the event's primary record (the non-SECONDARY one; ties
    broken by input order), with the B-side confidence interval sourced
    from the mate record's own CIPOS — the reference genotypes a BND
    pair once, when the second record arrives, using each record's own
    CIPOS for its side of the event (``classic.py`` breakend cache,
    SURVEY §3.2 [MUST-VERIFY]). Breakends whose mate is absent from the
    file fall back to standalone resolution (own CIEND, else CIPOS).
    """

    def __init__(self) -> None:
        self._meta: dict = {}
        self._bp_cache: dict = {}

    def scan(self, body_lines) -> None:
        for idx, line in enumerate(body_lines):
            cols = line.split("\t", 8)
            if len(cols) < 8 or "SVTYPE=BND" not in cols[7]:
                continue
            cipos = ciend = None
            secondary = False
            mate_id = None
            for field in cols[7].split(";"):
                if field.startswith("CIPOS="):
                    cipos = field[6:]
                elif field.startswith("CIEND="):
                    ciend = field[6:]
                elif field.startswith("MATEID="):
                    mate_id = field[7:]
                elif field == "SECONDARY" or field.startswith("SECONDARY="):
                    secondary = True
            self._meta[cols[2]] = _BndMeta(
                idx, cols[0], int(cols[1]), cols[4], cipos, ciend,
                secondary, mate_id,
            )

    def mate_known(self, var_id: str) -> bool:
        me = self._meta.get(var_id)
        return bool(
            me and me.mate_id is not None and me.mate_id in self._meta
        )

    def _bp_from_meta(
        self, anchor: "_BndMeta", other: "_BndMeta"
    ) -> Optional[Breakpoint]:
        parsed = parse_bnd_alt(anchor.alt)
        if parsed is None:
            return None
        chrom_b, pos_b, o1_rev, o2_rev = parsed
        return Breakpoint(
            "BND", anchor.chrom, anchor.pos - 1, parse_ci(anchor.cipos),
            chrom_b, pos_b, parse_ci(other.cipos), o1_rev, o2_rev, None,
        )

    def resolve(self, var: Variant) -> Optional[Breakpoint]:
        """Shared-anchor resolution for BNDs; plain for everything else."""
        if var.get_info("SVTYPE") != "BND":
            return resolve_breakpoint(var)
        me = self._meta.get(var.var_id)
        mate = self._meta.get(me.mate_id) if me and me.mate_id else None
        if me is None or mate is None:
            return resolve_breakpoint(var)
        key = (min(var.var_id, me.mate_id), max(var.var_id, me.mate_id))
        if key in self._bp_cache:
            return self._bp_cache[key]
        if me.secondary != mate.secondary:
            anchor, other = (mate, me) if me.secondary else (me, mate)
        else:
            anchor, other = (me, mate) if me.idx <= mate.idx else (mate, me)
        bp = self._bp_from_meta(anchor, other)
        if bp is None:  # unparseable anchor ALT: fall back per record
            return resolve_breakpoint(var)
        self._bp_cache[key] = bp
        return bp


def resolve_breakpoint(var: Variant) -> Optional[Breakpoint]:
    """None for unsupported SVTYPEs (record passes through un-genotyped)."""
    svtype = var.get_info("SVTYPE")
    if svtype not in SUPPORTED_SVTYPES:
        return None
    pos0 = var.pos - 1
    ci_a = parse_ci(var.get_info("CIPOS"))
    ci_b = parse_ci(var.get_info("CIEND")) if var.get_info("CIEND") else ci_a
    if svtype == "BND":
        parsed = parse_bnd_alt(var.alt)
        if parsed is None:
            return None
        chrom_b, pos_b, o1_rev, o2_rev = parsed
        if not var.get_info("CIEND"):
            ci_b = ci_a
        return Breakpoint(
            "BND", var.chrom, pos0, ci_a, chrom_b, pos_b, ci_b,
            o1_rev, o2_rev, None,
        )
    end_text = var.get_info("END")
    if end_text is None:
        return None
    end0 = int(end_text) - 1
    if svtype == "DEL":
        o1_rev, o2_rev = False, True
    elif svtype == "DUP":
        o1_rev, o2_rev = True, False
    else:  # INV: primary (+,+); the evidence layer also tries (-,-)
        o1_rev, o2_rev = False, False
    return Breakpoint(
        svtype, var.chrom, pos0, ci_a, var.chrom, end0, ci_b,
        o1_rev, o2_rev, end0 - pos0,
    )
