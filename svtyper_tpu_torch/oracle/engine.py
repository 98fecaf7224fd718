"""Per-read oracle implementation of the evidence model + genotyper.

Follows SPEC.md §§3–5 literally (which reconstructs
``svtyper/parsers.py::SamFragment/SplitRead`` and
``classic.py::sv_genotype`` — SURVEY.md §2.2, §3.1). Reads come from
``bamio`` columnar batches but are walked row-by-row here in float64.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.bamio.columns import ReadBatch
from svtyper_tpu_torch.breakpoints import Breakpoint
from svtyper_tpu_torch.models.bayes import GenotypeResult, genotype_from_counts
from svtyper_tpu_torch.stats.library import Sample

SPLIT_SLOP = 7  # SPEC.md §8 [RECON]
Z_FLANK = 3.0
PRIOR_CONC, PRIOR_DISC = 0.95, 0.05


def prob_mapq(mapq: int) -> float:
    return 1.0 - 10.0 ** (-mapq / 10.0)


class _Read:
    """Row view over a ReadBatch (oracle-only convenience)."""

    __slots__ = ("b", "i")

    def __init__(self, batch: ReadBatch, i: int) -> None:
        self.b = batch
        self.i = i

    def __getattr__(self, name):
        return getattr(self.b, name)[self.i]

    @property
    def is_reverse(self) -> bool:
        return bool(self.b.flag[self.i] & 0x10)

    @property
    def blocks(self) -> List[Tuple[int, int]]:
        lo, hi = self.b.blk_off[self.i], self.b.blk_off[self.i + 1]
        return list(zip(self.b.blk_start[lo:hi], self.b.blk_end[lo:hi]))


def _aligned_span_cover(read: _Read, tid: int, p0: int, min_aligned: int) -> bool:
    """SPEC.md §4.1: M/=/X coverage of [p0-min_aligned+1, p0+min_aligned+1)
    must equal 2*min_aligned."""
    if read.tid != tid:
        return False
    lo = p0 - min_aligned + 1
    hi = p0 + min_aligned + 1
    cov = 0
    for bs, be in read.blocks:
        cov += max(0, min(be, hi) - max(bs, lo))
    return cov == 2 * min_aligned


def _split_edge_in_window(
    piece_pos: int,
    piece_end: int,
    piece_tid: int,
    bp_tid: int,
    bp_pos: int,
    ci: Tuple[int, int],
    o_rev: bool,
) -> bool:
    """SPEC.md §4.2 edge test: '+' uses ref_end-1, '-' uses ref_start."""
    if piece_tid != bp_tid:
        return False
    edge = piece_pos if o_rev else piece_end - 1
    return bp_pos + ci[0] - SPLIT_SLOP <= edge <= bp_pos + ci[1] + SPLIT_SLOP


def _straddle(
    ra: _Read,
    rb: _Read,
    tid1: int,
    p1: int,
    ci1: Tuple[int, int],
    tid2: int,
    p2: int,
    ci2: Tuple[int, int],
    o1_rev: bool,
    o2_rev: bool,
    min_aligned: int,
) -> bool:
    """SPEC.md §4.3 pair-straddle predicate."""
    if ra.is_reverse != o1_rev or rb.is_reverse != o2_rev:
        return False
    if ra.tid != tid1 or rb.tid != tid2:
        return False
    if ra.ref_aln_len < min_aligned or rb.ref_aln_len < min_aligned:
        return False
    # bracket test (SPEC.md §4.3): forward read starts at-or-left of its
    # breakpoint, reverse read ends at-or-right
    if o1_rev:
        if ra.ref_end - 1 < p1 + ci1[0]:
            return False
    else:
        if ra.pos > p1 + ci1[1]:
            return False
    if o2_rev:
        if rb.ref_end - 1 < p2 + ci2[0]:
            return False
    else:
        if rb.pos > p2 + ci2[1]:
            return False
    return True


def classify_fragments(
    batch: ReadBatch,
    lib_idx: np.ndarray,
    dens_of_lib,
    bp: Breakpoint,
    tid_a: int,
    tid_b: int,
    min_aligned: int,
) -> Tuple[float, float, float, float, float]:
    """Evidence accumulators (ref_seq, alt_seq, alt_clip, ref_span, alt_span)
    over all fragments in the batch — SPEC.md §4."""
    frags: Dict[int, List[int]] = {}
    for i in range(batch.n):
        frags.setdefault(int(batch.qname_hash[i]), []).append(i)

    ref_seq = alt_seq = alt_clip = ref_span = alt_span = 0.0
    pa, ca, pb, cb = bp.pos_a, bp.ci_a, bp.pos_b, bp.ci_b

    for rows in frags.values():
        reads = [_Read(batch, i) for i in rows]
        # --- reference-sequencing reads (§4.1)
        for r in reads:
            if _aligned_span_cover(r, tid_a, pa, min_aligned) or (
                _aligned_span_cover(r, tid_b, pb, min_aligned)
            ):
                ref_seq += prob_mapq(int(r.mapq))
        # --- split / clipped reads (§4.2)
        for r in reads:
            if r.has_sa:
                same_strand_req = bp.o1_rev != bp.o2_rev
                pieces_same = r.is_reverse == bool(r.sa_is_reverse)
                if pieces_same != same_strand_req:
                    continue
                prim = (int(r.pos), int(r.ref_end), int(r.tid),
                        prob_mapq(int(r.mapq)), int(r.lead_clip_q))
                sa = (int(r.sa_pos), int(r.sa_end), int(r.sa_tid),
                      prob_mapq(int(r.sa_mapq)), int(r.sa_lead_clip_q))
                L, R = (prim, sa) if prim[4] <= sa[4] else (sa, prim)
                # two assignments; more satisfied sides wins, tie → (L→A,R→B)
                a1 = (
                    _split_edge_in_window(L[0], L[1], L[2], tid_a, pa, ca, bp.o1_rev),
                    _split_edge_in_window(R[0], R[1], R[2], tid_b, pb, cb, bp.o2_rev),
                )
                a2 = (
                    _split_edge_in_window(L[0], L[1], L[2], tid_b, pb, cb, bp.o2_rev),
                    _split_edge_in_window(R[0], R[1], R[2], tid_a, pa, ca, bp.o1_rev),
                )
                lr = a1 if sum(a1) >= sum(a2) else a2
                p_alt = (L[3] * lr[0] + R[3] * lr[1]) / 2.0
                if p_alt > 0:
                    alt_seq += p_alt
            elif r.left_soft or r.right_soft:
                sup_a = (
                    (not bp.o1_rev and r.right_soft
                     and _split_edge_in_window(int(r.pos), int(r.ref_end), int(r.tid), tid_a, pa, ca, False))
                    or (bp.o1_rev and r.left_soft
                        and _split_edge_in_window(int(r.pos), int(r.ref_end), int(r.tid), tid_a, pa, ca, True))
                )
                sup_b = (
                    (not bp.o2_rev and r.right_soft
                     and _split_edge_in_window(int(r.pos), int(r.ref_end), int(r.tid), tid_b, pb, cb, False))
                    or (bp.o2_rev and r.left_soft
                        and _split_edge_in_window(int(r.pos), int(r.ref_end), int(r.tid), tid_b, pb, cb, True))
                )
                if sup_a or sup_b:
                    alt_clip += prob_mapq(int(r.mapq))
        # --- read pairs (§4.3)
        primaries = [
            r for r in reads if (r.flag & (0x100 | 0x800)) == 0
            and (r.flag & 0x1) and not (r.flag & 0x8)
        ]
        if len(primaries) == 2:
            ra, rb = primaries
            if (int(ra.tid), int(ra.pos)) > (int(rb.tid), int(rb.pos)):
                ra, rb = rb, ra
            # mate-identity check (qname-hash collision guard): each
            # mate's MRNM/MPOS must point at the other, recovering the
            # reference's exact-qname grouping semantics
            if (
                int(ra.mate_tid) != int(rb.tid)
                or int(ra.mate_pos) != int(rb.pos)
                or int(rb.mate_tid) != int(ra.tid)
                or int(rb.mate_pos) != int(ra.pos)
            ):
                continue
            p_pair = prob_mapq(int(ra.mapq)) * prob_mapq(int(rb.mapq))
            ref_a = _straddle(ra, rb, tid_a, pa, ca, tid_a, pa, ca, False, True, min_aligned)
            ref_b = _straddle(ra, rb, tid_b, pb, cb, tid_b, pb, cb, False, True, min_aligned)
            if (ref_a or ref_b) and (not (ref_a and ref_b) or bp.is_del):
                ref_span += (int(ref_a) + int(ref_b)) * p_pair / 2.0
            alt = _straddle(ra, rb, tid_a, pa, ca, tid_b, pb, cb, bp.o1_rev, bp.o2_rev, min_aligned)
            alt_rec = (
                _straddle(ra, rb, tid_a, pa, ca, tid_b, pb, cb,
                          not bp.o1_rev, not bp.o2_rev, min_aligned)
                if bp.is_inv
                else False
            )
            if alt:
                if bp.is_del:
                    li = int(lib_idx[ra.i])
                    dens = dens_of_lib(li)
                    ospan = int(rb.ref_end) - int(ra.pos)
                    p_conc = _p_concordant(dens, ospan, bp.var_length)
                    if p_conc is not None:
                        alt_span += (1.0 - p_conc) * p_pair
                        ref_span -= (1.0 - p_conc) * p_pair
                else:
                    alt_span += p_pair
            if alt_rec:
                alt_span += p_pair
    return ref_seq, alt_seq, alt_clip, ref_span, alt_span


def _p_concordant(dens, ospan: int, var_length: int) -> Optional[float]:
    """SPEC.md §4.3: P(concordant | ospan) under conc/disc priors."""
    d_conc = dens(ospan)
    d_disc = dens(ospan - var_length)
    denom = PRIOR_CONC * d_conc + PRIOR_DISC * d_disc
    if denom == 0.0:
        return None
    return PRIOR_CONC * d_conc / denom


class OracleEngine:
    """Serial per-variant genotyper over one or more Samples."""

    def __init__(
        self,
        samples: List[Sample],
        min_aligned: int = 20,
        split_weight: float = 1.0,
        disc_weight: float = 1.0,
        max_reads: Optional[int] = None,
        max_ci_dist: float = 1e10,
    ) -> None:
        self.samples = samples
        self.min_aligned = min_aligned
        self.split_weight = split_weight
        self.disc_weight = disc_weight
        self.max_reads = max_reads
        self.max_ci_dist = max_ci_dist

    def genotype_variant(
        self, bp: Optional[Breakpoint]
    ) -> List[GenotypeResult]:
        # None (unsupported SVTYPE) → null rows, mirroring
        # TpuEngine.genotype_chunk so both engines accept the same inputs
        if bp is None:
            return [GenotypeResult() for _ in self.samples]
        out = []
        for sample in self.samples:
            if bp.ci_width() > self.max_ci_dist:
                out.append(GenotypeResult())
                continue
            batch, lib_idx = gather_reads(sample, bp, Z_FLANK)
            if self.max_reads is not None and batch.n > self.max_reads:
                out.append(GenotypeResult())
                continue
            tid_a = sample.bam.header.name_to_tid.get(bp.chrom_a, -1)
            tid_b = sample.bam.header.name_to_tid.get(bp.chrom_b, -1)

            def dens_of_lib(li: int, _s=sample):
                lib = _s.libraries[li] if 0 <= li < len(_s.libraries) else None

                def dens(x: int) -> float:
                    if lib is None or x < 0 or x > lib.max_insert:
                        return 0.0
                    return float(lib.dens_vec[x])

                return dens

            counts = classify_fragments(
                batch, lib_idx, dens_of_lib, bp, tid_a, tid_b, self.min_aligned
            )
            out.append(
                genotype_from_counts(
                    *counts,
                    is_dup=bp.is_dup,
                    split_weight=self.split_weight,
                    disc_weight=self.disc_weight,
                )
            )
        return out


def gather_reads(
    sample: Sample, bp: Breakpoint, z: float = Z_FLANK
) -> Tuple[ReadBatch, np.ndarray]:
    """Fetch + filter reads around both breakpoints (SPEC.md §3).

    Returns the deduplicated batch (a read overlapping both windows is
    kept once) with per-read library indices.
    """
    from svtyper_tpu_torch.breakpoints import fetch_windows

    flank = sample.get_fetch_flank(z)
    parts = [
        sample.bam.fetch(chrom, lo, hi)
        for chrom, lo, hi in fetch_windows(bp, flank)
    ]
    batch = ReadBatch.concat(parts)
    if batch.n:
        # drop duplicates across the two windows (same voffset)
        _, first = np.unique(batch.voffset, return_index=True)
        batch = batch.take(np.sort(first))
        # filter flags + inactive libraries (SPEC.md §3)
        skip = 0x100 | 0x200 | 0x400 | 0x800  # secondary/qcfail/dup/suppl
        lib_idx = sample.assign_libs(batch)
        keep = ((batch.flag & skip) == 0) & sample.is_active_lib(lib_idx)
        idx = np.flatnonzero(keep)
        batch = batch.take(idx)
        lib_idx = lib_idx[idx]
    else:
        lib_idx = np.zeros(0, dtype=np.int32)
    return batch, lib_idx
