"""Genotype → VCF FORMAT-field emission (SPEC.md §6, SURVEY.md §2.4).

Shared by every engine path (oracle, TPU, CLI) so the byte-parity
surface lives in exactly one place.
"""

from __future__ import annotations

from typing import List

from svtyper_tpu_torch.models.bayes import GenotypeResult
from svtyper_tpu_torch.utils.formatting import fmt_f2, fmt_g2, fmt_gl, trunc_int
from svtyper_tpu_torch.vcfio.model import Variant, Vcf

# FORMAT fields appended to the header, in emission order (SURVEY.md §2.4)
FORMAT_DEFS = [
    ("GT", 1, "String", "Genotype"),
    ("GQ", 1, "Integer", "Genotype quality"),
    ("SQ", 1, "Float",
     "Phred-scaled probability that this site is variant (non-reference in this sample)"),
    ("GL", "G", "Float",
     "Genotype Likelihood, log10-scaled likelihoods of the data given the called genotype for each possible genotype generated from the reference and alternate alleles given the sample ploidy"),
    ("DP", 1, "Integer", "Read depth"),
    ("RO", 1, "Integer", "Reference allele observation count, with partial observations recorded fractionally"),
    ("AO", "A", "Integer", "Alternate allele observations, with partial observations recorded fractionally"),
    ("QR", 1, "Integer", "Sum of quality of reference observations"),
    ("QA", "A", "Integer", "Sum of quality of alternate observations"),
    ("RS", 1, "Integer", "Reference allele split-read observation count, with partial observations recorded fractionally"),
    ("AS", "A", "Integer", "Alternate allele split-read observation count, with partial observations recorded fractionally"),
    ("ASC", "A", "Integer", "Alternate allele clipped-read observation count, with partial observations recorded fractionally"),
    ("RP", 1, "Integer", "Reference allele paired-end observation count, with partial observations recorded fractionally"),
    ("AP", "A", "Integer", "Alternate allele paired-end observation count, with partial observations recorded fractionally"),
    ("AB", "A", "Float", "Allele balance, fraction of observations from alternate allele, QA/(QR+QA)"),
]


def add_format_headers(vcf: Vcf) -> None:
    for fid, number, ftype, desc in FORMAT_DEFS:
        vcf.add_format(fid, number, ftype, desc)


def apply_result(var: Variant, sample_name: str, res: GenotypeResult) -> None:
    """Write one sample's FORMAT fields onto the variant."""
    g = var.genotype(sample_name)
    g.set_format("GT", res.gt_string)
    if res.null:
        return
    ref_seq, alt_seq, alt_clip, ref_span, alt_span = res.counts
    alt_splitters = alt_seq + alt_clip
    g.set_format("GQ", str(res.gq))
    g.set_format("SQ", fmt_f2(res.sq))
    g.set_format("GL", fmt_gl(res.gl))
    g.set_format(
        "DP", str(trunc_int(ref_seq + ref_span + alt_seq + alt_clip + alt_span))
    )
    g.set_format("RO", str(trunc_int(ref_seq + ref_span)))
    g.set_format("AO", str(trunc_int(alt_splitters + alt_span)))
    g.set_format("QR", str(res.qr))
    g.set_format("QA", str(res.qa))
    g.set_format("RS", str(trunc_int(ref_seq)))
    g.set_format("AS", str(trunc_int(alt_seq)))
    g.set_format("ASC", str(trunc_int(alt_clip)))
    g.set_format("RP", str(trunc_int(ref_span)))
    g.set_format("AP", str(trunc_int(alt_span)))
    g.set_format("AB", fmt_g2(res.ab) if res.ab is not None else ".")


def apply_variant(
    var: Variant,
    sample_names: List[str],
    results: List[GenotypeResult],
    sum_quals: bool = False,
) -> None:
    """All samples + QUAL aggregation (SPEC.md §5 last rule)."""
    qual = var.qual if sum_quals else 0.0
    for name, res in zip(sample_names, results):
        apply_result(var, name, res)
        if not res.null and res.gt_idx > 0:
            qual += res.sq
    var.qual = qual
    var.genotyped = True
