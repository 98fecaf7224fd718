"""Vectorized FORMAT-field emission for the streaming CLI.

Byte-identical twin of ``output.apply_variant`` + ``Variant.
get_var_string`` (SPEC.md §6, SURVEY.md §2.4), operating on the
engine's packed per-sample ``[chunk, 24]`` result matrices instead of
per-variant ``GenotypeResult`` objects: the reference emits each
record with 15 ``set_format`` string ops per sample plus a field sort
per variant (``parsers.py::Genotype.set_format``/``get_gt_string``),
which at engine throughput (>15k variants/s) made Python emission the
CLI's largest cost (VERDICT r4 Weak #2). Here every numeric column is
formatted chunk-at-a-time from numpy in the exact printf formats of
the output contract; per-variant objects survive only on the paths
that need them (BND mate sharing, records with pre-existing sample
columns, ``--debug``).

Parity is enforced by ``tests/test_fast_emit.py``: the fast path must
produce byte-identical output to the object path on every fixture.

This is a copy of ``svtyper_tpu/cli/fast_emit.py`` whose only changes
are its imports: the row layout comes from the port's jax-free
``gt/engine.py``, ``GT_STRINGS`` and ``FORMAT_DEFS`` from the port's
``models/bayes.py`` and ``output.py`` (``tests/test_torch_cli.py`` holds
the two together).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from svtyper_tpu_torch.gt.engine import INT_FIELDS, _I, _to_result
from svtyper_tpu_torch.models.bayes import GT_STRINGS
from svtyper_tpu_torch.output import FORMAT_DEFS, apply_variant

_NI = len(INT_FIELDS)
FIELD_ORDER = tuple(f[0] for f in FORMAT_DEFS)
FORMAT_COL = ":".join(FIELD_ORDER)
# a null sample on a variant where ANY sample is non-null: GT set,
# every other active field missing → "." (Genotype.get_gt_string)
NULL_PADDED = "./." + ":." * (len(FIELD_ORDER) - 1)

# records whose pre-existing sample columns carry at most a GT value
# (LUMPY emits "GT\t./." placeholders) take the fast path: apply_result
# overwrites GT unconditionally, so nothing from the input survives.
# ANY other pre-existing value (e.g. LUMPY SU/PE/SR) must merge through
# the object path.
_GT_ONLY = frozenset(("GT",))

# one printf for the whole sample column, in FIELD_ORDER:
# GT:GQ:SQ:GL(g0,g1,g2):DP:RO:AO:QR:QA:RS:AS:ASC:RP:AP:AB
_ROW_FMT = "%s:%d:%.2f:%.0f,%.0f,%.0f:%d:%d:%d:%d:%d:%d:%d:%d:%d:%d:%s"


def eligible(vcf, sample_names: List[str]) -> bool:
    """The fast formatter hardcodes FIELD_ORDER and the engine's sample
    order; an input header that declares our FORMAT ids in a different
    order (format_rank would interleave them) or carries its own sample
    columns falls back to the object path wholesale."""
    order = sorted(FIELD_ORDER, key=vcf.format_rank)
    return list(order) == list(FIELD_ORDER) and (
        list(vcf.sample_list) == list(sample_names)
    )


def _format_sample(a: np.ndarray, n: int):
    """One sample's packed [chunk, 24] matrix → (null mask, formatted
    column strings, per-variant QUAL contribution). Every numeric op
    mirrors ``output.apply_result`` exactly: float64 upcast first, the
    same left-to-right addition order, int() truncation toward zero."""
    ints = a[:n, :_NI]
    flts = a[:n, _NI:].astype(np.float64)
    null = ints[:, _I["null"]] != 0
    gt_idx = ints[:, _I["gt_idx"]].astype(np.int64)
    ref_seq = flts[:, 5]
    alt_seq = flts[:, 6]
    alt_clip = flts[:, 7]
    ref_span = flts[:, 8]
    alt_span = flts[:, 9]
    sq = flts[:, 3]
    ab_valid = ints[:, _I["ab_valid"]] != 0
    ab = flts[:, 4]
    cols = [
        np.asarray(GT_STRINGS, dtype=object)[np.clip(gt_idx, 0, 2)],
        ints[:, _I["gq"]].astype(np.int64),
        sq,
        flts[:, 0], flts[:, 1], flts[:, 2],  # GL
        (ref_seq + ref_span + alt_seq + alt_clip + alt_span).astype(np.int64),
        (ref_seq + ref_span).astype(np.int64),
        ((alt_seq + alt_clip) + alt_span).astype(np.int64),
        ints[:, _I["qr"]].astype(np.int64),
        ints[:, _I["qa"]].astype(np.int64),
        ref_seq.astype(np.int64),
        alt_seq.astype(np.int64),
        alt_clip.astype(np.int64),
        ref_span.astype(np.int64),
        alt_span.astype(np.int64),
    ]
    ab_strs = [
        ("%.2g" % v) if ok else "."
        for v, ok in zip(ab.tolist(), ab_valid.tolist())
    ]
    lists = [c.tolist() for c in cols]
    strs = [_ROW_FMT % row for row in zip(*lists, ab_strs)]
    qual_add = np.where(~null & (gt_idx > 0), sq, 0.0)
    return null, strs, qual_add


def format_chunk_lines(
    vars_: list,
    bps: list,
    per_sample: List[np.ndarray],
    sample_names: List[str],
    sum_quals: bool,
    bnd_results: Dict[str, list],
    bnd_computed: Set[str],
    registry,
    debug_rows: Optional[list] = None,
) -> List[str]:
    """One chunk's output lines from the packed result matrices.

    Per-variant object fallbacks (all byte-identical to the slow path):
    ``bp is None`` → verbatim passthrough; BND → GenotypeResult round
    trip so mate sharing keeps using the same ``bnd_results`` dict as
    the object path; a record with pre-existing sample values beyond a
    bare GT → full ``apply_variant`` (its emission merges with the
    input fields).
    """
    n = len(vars_)
    nulls = []
    strs = []
    qual_adds = []
    for a in per_sample:
        nl, st, qa = _format_sample(a, n)
        nulls.append(nl)
        strs.append(st)
        qual_adds.append(qa.tolist())
    any_nonnull = ~nulls[0] if nulls else np.zeros(n, bool)
    for nl in nulls[1:]:
        any_nonnull |= ~nl
    out: List[str] = []
    for i, (v, bp) in enumerate(zip(vars_, bps)):
        if bp is None:
            out.append(v.get_var_string() + "\n")
            continue
        if bp.svtype == "BND" or not v.active_formats <= _GT_ONLY:
            # object path for this variant (same state dicts as the
            # slow drive, so fast and slow chunks interleave safely)
            res_row = [_to_result(ps, i) for ps in per_sample]
            if bp.svtype == "BND":
                mate_id = v.get_info("MATEID")
                if mate_id and mate_id in bnd_results:
                    res_row = bnd_results.pop(mate_id)
                    bnd_computed.discard(mate_id)
                elif mate_id and registry.mate_known(v.var_id):
                    bnd_results[v.var_id] = res_row
            apply_variant(v, sample_names, res_row, sum_quals=sum_quals)
            if debug_rows is not None:
                debug_rows.append((v, res_row))
            out.append(v.get_var_string() + "\n")
            continue
        # EXACT apply_variant order: start from the input QUAL (with
        # -q) and add per-sample SQ left to right — float addition is
        # non-associative, so pre-summing the samples and adding the
        # base last could differ by an ulp and round "%.2f" differently
        # (review, r5)
        qual = v.qual if sum_quals else 0.0
        for qa in qual_adds:
            qual += qa[i]
        if any_nonnull[i]:
            fmt = FORMAT_COL
            samples = [
                NULL_PADDED if nulls[s][i] else strs[s][i]
                for s in range(len(per_sample))
            ]
        else:
            fmt = "GT"
            samples = ["./."] * len(per_sample)
        cols = v.cols
        out.append(
            "\t".join(
                (cols[0], cols[1], cols[2], cols[3], cols[4],
                 "%.2f" % qual, cols[6], cols[7], fmt, *samples)
            )
            + "\n"
        )
    return out
