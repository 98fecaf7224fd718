"""Device evidence classification (SPEC.md §4) in PyTorch.

Counterpart of ``svtyper_tpu.evidence.device``, both of its classifiers:

- ``classify_compact``, the engine's: the host has already evaluated the
  integer window/strand/straddle predicates into flag bits
  (``evidence/extract.py::compact_chunk``); this applies every float op
  — prob_mapq weighting, the §4.3 insert-density re-partition and the
  per-variant sums;
- ``classify``, the semantic reference: every window, strand and
  straddle predicate evaluated on the device from the full read and pair
  columns (``ChunkInputs``), in the JAX function's op order. It gives
  ``classify_compact``'s counts bit for bit.

Both return ``[n_var, 5]`` counts.

Two choices keep the counts reproducible, because DP/RO/AO/RS/AS/ASC/
RP/AP and QR/QA are truncations of these sums and a one-ulp change can
flip them:

- ``prob_mapq`` is a 256-entry table built on the host with the oracle's
  own expression and gathered, so it is identical to the oracle in f64
  and identical between CPU and CUDA in f32 (``torch.pow`` on CUDA is
  not);
- the per-variant sums are ``torch.segment_reduce`` over the sorted
  rows (one sequential sum per segment, in row order, on both devices)
  instead of ``index_add_``, whose CUDA form adds with atomics in an
  order that changes from run to run. Rows in any order (``classify``
  with ``rows_sorted=False``) are first put in variant order by a stable
  sort, which keeps each segment's rows in their input order: the order
  in which XLA's CPU scatter adds them.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from svtyper_tpu_torch.evidence.extract import (
    LIB_INVALID,
    P_ALT,
    P_ALTREC,
    R_CLIPHIT,
    R_COVHIT,
    R_LHIT,
    R_PRIMFIRST,
    R_RHIT,
    VARS_BOOL,
    VARS_I32,
)

SPLIT_SLOP = 7  # SPEC.md §8
PRIOR_CONC, PRIOR_DISC = 0.95, 0.05

# the oracle's prob_mapq (svtyper_tpu/oracle/engine.py) for every mapq
PROB_MAPQ = np.asarray([1.0 - 10.0 ** (-q / 10.0) for q in range(256)])

_IV = {name: i for i, name in enumerate(VARS_I32)}
_IB = {name: i for i, name in enumerate(VARS_BOOL)}


@functools.lru_cache(maxsize=8)
def _prob_mapq_table(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(PROB_MAPQ, dtype=dtype, device=device)


def prob_mapq(mapq: torch.Tensor, dtype) -> torch.Tensor:
    return _prob_mapq_table(mapq.device, dtype)[mapq.long()]


def _sorted_segment_sum(data: torch.Tensor, seg: torch.Tensor, nseg: int):
    """Per-segment sums of ``data`` rows whose segment ids ``seg`` are
    ascending; each segment is summed sequentially in row order."""
    bounds = torch.arange(nseg + 1, device=seg.device, dtype=seg.dtype)
    offsets = torch.searchsorted(seg, bounds)
    return torch.segment_reduce(
        data, "sum", offsets=offsets, axis=0, unsafe=True
    )


def classify_compact(
    cr_u16, cr_u8, cp_u16, cp_i32, cp_u8, v32, v8,
    dens: torch.Tensor,
    n_var: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """Counts from the compact wire format (extract.compact_chunk).

    ``cr_u16``/``cp_u16`` hold the variant index of each read/pair row
    (any integer dtype), ascending, with padding rows at ``n_var`` (the
    trash segment). → counts [n_var, 5]: ref_seq, alt_seq, alt_clip,
    ref_span, alt_span.
    """
    nseg = n_var + 1

    # ---- reads (§4.1 coverage, §4.2 splits/clips)
    rv = cr_u16[0].long()
    mapq, sa_mapq, rf = cr_u8[0], cr_u8[1], cr_u8[2]
    pm = prob_mapq(mapq, dtype)
    spm = prob_mapq(sa_mapq, dtype)
    prim_first = (rf & R_PRIMFIRST) != 0
    l_pm = torch.where(prim_first, pm, spm)
    r_pm = torch.where(prim_first, spm, pm)
    lhit = ((rf & R_LHIT) != 0).to(dtype)
    rhit = ((rf & R_RHIT) != 0).to(dtype)
    ref_seq_c = torch.where((rf & R_COVHIT) != 0, pm, 0.0)
    alt_seq_c = (l_pm * lhit + r_pm * rhit) * 0.5
    alt_clip_c = torch.where((rf & R_CLIPHIT) != 0, pm, 0.0)
    counts_read = torch.stack([ref_seq_c, alt_seq_c, alt_clip_c], dim=1)
    per_var_read = _sorted_segment_sum(counts_read, rv, nseg)

    # ---- pairs (§4.3)
    pv = cp_u16[0].long()
    a_mapq, b_mapq, lu8, pf = cp_u8[0], cp_u8[1], cp_u8[2], cp_u8[3]
    p_pair = prob_mapq(a_mapq, dtype) * prob_mapq(b_mapq, dtype)
    alt = (pf & P_ALT) != 0
    alt_rec = (pf & P_ALTREC) != 0
    refw = (pf >> 2).to(dtype)
    ref_span_c = refw * p_pair * 0.5

    def pgather(row):
        pad = torch.zeros((1,), dtype=row.dtype, device=row.device)
        return torch.cat([row, pad])[pv]

    vlen = pgather(v32[_IV["vlen"]])
    is_del = pgather(v8[_IB["is_del"]]).bool()

    n_lib, W = dens.shape
    ospan = cp_i32[0]
    lib = torch.where(lu8 == LIB_INVALID, -1, lu8.long())
    lib_safe = torch.clamp(lib, 0, n_lib - 1)

    def dens_at(x):
        ok = (x >= 0) & (x < W) & (lib >= 0)
        return torch.where(ok, dens[lib_safe, torch.clamp(x, 0, W - 1).long()], 0.0)

    d_conc = dens_at(ospan)
    d_disc = dens_at(ospan - vlen)
    denom = PRIOR_CONC * d_conc + PRIOR_DISC * d_disc
    has_denom = denom > 0
    p_conc = torch.where(
        has_denom,
        PRIOR_CONC * d_conc / torch.where(has_denom, denom, 1.0),
        0.0,
    )
    del_move = torch.where(is_del & alt & has_denom, (1.0 - p_conc) * p_pair, 0.0)
    alt_span_c = (
        del_move
        + torch.where(alt & ~is_del, p_pair, 0.0)
        + torch.where(alt_rec, p_pair, 0.0)
    )
    ref_span_c = ref_span_c - del_move
    counts_pair = torch.stack([ref_span_c, alt_span_c], dim=1)
    per_var_pair = _sorted_segment_sum(counts_pair, pv, nseg)

    return torch.cat(
        [per_var_read[:n_var], per_var_pair[:n_var]], dim=1
    ).to(dtype)


def _segment_sum(data: torch.Tensor, seg: torch.Tensor, nseg: int,
                 rows_sorted: bool):
    """Per-segment sums of ``data`` rows; rows of one segment are added
    in their input order whether or not ``seg`` is ascending."""
    if not rows_sorted:
        seg, order = torch.sort(seg, stable=True)
        data = data[order]
    return _sorted_segment_sum(data, seg, nseg)


def _edge_in_window(pos, end, tid, bp_tid, bp_pos, ci0, ci1, o_rev):
    """SPEC.md §4.2: '+' edge = end-1, '-' edge = pos, within CI ± slop."""
    edge = torch.where(o_rev, pos, end - 1)
    return (
        (tid == bp_tid)
        & (edge >= bp_pos + ci0 - SPLIT_SLOP)
        & (edge <= bp_pos + ci1 + SPLIT_SLOP)
    )


def _straddle(
    a_pos, a_end, a_rev, a_aln, a_tid,
    b_pos, b_end, b_rev, b_aln, b_tid,
    tid1, p1, ci10, ci11, tid2, p2, ci20, ci21,
    o1, o2, min_aligned,
):
    """SPEC.md §4.3 pair-straddle predicate, elementwise over pairs."""
    ok = (
        (a_rev == o1) & (b_rev == o2)
        & (a_tid == tid1) & (b_tid == tid2)
        & (a_aln >= min_aligned) & (b_aln >= min_aligned)
    )
    # bracket test (SPEC.md §4.3): forward read starts at-or-left,
    # reverse read ends at-or-right of its breakpoint
    a_side = torch.where(o1, a_end - 1 >= p1 + ci10, a_pos <= p1 + ci11)
    b_side = torch.where(o2, b_end - 1 >= p2 + ci20, b_pos <= p2 + ci21)
    return ok & a_side & b_side


def classify(
    reads: Dict[str, torch.Tensor],
    pairs: Dict[str, torch.Tensor],
    variants: Dict[str, torch.Tensor],
    dens: torch.Tensor,  # [n_libs, max_insert+1]
    n_var: int,
    min_aligned: int,
    dtype=torch.float32,
    rows_sorted: bool = False,
) -> torch.Tensor:
    """Counts from the full columns of ``extract.ChunkInputs`` (each a
    tensor, all on ``dens``'s device), rows in any order unless
    ``rows_sorted`` says they ascend by variant, padding rows at
    ``var == n_var``. → counts [n_var, 5]: ref_seq, alt_seq, alt_clip,
    ref_span, alt_span."""
    nseg = n_var + 1  # trailing trash segment for padding rows

    def vgather(name, idx):
        col = variants[name]
        pad = torch.zeros((1,), dtype=col.dtype, device=col.device)
        return torch.cat([col, pad])[idx]

    rv = reads["var"].long()
    v = {name: vgather(name, rv) for name in (
        "tid_a", "pos_a", "cia0", "cia1", "tid_b", "pos_b", "cib0", "cib1",
        "o1", "o2",
    )}
    pm = prob_mapq(reads["mapq"], dtype)

    # ---- §4.1 reference-sequencing reads
    ref_seq_c = torch.where(reads["cov_a"] | reads["cov_b"], pm, 0.0)

    # ---- §4.2 SA splits
    same_strand_req = v["o1"] != v["o2"]
    pieces_same = reads["is_rev"] == reads["sa_rev"]
    sa_ok = reads["has_sa"] & (pieces_same == same_strand_req)
    prim_first = reads["lead"] <= reads["sa_lead"]

    def pick(prim, sa):
        return torch.where(prim_first, prim, sa), torch.where(prim_first, sa, prim)

    L_pos, R_pos = pick(reads["pos"], reads["sa_pos"])
    L_end, R_end = pick(reads["end"], reads["sa_end"])
    L_tid, R_tid = pick(reads["tid"], reads["sa_tid"])
    L_pm, R_pm = pick(pm, prob_mapq(reads["sa_mapq"], dtype))

    def win(pp, pe, pt, side):
        if side == "a":
            return _edge_in_window(
                pp, pe, pt, v["tid_a"], v["pos_a"], v["cia0"], v["cia1"], v["o1"]
            )
        return _edge_in_window(
            pp, pe, pt, v["tid_b"], v["pos_b"], v["cib0"], v["cib1"], v["o2"]
        )

    a1L, a1R = win(L_pos, L_end, L_tid, "a"), win(R_pos, R_end, R_tid, "b")
    a2L, a2R = win(L_pos, L_end, L_tid, "b"), win(R_pos, R_end, R_tid, "a")
    use1 = (a1L.to(torch.int32) + a1R) >= (a2L.to(torch.int32) + a2R)
    lr0 = torch.where(use1, a1L, a2L)
    lr1 = torch.where(use1, a1R, a2R)
    p_alt = (L_pm * lr0 + R_pm * lr1) * 0.5
    alt_seq_c = torch.where(sa_ok, p_alt, 0.0)

    # ---- §4.2 soft-clip pseudo-splits
    has_clip = reads["has_lsoft"] | reads["has_rsoft"]

    def clip_sup(side):
        o = v["o1"] if side == "a" else v["o2"]
        fwd_ok = (~o) & reads["has_rsoft"] & win(
            reads["pos"], reads["end"], reads["tid"], side
        )
        rev_ok = o & reads["has_lsoft"] & win(
            reads["pos"], reads["end"], reads["tid"], side
        )
        return fwd_ok | rev_ok

    clip_hit = (~reads["has_sa"]) & has_clip & (clip_sup("a") | clip_sup("b"))
    alt_clip_c = torch.where(clip_hit, pm, 0.0)

    counts_read = torch.stack([ref_seq_c, alt_seq_c, alt_clip_c], dim=1)
    per_var_read = _segment_sum(counts_read, rv, nseg, rows_sorted)

    # ---- §4.3 read pairs (self-contained rows: both mates' fields
    # were materialized on host — no gathers into the reads table)
    pv = pairs["var"].long()
    pvf = {name: vgather(name, pv) for name in (
        "tid_a", "pos_a", "cia0", "cia1", "tid_b", "pos_b", "cib0", "cib1",
        "o1", "o2", "is_del", "is_inv", "vlen",
    )}

    A = dict(pos=pairs["a_pos"], end=pairs["a_end"], rev=pairs["a_rev"],
             aln=pairs["a_aln"], tid=pairs["a_tid"],
             pm=prob_mapq(pairs["a_mapq"], dtype), lib=pairs["a_lib"])
    B = dict(pos=pairs["b_pos"], end=pairs["b_end"], rev=pairs["b_rev"],
             aln=pairs["b_aln"], tid=pairs["b_tid"],
             pm=prob_mapq(pairs["b_mapq"], dtype))
    p_pair = A["pm"] * B["pm"]
    F, T = torch.zeros_like(pvf["o1"]), torch.ones_like(pvf["o1"])

    def strad(t1, p1, c10, c11, t2, p2, c20, c21, o1, o2):
        return _straddle(
            A["pos"], A["end"], A["rev"], A["aln"], A["tid"],
            B["pos"], B["end"], B["rev"], B["aln"], B["tid"],
            t1, p1, c10, c11, t2, p2, c20, c21, o1, o2, min_aligned,
        )

    at = (pvf["tid_a"], pvf["pos_a"], pvf["cia0"], pvf["cia1"])
    bt = (pvf["tid_b"], pvf["pos_b"], pvf["cib0"], pvf["cib1"])
    ref_a = strad(*at, *at, F, T)
    ref_b = strad(*bt, *bt, F, T)
    ref_gate = (ref_a | ref_b) & (~(ref_a & ref_b) | pvf["is_del"])
    ref_span_c = torch.where(
        ref_gate,
        (ref_a.to(dtype) + ref_b.to(dtype)) * p_pair * 0.5,
        0.0,
    )
    alt = strad(*at, *bt, pvf["o1"], pvf["o2"])
    alt_rec = pvf["is_inv"] & strad(*at, *bt, ~pvf["o1"], ~pvf["o2"])

    # DEL concordance re-partition (§4.3): dens lookups per pair
    n_lib, W = dens.shape
    ospan = B["end"] - A["pos"]
    lib = A["lib"].long()
    lib_safe = torch.clamp(lib, 0, n_lib - 1)

    def dens_at(x):
        ok = (x >= 0) & (x < W) & (lib >= 0)
        return torch.where(ok, dens[lib_safe, torch.clamp(x, 0, W - 1).long()], 0.0)

    d_conc = dens_at(ospan)
    d_disc = dens_at(ospan - pvf["vlen"])
    denom = PRIOR_CONC * d_conc + PRIOR_DISC * d_disc
    has_denom = denom > 0
    p_conc = torch.where(
        has_denom,
        PRIOR_CONC * d_conc / torch.where(has_denom, denom, 1.0),
        0.0,
    )
    del_move = torch.where(
        pvf["is_del"] & alt & has_denom, (1.0 - p_conc) * p_pair, 0.0
    )
    alt_span_c = (
        del_move
        + torch.where(alt & ~pvf["is_del"], p_pair, 0.0)
        + torch.where(alt_rec, p_pair, 0.0)
    )
    ref_span_c = ref_span_c - del_move

    counts_pair = torch.stack([ref_span_c, alt_span_c], dim=1)
    per_var_pair = _segment_sum(counts_pair, pv, nseg, rows_sorted)

    return torch.cat(
        [per_var_read[:n_var], per_var_pair[:n_var]], dim=1
    ).to(dtype)
