"""Device evidence classification (SPEC.md §4) in PyTorch.

Counterpart of ``svtyper_tpu.evidence.device.classify_compact``: the
host has already evaluated the integer window/strand/straddle
predicates into flag bits (``svtyper_tpu.evidence.extract``); this
applies every float op — prob_mapq weighting, the §4.3 insert-density
re-partition and the per-variant sums — and returns ``[n_var, 5]``
counts. The full-column ``classify`` is not ported: it stays the JAX
package's semantic reference.

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
  order that changes from run to run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from svtyper_tpu.evidence.extract import (
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
