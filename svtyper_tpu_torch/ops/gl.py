"""Batched genotype-likelihood stage (SPEC.md §5) in PyTorch.

Counterpart of ``svtyper_tpu.ops.gl``: [N,5] evidence counts → QR/QA
(trunc toward zero) → log10 GLs → GT/GQ/SQ/AB and the truncated FORMAT
count fields, with both of the reference's branches in their exact op
order:

- float64 (the oracle-parity path): lc from a cumulative log10-factorial
  table folded into the scores, and the sum as ``10**(s-m)``;
- float32: lc-free scores from the f64-rounded ``LOG_P_TABLE`` /
  ``LOG_Q_TABLE`` constants, and the sum as ``exp((s-m)*LN10)``.

The float32 stage that the engine runs is the fused CUDA kernel in
``ops/gl_kernel.py``; this module is the float64 path and the reference
its float32 branch is tested against.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch

from svtyper_tpu.models.bayes import ALT_PROBS, ALT_PROBS_DUP

MAX_GQ = 200.0
# smallest float64 subnormal is 10**-323.6; below that the oracle's naive
# sum(10**gl) is exactly 0 and it emits a null genotype
LOG10_TINY = -323.6
LN10 = math.log(10.0)

# log10 p / log10 (1-p) per genotype, rows (non-dup, dup), rounded once
# in float64 with the oracle's own math.log10 (models/bayes.py::bayes_gt)
LOG_P_TABLE = np.asarray(
    [[math.log10(p) for p in ALT_PROBS],
     [math.log10(p) for p in ALT_PROBS_DUP]]
)
LOG_Q_TABLE = np.asarray(
    [[math.log10(1.0 - p) for p in ALT_PROBS],
     [math.log10(1.0 - p) for p in ALT_PROBS_DUP]]
)


@functools.lru_cache(maxsize=4)
def log_choose_table(max_n: int, use_f64: bool = True) -> np.ndarray:
    """lcf[i] = sum_{d=1..i} log10(d), so
    log10 C(n,k) = lcf[n] - lcf[k] - lcf[n-k]."""
    dt = np.float64 if use_f64 else np.float32
    v = np.zeros(max_n + 1, dtype=dt)
    v[1:] = np.cumsum(np.log10(np.arange(1, max_n + 1, dtype=np.float64)))
    return v.astype(dt)


def _per_genotype(table: np.ndarray, is_dup: torch.Tensor, dtype):
    """[N,3] row of ``table`` picked by is_dup (dup row 1, else row 0)."""
    t = torch.as_tensor(table, dtype=dtype, device=is_dup.device)
    return torch.where(is_dup[:, None], t[1], t[0])


def genotype_batch(
    counts: torch.Tensor,  # [N,5] ref_seq, alt_seq, alt_clip, ref_span, alt_span
    is_dup: torch.Tensor,  # [N] bool
    force_null: torch.Tensor,  # [N] bool
    lcf: torch.Tensor,  # [MAXN+1] log10-factorial table
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
) -> Dict[str, torch.Tensor]:
    dtype = counts.dtype
    is_dup = is_dup.bool()
    force_null = force_null.bool()
    ref_seq = counts[:, 0]
    alt_seq = counts[:, 1]
    alt_clip = counts[:, 2]
    ref_span = counts[:, 3]
    alt_span = counts[:, 4]
    alt_splitters = alt_seq + alt_clip
    total = ref_seq + alt_seq + alt_clip + ref_span + alt_span

    qr = torch.trunc(split_weight * ref_seq) + torch.trunc(disc_weight * ref_span)
    qa = torch.trunc(split_weight * alt_splitters) + torch.trunc(disc_weight * alt_span)
    n = qr + qa
    k = qa

    maxn = lcf.shape[0] - 1
    ni = torch.clamp(n, 0, maxn).long()
    ki = torch.clamp(k, 0, maxn).long()
    nki = torch.clamp(n - k, 0, maxn).long()
    # symmetrized k for the validity test only (matches the reference's
    # degenerate-input behavior: log_choose → 0 when the loop is empty)
    k2 = torch.where(2 * k > n, n - k, k)
    lc_valid = (k2 > 0) & (k >= 0) & (n >= k)
    lc = torch.where(lc_valid, lcf[ni] - lcf[ki] - lcf[nki], 0.0).to(dtype)

    lp = _per_genotype(LOG_P_TABLE, is_dup, dtype)
    lq = _per_genotype(LOG_Q_TABLE, is_dup, dtype)
    if dtype == torch.float64:
        # parity path: the oracle computes GL with the log-choose term
        # folded in and derives GT/GQ/SQ from those floats. log10(p)
        # comes from the host table (math.log10, as the oracle): the
        # vectorized log10 of torch and of XLA both miss libm by an ulp
        # at p = 0.01
        gl = lc[:, None] + k[:, None] * lp + (n - k)[:, None] * lq
        s = gl  # [N,3] — the scores GT/GQ/SQ derive from
    else:
        # float32 path: lc is CONSTANT across the three genotypes, so
        # GT/GQ/SQ come from lc-free scores — bit-identical to the CUDA
        # kernel, whose lc is an lgamma and would otherwise drift GQ ±1
        s = k[:, None] * lp + (n - k)[:, None] * lq  # [N,3]
        gl = lc[:, None] + s

    best = torch.argmax(s, dim=1)  # first max → lowest index on ties
    gl_best = torch.take_along_dim(s, best[:, None], dim=1)[:, 0]
    masked = torch.where(
        torch.nn.functional.one_hot(best, 3).bool(), -math.inf, s
    )
    second = torch.argmax(masked, dim=1)
    gl_second = torch.take_along_dim(s, second[:, None], dim=1)[:, 0]

    # stable log10(sum 10**gl); lc cancels in s[:,0]-log_gt_sum, so the
    # f32 branch's lc-free scores give the same SQ. The three terms are
    # added left to right, as XLA's reduce does.
    m = s.max(dim=1).values
    if dtype == torch.float64:
        e = torch.pow(10.0, s - m[:, None])
    else:
        e = torch.exp((s - m[:, None]) * LN10)
    sum_shift = e[:, 0] + e[:, 1] + e[:, 2]
    log_gt_sum = m + torch.log10(sum_shift)
    # underflow is a property of the true max GL (incl. lc)
    m_gl = m if dtype == torch.float64 else m + lc
    underflow = m_gl < LOG10_TINY

    sq = torch.abs(-10.0 * (s[:, 0] - log_gt_sum))
    gq = torch.trunc(torch.clamp(-10.0 * (gl_second - gl_best), max=MAX_GQ))

    null = force_null | (total <= 0) | underflow
    denom = ref_seq + ref_span + alt_splitters + alt_span
    ab_valid = denom > 0
    ab = torch.where(
        ab_valid,
        (alt_splitters + alt_span) / torch.where(ab_valid, denom, 1.0),
        0.0,
    )

    i32 = torch.int32
    return {
        "null": null,
        "gt_idx": torch.where(null, -1, best).to(i32),
        "gl": gl,
        "gq": gq.to(i32),
        "sq": sq,
        "qr": qr.to(i32),
        "qa": qa.to(i32),
        # DP truncates the sum in the reference's own addition order
        "dp": torch.trunc(
            ref_seq + ref_span + alt_seq + alt_clip + alt_span
        ).to(i32),
        "ro": torch.trunc(ref_seq + ref_span).to(i32),
        "ao": torch.trunc(alt_splitters + alt_span).to(i32),
        "rs": torch.trunc(ref_seq).to(i32),
        "as_": torch.trunc(alt_seq).to(i32),
        "asc": torch.trunc(alt_clip).to(i32),
        "rp": torch.trunc(ref_span).to(i32),
        "ap": torch.trunc(alt_span).to(i32),
        "ab": ab,
        "ab_valid": ab_valid,
        "counts": counts,
    }
