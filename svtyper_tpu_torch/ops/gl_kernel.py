"""The fused float32 GL stage: a hand-written CUDA kernel and its twin.

``genotype_rows`` is the engine's float32 GL stage. It replaces
``svtyper_tpu/ops/pallas_gl.py::genotype_batch_pallas``: on a CUDA
tensor it launches ``csrc/gl_kernel.cu`` (one thread per variant,
writing the packed ``[N,24]`` rows directly) and on a CPU tensor it runs
``genotype_rows_plain``, the same function in PyTorch eager with the
same float32 op order. Any other device raises; there is no fallback
from the kernel to the twin.

Both produce, per variant, the 14 ``gt.engine.INT_FIELDS`` as floats
followed by gl0-2, sq, ab and the five counts. The integer fields are
bit-identical between the two (no multiply-add contraction in either);
GL, SQ and AB agree at output-format precision (lgammaf, expf and log10f
on the card against PyTorch's own).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from svtyper_tpu_torch.ops.gl import LOG_P_TABLE, LOG_Q_TABLE

LN10 = math.log(10.0)
MAX_GQ = 200.0
LOG10_TINY = -323.6
ROW_WIDTH = 24

# launches of the CUDA kernel in this process (the smoke reads it to
# show the main path went through the kernel)
LAUNCHES = 0

# lp[2][3] then lq[2][3], each float64 table entry rounded once to f32
_TABLES = np.concatenate(
    [LOG_P_TABLE.reshape(-1), LOG_Q_TABLE.reshape(-1)]
).astype(np.float32)


def genotype_rows_plain(
    counts: torch.Tensor,  # [N,5] float32
    is_dup: torch.Tensor,  # [N] uint8 or bool
    force_null: torch.Tensor,  # [N] uint8 or bool
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
) -> torch.Tensor:
    """PyTorch-eager twin of the CUDA kernel → [N,24] float32 rows."""
    counts = counts.to(torch.float32)
    dev = counts.device
    is_dup = is_dup.bool()
    force_null = force_null.bool()
    rs, as_, ac, rp, ap = counts.unbind(1)

    alt_split = as_ + ac
    total = rs + as_ + ac + rp + ap
    qr = torch.trunc(split_weight * rs) + torch.trunc(disc_weight * rp)
    qa = torch.trunc(split_weight * alt_split) + torch.trunc(disc_weight * ap)
    n = qr + qa
    k = qa

    k2 = torch.where(2.0 * k > n, n - k, k)
    lc_valid = (k2 > 0) & (k >= 0) & (n >= k)
    safe_n = torch.clamp(n, min=0.0)
    safe_k = torch.minimum(torch.clamp(k, min=0.0), safe_n)
    lc = torch.where(
        lc_valid,
        (
            torch.lgamma(safe_n + 1.0)
            - torch.lgamma(safe_k + 1.0)
            - torch.lgamma(safe_n - safe_k + 1.0)
        )
        / LN10,
        0.0,
    )

    tables = torch.as_tensor(_TABLES, device=dev).view(2, 2, 3)
    lp = torch.where(is_dup[:, None], tables[0, 1], tables[0, 0])  # [N,3]
    lq = torch.where(is_dup[:, None], tables[1, 1], tables[1, 0])
    s = k[:, None] * lp + (n - k)[:, None] * lq
    s0, s1, s2 = s.unbind(1)

    # best / second with ties → lowest index
    best01 = (s1 > s0).to(torch.int32)
    sb01 = torch.maximum(s0, s1)
    best = torch.where(s2 > sb01, 2, best01)
    s_best = torch.maximum(sb01, s2)
    s_second = torch.where(
        best == 0,
        torch.maximum(s1, s2),
        torch.where(best == 1, torch.maximum(s0, s2), torch.maximum(s0, s1)),
    )

    m = s_best
    ssum = (
        torch.exp((s0 - m) * LN10)
        + torch.exp((s1 - m) * LN10)
        + torch.exp((s2 - m) * LN10)
    )
    log_gt_sum = m + torch.log10(ssum)
    underflow = (m + lc) < LOG10_TINY

    sq = torch.abs(-10.0 * (s0 - log_gt_sum))
    gq = torch.trunc(torch.clamp(-10.0 * (s_second - s_best), max=MAX_GQ))
    null = force_null | (total <= 0.0) | underflow
    # AB denominator in the reference's order (((rs+rp)+alt_split)+ap)
    denom = rs + rp + alt_split + ap
    ab_valid = denom > 0.0
    ab = torch.where(
        ab_valid, (alt_split + ap) / torch.where(ab_valid, denom, 1.0), 0.0
    )

    def i32(x):
        return x.to(torch.int32).to(torch.float32)

    return torch.stack(
        [
            i32(null),
            torch.where(null, -1, best).to(torch.float32),
            i32(gq),
            i32(qr),
            i32(qa),
            i32(rs + rp + as_ + ac + ap),  # DP, reference order
            i32(rs + rp),
            i32(alt_split + ap),
            i32(rs),
            i32(as_),
            i32(ac),
            i32(rp),
            i32(ap),
            i32(ab_valid),
            lc + s0,
            lc + s1,
            lc + s2,
            sq,
            ab,
            rs,
            as_,
            ac,
            rp,
            ap,
        ],
        dim=1,
    )


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s has dtype %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != shape:
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), shape))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


@functools.lru_cache(maxsize=1)
def _entry():
    """``svt_gl_rows`` from the built library, with its C signature."""
    from svtyper_tpu_torch.ops._build import load

    fn = load("gl_kernel").svt_gl_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


def genotype_rows_cuda(
    counts: torch.Tensor,
    is_dup: torch.Tensor,
    force_null: torch.Tensor,
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
) -> torch.Tensor:
    """Launch ``csrc/gl_kernel.cu`` on the current stream → [N,24] f32.
    Takes counts [N,5] float32 and is_dup/force_null [N] uint8, all
    contiguous on one CUDA device."""
    global LAUNCHES
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError("genotype_rows_cuda needs CUDA tensors, got %s" % dev)
    n = counts.shape[0]
    _check("counts", counts, torch.float32, (n, 5), dev)
    _check("is_dup", is_dup, torch.uint8, (n,), dev)
    _check("force_null", force_null, torch.uint8, (n,), dev)
    rows = torch.empty((n, ROW_WIDTH), dtype=torch.float32, device=dev)
    if n == 0:
        return rows
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            counts.data_ptr(), is_dup.data_ptr(), force_null.data_ptr(),
            rows.data_ptr(), n, split_weight, disc_weight,
            _TABLES.ctypes.data, stream,
        )
    if rc != 0:
        raise RuntimeError("gl_kernel launch failed: cudaError %d" % rc)
    LAUNCHES += 1
    return rows


def genotype_rows(
    counts: torch.Tensor,
    is_dup: torch.Tensor,
    force_null: torch.Tensor,
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
) -> torch.Tensor:
    """The engine's float32 GL stage: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors, an error for anything else."""
    kind = counts.device.type
    if kind == "cuda":
        return genotype_rows_cuda(
            counts, is_dup, force_null, split_weight, disc_weight
        )
    if kind == "cpu":
        return genotype_rows_plain(
            counts, is_dup, force_null, split_weight, disc_weight
        )
    raise ValueError("no GL stage for device %s" % counts.device)
