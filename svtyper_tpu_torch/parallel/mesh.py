"""Single-host multi-device sharding of the full-column device step.

Counterpart of ``svtyper_tpu.parallel.mesh``. The JAX module runs one
``shard_map`` program over a 'data' mesh axis; here the mesh is a list
of ``torch.device``s, and the step moves block ``d`` of every ``[D, …]``
input (``stack_shards``) to ``devices[d]`` and runs ``classify`` and the
GL stage there. Every shard is launched before any is collected, and
there is no cross-device traffic: per-variant work is independent, and
only the results come back to the host, stacked over ``D``.

The GL stage is the engine's: float32 is ``ops/gl_kernel.py::
genotype_rows`` (the hand-written CUDA kernel on a card, its plain twin
on the CPU), float64 is ``ops/gl.py::genotype_batch`` with the
log-choose table (the CPU parity path). The JAX module's ``check_vma``
shim translates a jax keyword and has no counterpart here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from svtyper_tpu_torch.evidence.device import classify
from svtyper_tpu_torch.evidence.extract import ChunkInputs
from svtyper_tpu_torch.gt.engine import (
    _NI,
    INT_FIELDS,
    MAX_N_TABLE,
    ROW_WIDTH,
    _resolve_device,
    local_cuda_devices,
)
from svtyper_tpu_torch.ops import gl_kernel
from svtyper_tpu_torch.ops.gl import genotype_batch, log_choose_table


def make_mesh(n_devices: Optional[int] = None, devices=None) -> List[torch.device]:
    """The devices a sharded step runs on: ``devices`` as given (a
    device may repeat, e.g. ``["cpu"] * 8``), else every visible CUDA
    device; the first ``n_devices`` of them when that is given.

    Raises when CUDA is missing or has fewer than ``n_devices`` cards:
    unlike the JAX function, which falls back to a virtual CPU mesh, this
    never trades the card for the CPU unless the caller names it."""
    if devices is None:
        devices = local_cuda_devices()
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                "need %d devices, have %d" % (n_devices, len(devices))
            )
        devices = devices[:n_devices]
    return devices


def rows_to_fields(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The GL kernel's ``[N, 24]`` rows (``gt/engine.py``'s row layout)
    as ``genotype_batch``'s dict: integer fields as int32, ``null`` and
    ``ab_valid`` as bool."""
    if rows.shape[1:] != (ROW_WIDTH,):
        raise ValueError("rows of shape %s, expected [N, %d]"
                         % (tuple(rows.shape), ROW_WIDTH))
    out = {k: rows[:, i].to(torch.int32) for i, k in enumerate(INT_FIELDS)}
    out["null"] = out["null"] != 0
    out["ab_valid"] = out["ab_valid"] != 0
    flts = rows[:, _NI:]
    out["gl"] = flts[:, 0:3]
    out["sq"] = flts[:, 3]
    out["ab"] = flts[:, 4]
    out["counts"] = flts[:, 5:10]
    return out


def genotype_step(
    reads: Dict[str, torch.Tensor],
    pairs: Dict[str, torch.Tensor],
    variants: Dict[str, torch.Tensor],
    dens: torch.Tensor,
    n_var: int,
    min_aligned: int = 20,
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
    rows_sorted: bool = False,
) -> Dict[str, torch.Tensor]:
    """``classify`` then the GL stage, on ``dens``'s device and in its
    dtype → ``genotype_batch``'s dict."""
    dtype = dens.dtype
    counts = classify(
        reads, pairs, variants, dens, n_var, min_aligned,
        dtype=dtype, rows_sorted=rows_sorted,
    )
    is_dup, force_null = variants["is_dup"], variants["force_null"]
    if dtype == torch.float32:
        return rows_to_fields(gl_kernel.genotype_rows(
            counts, is_dup.to(torch.uint8), force_null.to(torch.uint8),
            split_weight, disc_weight,
        ))
    lcf = torch.as_tensor(log_choose_table(MAX_N_TABLE, use_f64=True),
                          device=dens.device)
    return genotype_batch(
        counts, is_dup, force_null, lcf,
        split_weight=split_weight, disc_weight=disc_weight,
    )


def make_sharded_step(
    devices: Sequence,
    n_var: int,
    min_aligned: int = 20,
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
    dtype: Optional[torch.dtype] = None,
):
    """The step over ``[D, ...]`` stacked shard blocks, one per device
    (``make_mesh``). ``dtype`` defaults to float32 on CUDA and float64
    on the CPU; CUDA refuses float64.

    Returns ``fn(reads, pairs, variants, dens) -> outputs``:
    ``reads``/``pairs``/``variants`` are dicts of ``[D, ...]`` arrays or
    tensors, ``dens`` is ``[D, n_libs, W]``, and every output is a CPU
    tensor with a leading ``D`` axis. Each shard's rows must ascend by
    variant (``prepare_chunk``'s layout). The JAX step's fifth argument,
    the log-choose table, is the engine's own here (float64 only; the
    float32 kernel takes log10 C(n,k) from lgamma)."""
    resolved = [_resolve_device(d, dtype) for d in devices]
    if not resolved:
        raise ValueError("no devices")
    if len({(d.type, dt) for d, dt in resolved}) != 1:
        raise ValueError("devices must be of one kind: %s" % (list(devices),))
    devs = [d for d, _ in resolved]
    dtype = resolved[0][1]

    def shard(block, d, dev):
        return {k: torch.as_tensor(v[d]).to(dev) for k, v in block.items()}

    def step(reads, pairs, variants, dens):
        bad = [k for block in (reads, pairs, variants)
               for k, v in block.items() if len(v) != len(devs)]
        if bad or len(dens) != len(devs):
            raise ValueError("%s: leading axis is not the %d devices"
                             % (bad or "dens", len(devs)))
        outs = [
            genotype_step(
                shard(reads, d, dev), shard(pairs, d, dev),
                shard(variants, d, dev),
                torch.as_tensor(dens[d]).to(dev, dtype),
                n_var, min_aligned, split_weight, disc_weight,
                rows_sorted=True,
            )
            for d, dev in enumerate(devs)
        ]
        # every shard is in flight; collecting waits for each in turn
        return {k: torch.stack([o[k].cpu() for o in outs]) for k in outs[0]}

    return step


def stack_shards(chunks: Sequence[ChunkInputs]) -> Dict[str, Dict[str, np.ndarray]]:
    """Stack per-device ChunkInputs (equal pad sizes required) into
    [D, ...] arrays."""
    def stack(dicts: List[Dict[str, np.ndarray]]):
        return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}

    return {
        "reads": stack([c.reads for c in chunks]),
        "pairs": stack([c.pairs for c in chunks]),
        "variants": stack([c.variants for c in chunks]),
    }
