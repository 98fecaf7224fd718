"""The CUDA GL kernel against its plain twin and the torch GL stage.

Counterpart of ``scripts/pallas_vs_jnp.py``. On the same input as that
script (``default_rng(7)``, ``gamma(2, 10)`` counts, 10% of rows zeroed,
30% ``is_dup``, 5% ``force_null``), at any N, it holds
``gl_kernel.genotype_rows_cuda`` and its plain twin
``genotype_rows_plain`` against ``ops/gl.py::genotype_batch`` in float32:
the 14 integer fields must be exact, and it reports the SQ max abs
difference. On CUDA it times each over 100 launches with CUDA events
(``*_call_ms``/``*_ms``: the host's call included) and the kernel alone
as ``kernel_device_ms``: 100 launches captured in one CUDA graph,
replayed between CUDA events, so the host is left out. Beside that it
puts the kernel's bound (``bound_ms``: the bytes it must move over the
card's memory rate, or its operations over the float32 rate, whichever
is larger) and the share of it the kernel reaches. It prints one JSON
line per N. ``device="cpu"`` checks the twin alone and times nothing.

    python -m svtyper_tpu_torch.tools.gl_bench [N ...]   # 1024 4096 65536
"""

from __future__ import annotations

import sys
from typing import Iterable, List

import numpy as np
import torch

from svtyper_tpu_torch.gt.engine import INT_FIELDS
from svtyper_tpu_torch.ops import gl_kernel
from svtyper_tpu_torch.ops.gl import genotype_batch, log_choose_table
from svtyper_tpu_torch.tools import common

SIZES = (1024, 4096, 65536)
ITERS = 100
# what only a run on the card measures
DEVICE_KEYS = ("kernel_call_ms", "kernel_device_ms", "twin_ms",
               "genotype_batch_ms", "bound_share")
NOT_MEASURED = "not measured (CPU run)"
# one H100 SXM at its full 700 W (NVIDIA's data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# per variant: counts [5] f32 and two flag bytes in, one [24] f32 row out
BYTES_PER_VARIANT = 5 * 4 + 2 + 24 * 4
# per variant, counted from csrc/gl_kernel.cu's gl_row: each add,
# multiply, compare, select, conversion and each lgammaf / expf / log10f
# / divide as one operation; the bytes bound it ~20x above this
OPS_PER_VARIANT = 120
_NI = len(INT_FIELDS)
_SQ = _NI + 3  # the SQ column of the [N,24] rows


def gl_inputs(n: int, seed: int = 7):
    """``scripts/pallas_vs_jnp.py``'s input → (counts [n,5] float32,
    is_dup [n] bool, force_null [n] bool), numpy."""
    rng = np.random.default_rng(seed)
    counts = rng.gamma(2.0, 10.0, size=(n, 5)).astype(np.float32)
    counts[rng.random(n) < 0.1] = 0.0
    is_dup = rng.random(n) < 0.3
    force_null = rng.random(n) < 0.05
    return counts, is_dup, force_null


def time_ms(fn, iters: int = ITERS, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of one ``fn()`` with the host left out: ``iters``
    calls captured in one CUDA graph, one replay between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capturing stream, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(n: int):
    """→ (bytes moved, least ms the card could take, "bytes" or
    "operations") for the GL stage over ``n`` variants."""
    nbytes = n * BYTES_PER_VARIANT
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = n * OPS_PER_VARIANT / PEAK_F32_S * 1e3
    if by_bytes >= by_ops:
        return nbytes, by_bytes, "bytes"
    return nbytes, by_ops, "operations"


def bench(n: int, device: str) -> dict:
    """Check (and on CUDA time) the GL stages at ``n`` → one result."""
    counts, is_dup, force_null = gl_inputs(n)
    c = torch.tensor(counts, device=device)
    d = torch.tensor(is_dup.astype(np.uint8), device=device)
    f = torch.tensor(force_null.astype(np.uint8), device=device)
    lcf = torch.as_tensor(log_choose_table(1 << 17, use_f64=False),
                          device=device)
    ref = genotype_batch(c, d, f, lcf)
    want = torch.stack([ref[k].to(torch.int32) for k in INT_FIELDS], dim=1)
    stages = {"twin": gl_kernel.genotype_rows_plain}
    cuda = common.is_cuda(device)
    if cuda:
        stages["kernel"] = gl_kernel.genotype_rows_cuda
    out = {"n": n, "device": device, "int_fields": "exact"}
    for name, fn in stages.items():
        rows = fn(c, d, f)
        bad = (rows[:, :_NI].to(torch.int32) != want).any(dim=0).cpu()
        common.check(not bad.any(), "N=%d: %s int fields %s differ from "
                     "genotype_batch" % (n, name, [INT_FIELDS[i] for i in
                                                   bad.nonzero()[:, 0]]))
        out["sq_max_abs_diff_" + name] = float(
            (rows[:, _SQ] - ref["sq"]).abs().max()
        )
    out["bytes"], out["bound_ms"], out["bound_by"] = bound(n)
    if not cuda:
        out.update(dict.fromkeys(DEVICE_KEYS, NOT_MEASURED))
        return out
    out["iters"] = ITERS

    def kernel():
        return gl_kernel.genotype_rows_cuda(c, d, f)

    out["kernel_call_ms"] = time_ms(kernel)
    out["kernel_device_ms"] = graph_ms(kernel)
    out["twin_ms"] = time_ms(lambda: gl_kernel.genotype_rows_plain(c, d, f))
    out["genotype_batch_ms"] = time_ms(lambda: genotype_batch(c, d, f, lcf))
    out["bound_share"] = out["bound_ms"] / out["kernel_device_ms"]
    return out


def run(sizes: Iterable[int] = SIZES, device=None, emit=common.print_json
        ) -> List[dict]:
    device = common.resolve_device(device)
    emit(common.header("gl_bench", device, reads_bam=False))
    results = []
    for n in sizes:
        results.append(bench(n, device))
        emit(results[-1])
    return results


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    return common.run_main(lambda: run([int(a) for a in args] or SIZES))


if __name__ == "__main__":
    sys.exit(main())
