"""The CUDA GL kernel against its plain twin and the torch GL stage.

Counterpart of ``scripts/pallas_vs_jnp.py``. On the same input as that
script (``default_rng(7)``, ``gamma(2, 10)`` counts, 10% of rows zeroed,
30% ``is_dup``, 5% ``force_null``), at any N, it holds
``gl_kernel.genotype_rows_cuda`` and its plain twin
``genotype_rows_plain`` against ``ops/gl.py::genotype_batch`` in float32:
the 14 integer fields must be exact, and it reports the SQ max abs
difference. On CUDA it times each over 100 launches with CUDA events and
prints one JSON line per N. ``device="cpu"`` checks the twin alone and
times nothing.

    python -m svtyper_tpu_torch.tools.gl_bench [N ...]   # 1024 65536
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

SIZES = (1024, 65536)
ITERS = 100
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
    if not cuda:
        out["timed"] = "not measured (CPU run)"
        return out
    out["iters"] = ITERS
    out["kernel_ms"] = time_ms(lambda: gl_kernel.genotype_rows_cuda(c, d, f))
    out["twin_ms"] = time_ms(lambda: gl_kernel.genotype_rows_plain(c, d, f))
    out["genotype_batch_ms"] = time_ms(lambda: genotype_batch(c, d, f, lcf))
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
