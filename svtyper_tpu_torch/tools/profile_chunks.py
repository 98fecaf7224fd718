"""Chunk-size sweep of ``TorchEngine`` with the prep/send/sync split.

Counterpart of ``scripts/profile_tpu.py``. For each chunk size: one
first call on one chunk (timed; on the TPU it held the compile), then
three ``genotype_all`` runs over every record, each with the engine's
stats zeroed, reporting variants/s, ``prep_s``, ``send_s``, ``sync_s``,
``chunks``, ``classify_launches`` and ``gl_launches``. The integer
fields of the results must be identical across chunk sizes, the chunk
count must be ceil(records / chunk size), and on CUDA the classify and
GL kernels must each run once per chunk. The engine runs on one device.

    python -m svtyper_tpu_torch.tools.profile_chunks [chunk ...]   # 1024 2048 4096

Without a BAM/VCF pair it uses bench.py's simulated sample at 1,600
events, cached under ``build/tools/``.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.gt.engine import INT_FIELDS, TorchEngine, result_to_row
from svtyper_tpu_torch.tools import common
from svtyper_tpu_torch.utils import fixture

SIZES = (1024, 2048, 4096)
REPS = 3
N_EVENTS = 1600
STAT_KEYS = ("prep_s", "send_s", "sync_s", "chunks", "classify_launches",
             "gl_launches")


def result_rows(results) -> np.ndarray:
    """``genotype_all`` results (one sample) → [N,24] float64 rows."""
    return np.stack([result_to_row(r[0]) for r in results])


def run(
    bam: Optional[str] = None,
    vcf: Optional[str] = None,
    sizes: Iterable[int] = SIZES,
    device=None,
    emit=common.print_json,
) -> Tuple[List[dict], np.ndarray]:
    """→ (one result per chunk size, the first size's [N,24] rows)."""
    device = common.resolve_device(device)
    emit(common.header("profile_chunks", device))
    if bam is None:
        bam, vcf = common.default_fixture(N_EVENTS)
    sample, bps = fixture.load_sample_and_breakpoints(bam, vcf)
    n, sizes = len(bps), list(sizes)
    results, first_rows = [], None
    for cs in sizes:
        engine = TorchEngine([sample], chunk_size=cs, device=device)
        t0 = time.time()
        engine.genotype_chunk(bps[: min(cs, n)])
        first_s = time.time() - t0
        runs = []
        for _ in range(REPS):
            for k in engine.stats:
                engine.stats[k] = 0
            t0 = time.time()
            res = engine.genotype_all(bps)
            dt = time.time() - t0
            st = engine.stats
            runs.append(dict({"wall_s": dt, "variants_per_s": n / dt},
                             **{k: st[k] for k in STAT_KEYS}))
            want_chunks = -(-n // cs)
            common.check(st["chunks"] == want_chunks, "chunk %d: %d chunks "
                         "for %d records" % (cs, st["chunks"], n))
            if common.is_cuda(device):
                common.check(
                    st["classify_launches"] == st["gl_launches"]
                    == want_chunks,
                    "chunk %d: %d classify and %d GL launches for %d chunks"
                    % (cs, st["classify_launches"], st["gl_launches"],
                       want_chunks))
        engine.close()
        rows = result_rows(res)
        if first_rows is None:
            first_rows = rows
        bad = (rows[:, : len(INT_FIELDS)]
               != first_rows[:, : len(INT_FIELDS)]).any(axis=0)
        common.check(not bad.any(), "chunk %d: int fields %s differ from "
                     "chunk %d's" % (cs, [INT_FIELDS[i] for i in
                                          bad.nonzero()[0]], sizes[0]))
        results.append({
            "chunk_size": cs, "variants": n, "first_call_s": first_s,
            "median_variants_per_s": statistics.median(
                r["variants_per_s"] for r in runs),
            "int_fields_identical": True, "reps": runs,
        })
        emit(results[-1])
    return results, first_rows


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    return common.run_main(
        lambda: run(sizes=[int(a) for a in args] or SIZES)
    )


if __name__ == "__main__":
    sys.exit(main())
