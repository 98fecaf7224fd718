"""Variants/s of ``TorchEngine`` over 1, 2, 4 and 8 devices.

Counterpart of ``scripts/scaling_curve.py``. Each device count runs one
warm-up ``genotype_all`` and one timed one, and reports ``devices``,
``cards`` (distinct devices), variants/s and the prep/send/sync split.
Every output must equal the one-device output (GT strings, GL rounded to
6 places) or the run fails.

On CUDA the devices are distinct cards where the host has several (the
counts above the card count are skipped); on a one-card host they are
``[cuda:0] * k`` for k = 1, 2, 4, the JAX script's virtual-device case.
``device="cpu"`` runs ``[cpu] * k`` for k = 1, 2, 4, 8.

    python -m svtyper_tpu_torch.tools.scaling_curve [n_variants]

Without a BAM/VCF pair it uses bench.py's simulated sample at 1,600
events, cached under ``build/tools/``.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, List, Optional

import torch

from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.tools import common
from svtyper_tpu_torch.utils import fixture

COUNTS = (1, 2, 4, 8)
ONE_CARD_COUNTS = (1, 2, 4)
N_EVENTS = 1600
CHUNK = 1024


def device_lists(device: str, counts: Optional[Iterable[int]] = None):
    """→ [(k, devices)] for the device counts a run covers."""
    if not common.is_cuda(device):
        return [(k, [device] * k) for k in (counts or COUNTS)]
    n_cards = torch.cuda.device_count()
    if n_cards == 1:
        return [(k, ["cuda:0"] * k) for k in (counts or ONE_CARD_COUNTS)]
    return [(k, ["cuda:%d" % i for i in range(k)])
            for k in (counts or COUNTS) if k <= n_cards]


def _formatted(results):
    return [
        (r[0].gt_string,
         None if r[0].gl is None else tuple(round(g, 6) for g in r[0].gl))
        for r in results
    ]


def run(
    bam: Optional[str] = None,
    vcf: Optional[str] = None,
    device=None,
    counts: Optional[Iterable[int]] = None,
    n: Optional[int] = None,
    emit=common.print_json,
) -> List[dict]:
    device = common.resolve_device(device)
    emit(common.header("scaling_curve", device))
    if bam is None:
        bam, vcf = common.default_fixture(N_EVENTS)
    sample, bps = fixture.load_sample_and_breakpoints(bam, vcf, n)
    rows, base = [], None
    for k, devices in device_lists(device, counts):
        engine = TorchEngine([sample], chunk_size=CHUNK, devices=devices)
        engine.genotype_all(bps)  # first use of each device, wire buckets
        for key in engine.stats:
            engine.stats[key] = 0
        t0 = time.time()
        res = engine.genotype_all(bps)
        dt = time.time() - t0
        engine.close()
        fmt = _formatted(res)
        if base is None:
            base = fmt
        st = engine.stats
        rows.append({
            "devices": k, "cards": len(set(devices)), "variants": len(bps),
            "variants_per_s": len(bps) / dt, "wall_s": dt,
            "prep_s": st["prep_s"], "send_s": st["send_s"],
            "sync_s": st["sync_s"], "chunks": st["chunks"],
            "gl_launches": st["gl_launches"],
            "identical_to_1dev": fmt == base,
        })
        emit(rows[-1])
        common.check(fmt == base, "%d devices (%s): output differs from one "
                     "device's" % (k, ",".join(devices)))
    return rows


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    return common.run_main(lambda: run(n=int(args[0]) if args else None))


if __name__ == "__main__":
    sys.exit(main())
