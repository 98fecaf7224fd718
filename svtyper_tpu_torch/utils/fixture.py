"""Simulated WGS fixtures and host-side loaders for ``chip_smoke.py``.

The event generator is ``bench.py::build_fixture``'s (DEL-heavy,
LUMPY-like: DEL/DEL/DEL/DUP/INV, 300-6000 bp, one event per 20 kb,
seed 42), and the reads come from the port's ``simulate`` with its
defaults: 150 bp paired-end reads, insert 350±40, mapq mix
60/60/60/40/27, at the depth given (30× for a WGS sample).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.simulate import Event, SimConfig, events_to_vcf, simulate_events


def bench_events(n_events: int, seed: int = 42):
    """→ (refs, events): bench.py's generator at ``n_events``."""
    rng = np.random.default_rng(seed)
    types = ["DEL", "DEL", "DEL", "DUP", "INV"]
    gts = ["0/0", "0/1", "0/1", "1/1"]
    spacing = 20_000
    n_chrom = max(1, (n_events * spacing) // 40_000_000 + 1)
    per_chrom = (n_events + n_chrom - 1) // n_chrom
    refs = [("chr%d" % (c + 1), per_chrom * spacing + 100_000)
            for c in range(n_chrom)]
    events = []
    for i in range(n_events):
        c = i // per_chrom
        j = i % per_chrom
        pos = 30_000 + j * spacing
        svlen = int(rng.integers(300, 6000))
        events.append(
            Event(
                types[i % len(types)], refs[c][0], pos, pos + svlen,
                gts[int(rng.integers(0, len(gts)))],
                var_id="v%d" % i,
            )
        )
    return refs, events


def simulate_wgs(
    out_dir: str, n_events: int, depth: float = 30.0, seed: int = 42
) -> Tuple[str, str, List[str]]:
    """Simulate the bench fixture → (bam path, vcf path, truth GTs in
    record order)."""
    os.makedirs(out_dir, exist_ok=True)
    refs, events = bench_events(n_events, seed)
    bam = os.path.join(out_dir, "wgs.bam")
    vcf = os.path.join(out_dir, "wgs.vcf")
    simulate_events(bam, refs, events, SimConfig(depth=depth), seed=seed,
                    extra_background=5000)
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(events, refs))
    return bam, vcf, [e.gt for e in events]


def tile_vcf(src: str, dst: str, n: int, prefix: str = "t") -> None:
    """Tile a VCF's body to ``n`` records with unique ids (same loci), as
    ``bench.py::tile_vcf`` does."""
    with open(src) as fh:
        lines = fh.read().splitlines()
    header = [l for l in lines if l.startswith("#")]
    body = [l for l in lines if not l.startswith("#")]
    with open(dst, "w") as out:
        out.write("\n".join(header) + "\n")
        for i in range(n):
            c = body[i % len(body)].split("\t", 3)
            out.write("%s\t%s\t%s%d\t%s\n" % (c[0], c[1], prefix, i, c[3]))


def decoder_name() -> str:
    """Which BAM decoder this process loaded."""
    from svtyper_tpu_torch.bamio.native import get_lib

    return "native libsvtbam.so" if get_lib() is not None else "pure-Python"


def load_sample_and_breakpoints(
    bam: str, vcf: str, n: Optional[int] = None, num_samp: int = 200_000,
    lib_info: Optional[str] = None,
):
    """→ (Sample, the first ``n`` records' breakpoints, every record's
    when ``n`` is None) for driving ``TorchEngine`` directly. The library
    statistics come from the CLI's ``-l`` file ``lib_info`` when given,
    else from a scan of ``num_samp`` reads (the default is the JAX
    scripts' library sample)."""
    from svtyper_tpu_torch.bamio.bam import open_bam
    from svtyper_tpu_torch.breakpoints import resolve_breakpoint
    from svtyper_tpu_torch.stats import Sample
    from svtyper_tpu_torch.vcfio.model import Variant, Vcf
    from svtyper_tpu_torch.vcfio.reader import read_vcf_lines

    if lib_info is not None:
        sample = Sample.from_lib_info(open_bam(bam),
                                      Sample.load_lib_info(lib_info))
    else:
        sample = Sample.from_bam(open_bam(bam), num_samp=num_samp)
    v = Vcf()
    with open(vcf) as fh:
        header, body = read_vcf_lines(fh)
        v.add_header(header)
        bps = []
        for line in body:
            if n is not None and len(bps) == n:
                break
            bps.append(resolve_breakpoint(Variant(line, v)))
    return sample, bps
