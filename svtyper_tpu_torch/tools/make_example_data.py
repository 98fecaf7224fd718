"""Generate the quickstart/regression dataset.

Counterpart of ``scripts/make_example_data.py`` on the port's own
simulator: the same references, events, ``SimConfig(depth=36)``, seed
2026 and 4,000 background pairs, so the BAM, its ``.bai`` and the VCF
are byte-identical to ``data/example.sim.sorted.bam`` (+``.bai``) and
``data/example.vcf``. The reference bundles real NA12878 target-loci
data (``data/example.vcf`` + ``data/NA12878.target_loci.sorted.bam``,
SURVEY.md §2.1); this is the small synthetic stand-in.

    python -m svtyper_tpu_torch.tools.make_example_data [outdir]

The default directory is ``build/tools/example/``: ``data/`` is written
only when it is named. The simulator runs on the host alone, so this
tool, unlike those that drive the engine, needs no device.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

from svtyper_tpu_torch.simulate import Event, SimConfig, events_to_vcf, simulate_events
from svtyper_tpu_torch.tools import common

OUTDIR = os.path.join(common.CACHE, "example")

REFS = [("chr1", 12_000_000), ("chr2", 6_000_000)]

EVENTS = [
    Event("DEL", "chr1", 1_000_000, 1_004_000, "0/1"),
    Event("DEL", "chr1", 2_000_000, 2_001_500, "1/1"),
    Event("DEL", "chr1", 3_000_000, 3_000_400, "0/1", var_id="del_small"),
    Event("DEL", "chr1", 4_000_000, 4_003_000, "0/0"),
    Event("DUP", "chr1", 5_000_000, 5_004_000, "0/1"),
    Event("DUP", "chr1", 6_000_000, 6_002_000, "1/1"),
    Event("INV", "chr1", 7_000_000, 7_003_000, "0/1"),
    Event("INV", "chr1", 8_000_000, 8_001_500, "1/1"),
    Event("BND", "chr1", 9_000_000, 2_000_000, "0/1", chrom2="chr2"),
    Event("DEL", "chr2", 4_000_000, 4_002_500, "0/1"),
    # a wide-CI record that the --max_ci_dist gate nulls, and a
    # coverage-spiked locus that the --max_reads gate nulls, so the
    # golden files pin the null-path bytes through the CLI
    Event("DEL", "chr1", 10_000_000, 10_002_000, "0/1",
          var_id="del_wide_ci", ci=(-80, 80)),
    Event("DEL", "chr1", 11_000_000, 11_001_200, "0/1",
          var_id="del_deep", depth_scale=10.0),
]


def make(outdir: Optional[str] = None) -> Tuple[str, str]:
    """Simulate the dataset into ``outdir`` → (bam, vcf)."""
    outdir = outdir or OUTDIR
    os.makedirs(outdir, exist_ok=True)
    bam = os.path.join(outdir, "example.sim.sorted.bam")
    vcf = os.path.join(outdir, "example.vcf")
    simulate_events(
        bam, REFS, EVENTS, SimConfig(depth=36), seed=2026,
        extra_background=4000,
    )
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(EVENTS, REFS))
    return bam, vcf


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    bam, vcf = make(args[0] if args else None)
    print("wrote %s (+.bai) and %s" % (bam, vcf))
    print("quickstart: python -m svtyper_tpu_torch.cli.classic -i %s -B %s "
          "-o out.vcf" % (vcf, bam))
    return 0


if __name__ == "__main__":
    sys.exit(main())
