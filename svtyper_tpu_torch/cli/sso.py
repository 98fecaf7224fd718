"""The ``svtyper-sso`` command line on PyTorch (parity of
``singlesample.py::main``, SURVEY.md §2.2–2.3, §3.3).

Counterpart of ``svtyper_tpu.cli.sso``. The reference's only
parallelism is a fork-based process pool over variant batches with
temp-file merge (SURVEY.md §2.1 item 1). Here the same role is played by
device batching (one device step genotypes a whole ``--batch_size``
chunk at once); ``--core`` maps the reference's host-side parallelism
onto the native decoder's per-fetch thread fan-out instead of forking.

    python -m svtyper_tpu_torch.cli.sso -i in.vcf -B s.bam -o out.vcf
"""

from __future__ import annotations

import argparse
import sys

from svtyper_tpu_torch.cli.classic import open_vcf_input, sv_genotype
from svtyper_tpu_torch.version import __version__


def get_args(argv=None):
    p = argparse.ArgumentParser(
        prog="svtyper-sso",
        description="Compute genotype of structural variants based on breakpoint depth (single sample, batched)",
    )
    p.add_argument("--version", action="version",
                   version="%%(prog)s %s" % __version__)
    p.add_argument("-i", "--input_vcf", default=None)
    p.add_argument("-o", "--output_vcf", default=None)
    p.add_argument("-B", "--bam", required=True)
    p.add_argument("-T", "--ref_fasta", default=None)
    p.add_argument("-l", "--lib_info", default=None)
    p.add_argument("-m", "--min_aligned", type=int, default=20)
    p.add_argument("-n", dest="num_samp", type=int, default=1000000)
    p.add_argument("-q", "--sum_quals", action="store_true")
    p.add_argument("--split_weight", type=float, default=1.0)
    p.add_argument("--disc_weight", type=float, default=1.0)
    p.add_argument("--max_reads", type=int, default=1000,
                   help="maximum reads per variant before null genotype [1000]")
    p.add_argument("--max_ci_dist", type=float, default=1e10)
    p.add_argument("--core", type=int, default=None,
                   help="host-side decode threads (the reference's fork-pool "
                        "parallelism maps to the native decoder's thread "
                        "fan-out; device batching replaces per-batch workers)")
    p.add_argument("--batch_size", type=int, default=1000,
                   help="variants per batch [1000]")
    p.add_argument("-w", "--write_alignment", default=None)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--engine", choices=("torch", "oracle"), default="torch")
    p.add_argument("--checkpoint_dir", default=None, metavar="DIR",
                   help="spill each genotyped batch to DIR and resume a "
                        "killed run at batch granularity (the role of the "
                        "reference sso's per-batch temp files)")
    return p.parse_args(argv)


def main(argv=None, device=None) -> int:
    """CLI entry point; ``device`` None → every visible CUDA device."""
    args = get_args(argv)
    if "," in args.bam:
        sys.stderr.write("svtyper-sso genotypes exactly one sample\n")
        return 2
    vcf_in = open_vcf_input(args.input_vcf) if args.input_vcf \
        else sys.stdin
    vcf_out = open(args.output_vcf, "w") if args.output_vcf else sys.stdout
    try:
        sv_genotype(
            args.bam,
            vcf_in,
            vcf_out,
            min_aligned=args.min_aligned,
            split_weight=args.split_weight,
            disc_weight=args.disc_weight,
            num_samp=args.num_samp,
            lib_info_path=args.lib_info,
            debug=args.debug,
            alignment_outpath=args.write_alignment,
            ref_fasta=args.ref_fasta,
            sum_quals=args.sum_quals,
            max_reads=args.max_reads,
            max_ci_dist=args.max_ci_dist,
            engine_kind=args.engine,
            batch_size=args.batch_size,
            verbose=args.verbose or args.debug,
            checkpoint_dir=args.checkpoint_dir,
            cores=args.core,
            device=device,
        )
    finally:
        if args.input_vcf:
            vcf_in.close()
        if args.output_vcf:
            vcf_out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
