"""The full-column device step and the multi-device dryrun: the
counterparts of ``__graft_entry__.py``'s two entry points.

``entry()`` returns the full-column step — float32 ``classify`` then the
GL stage — with the 64-variant synthetic chunk as example inputs.
``dryrun_multichip(n)`` runs the production engine (``TorchEngine``)
over ``n`` devices: a tiny simulated BAM + VCF (six DELs) with each
chunk's variants split into one contiguous shard per device.

    python -m svtyper_tpu_torch.parallel.dryrun 8 cpu
"""

from __future__ import annotations

import io
import os
import sys
import tempfile


def entry(device=None):
    """→ ``(step, example_args)``: ``step(*example_args)`` runs float32
    ``classify`` on the synthetic chunk (64 DEL variants, 8 fragments
    each) and the GL stage, and returns ``genotype_batch``'s dict.

    The device defaults to the current CUDA card, where the GL stage is
    the hand-written kernel; ``device="cpu"`` runs its plain twin. There
    is no fallback: without CUDA the default raises. The JAX step's fifth
    argument, the float32 log-choose table, has no counterpart: the
    kernel takes log10 C(n,k) from lgamma."""
    import numpy as np
    import torch

    from svtyper_tpu_torch.gt.engine import _resolve_device
    from svtyper_tpu_torch.parallel.mesh import genotype_step
    from svtyper_tpu_torch.parallel.synth import make_synthetic_chunk

    dev, dtype = _resolve_device(device or "cuda", torch.float32)
    chunk, dens = make_synthetic_chunk(n_var=64, frags_per_var=8)
    n_var = chunk.n_var

    def step(reads, pairs, variants, dens):
        return genotype_step(reads, pairs, variants, dens, n_var,
                             min_aligned=20)

    def put(cols):
        return {k: torch.as_tensor(np.asarray(v)).to(dev)
                for k, v in cols.items()}

    example_args = (
        put(chunk.reads),
        put(chunk.pairs),
        put(chunk.variants),
        torch.as_tensor(dens, dtype=dtype).to(dev),
    )
    return step, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run ``TorchEngine`` over ``[device] * n_devices`` (a device may
    repeat, so one card or the CPU stands in for several) with
    ``chunk_size = 2 * n_devices``; every variant must be called."""
    from svtyper_tpu_torch.bamio.bam import BamFile
    from svtyper_tpu_torch.breakpoints import resolve_breakpoint
    from svtyper_tpu_torch.simulate import (
        Event,
        SimConfig,
        events_to_vcf,
        simulate_events,
    )
    from svtyper_tpu_torch.stats import Sample
    from svtyper_tpu_torch.vcfio.model import Variant, Vcf
    from svtyper_tpu_torch.vcfio.reader import read_vcf_lines
    from svtyper_tpu_torch.gt.engine import TorchEngine

    refs = [("chr1", 1_200_000)]
    events = [
        Event("DEL", "chr1", 100_000 + 150_000 * i,
              100_000 + 150_000 * i + 900 + 61 * i,
              ["0/1", "1/1", "0/0"][i % 3], var_id="d%d" % i)
        for i in range(6)
    ]
    with tempfile.TemporaryDirectory() as d:
        bam_path = os.path.join(d, "dryrun.bam")
        simulate_events(bam_path, refs, events, SimConfig(depth=12), seed=3,
                        extra_background=400)
        sample = Sample.from_bam(BamFile(bam_path), num_samp=20_000)
        vcf = Vcf()
        header, body = read_vcf_lines(io.StringIO(events_to_vcf(events, refs)))
        vcf.add_header(header)
        bps = [resolve_breakpoint(Variant(line, vcf)) for line in body]

        with TorchEngine([sample], chunk_size=n_devices * 2,
                         devices=[device] * n_devices) as engine:
            assert engine.n_dev == n_devices, (engine.n_dev, n_devices)
            rows = engine.genotype_all(bps)
        gts = [row[0].gt_string for row in rows]
        called = sum(1 for row in rows if not row[0].null)
        assert len(gts) == len(bps) == called, gts
        print(
            "dryrun_multichip: %d x %s ok via TorchEngine shards; "
            "%d/%d called; gt=%s"
            % (n_devices, device, called, len(bps), gts)
        )


if __name__ == "__main__":
    dryrun_multichip(
        int(sys.argv[1]) if len(sys.argv) > 1 else 2,
        sys.argv[2] if len(sys.argv) > 2 else "cuda",
    )
