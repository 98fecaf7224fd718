"""Capture one chunk's ``svt_fetch_chunk`` arguments for the native
replay harness.

Counterpart of ``scripts/native_profile/dump_chunk_args.py``: the same
spy on ``native.NativeBam.fetch_chunk``, driven by one
``TorchEngine.genotype_chunk`` of the VCF's first 1,024 records. The
``.bin`` files are byte-identical to the JAX script's on the same
BAM/VCF; the reference and read-group names go to ``chunk_names.txt``
in the same directory (the JAX script writes them to
``/tmp/chunk_names.txt``). The replay harness reads
``/tmp/chunkbin/*.bin`` and ``/tmp/chunk_names.txt``, so for gprof:

    python -m svtyper_tpu_torch.tools.dump_chunk_args <bam> <vcf> /tmp/chunkbin
    cp /tmp/chunkbin/chunk_names.txt /tmp/
    cd svtyper_tpu_torch/bamio/_native && \\
        g++ -O2 -pg -std=c++17 ../../tools/native_profile/replay_harness.cpp \\
        bamcore.cpp -o /tmp/replay -lz -pthread
    /tmp/replay <bam> 30 1 && gprof -b /tmp/replay gmon.out | head -30

(add ``-DUSE_LIBDEFLATE`` and ``-ldeflate`` where libdeflate is
installed). The default output directory is ``build/tools/chunkbin``.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from svtyper_tpu_torch.bamio import native
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.tools import common
from svtyper_tpu_torch.utils import fixture

OUTDIR = os.path.join(common.CACHE, "chunkbin")
N_RECORDS = 1024
_FILT_ARRAYS = ("rg_keep", "rg_to_lib", "cov_tid_a", "cov_pos_a",
                "cov_tid_b", "cov_pos_b")


def dump(
    bam: str,
    vcf: str,
    outdir: Optional[str] = None,
    device=None,
    emit=common.print_json,
) -> List[str]:
    """Genotype the first chunk with the spy in place → the files written."""
    device = common.resolve_device(device)
    emit(common.header("dump_chunk_args", device))
    outdir = outdir or OUTDIR
    os.makedirs(outdir, exist_ok=True)
    sample, bps = fixture.load_sample_and_breakpoints(bam, vcf, N_RECORDS)
    hdr = sample.bam.header
    refs = [r[0] for r in hdr.refs]
    rgs = [rg.get("ID", "") for rg in getattr(hdr, "read_groups", [])]

    written: List[str] = []
    orig = native.NativeBam.fetch_chunk

    def spy(self, rt, rs, re_, ro, rb, rn, vq, n_var, filt,
            max_reads=None, threads=1, vpred=None):
        if not written:
            arrs = dict(rt=rt, rs=rs, re_=re_, ro=ro, rb=rb, rn=rn, vq=vq,
                        n_var=np.int64(n_var),
                        min_aligned=np.int64(filt.min_aligned),
                        drop_flags=np.int64(filt.drop_flags))
            for f in _FILT_ARRAYS:
                a = getattr(filt, f)
                if a is not None:
                    arrs[f] = a
            if vpred is not None:
                arrs["v_i32"], arrs["v_u8"] = vpred
            for k, v in arrs.items():
                written.append(os.path.join(outdir, "%s.bin" % k))
                np.ascontiguousarray(v).tofile(written[-1])
            written.append(os.path.join(outdir, "chunk_names.txt"))
            with open(written[-1], "w") as fh:
                fh.write("\n".join(refs) + "\n--\n" + "\n".join(rgs))
        return orig(self, rt, rs, re_, ro, rb, rn, vq, n_var, filt,
                    max_reads, threads, vpred)

    native.NativeBam.fetch_chunk = spy
    try:
        engine = TorchEngine([sample], chunk_size=N_RECORDS, device=device)
        engine.genotype_chunk(bps)
        engine.close()
    finally:
        native.NativeBam.fetch_chunk = orig
    common.check(bool(written), "the native fetch_chunk was never called "
                 "(the %s decoder)" % fixture.decoder_name())
    emit({"dumped_to": outdir, "files": len(written), "records": len(bps),
          "bytes": sum(os.path.getsize(p) for p in written)})
    return written


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) not in (2, 3):
        sys.stderr.write("usage: python -m svtyper_tpu_torch.tools."
                         "dump_chunk_args <bam> <vcf> [outdir]\n")
        return 2
    return common.run_main(lambda: dump(*args))


if __name__ == "__main__":
    sys.exit(main())
