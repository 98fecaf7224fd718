#!/usr/bin/env python3
"""Copy the host half of ``svtyper_tpu`` into ``svtyper_tpu_torch``.

    python scripts/copy_host_half.py           # write the copies
    python scripts/copy_host_half.py --check   # exit 1 if a copy differs

The PyTorch port imports nothing of the JAX package, so it carries its
own copy of every jax-free module it needs (BAM/CRAM decoding, VCF I/O,
library statistics, breakpoints, the compact-wire builder, the float64
oracle, output formatting, checkpoints, the simulator, the synthetic
chunk). Each file in
``COPIES`` is copied to the same relative path with one change: its
imports of ``svtyper_tpu`` name ``svtyper_tpu_torch`` instead. Docstrings,
comments and string literals stay as they are, so the output stays
byte-identical (the simulator still writes ``##source=svtyper_tpu.simulate``).

Two files of the host half are not in ``COPIES``: the port's
``bamio/native.py`` and ``bamio/_native/Makefile`` began as such copies
and were then changed by hand (the port's decoder builds under
``build/svtyper_tpu_torch/`` and can be required), so a rerun must not
overwrite them. ``tests/test_torch_standalone.py`` runs the same
comparison as ``--check``.
"""

from __future__ import annotations

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "svtyper_tpu")
DST = os.path.join(ROOT, "svtyper_tpu_torch")

COPIES = (
    "version.py",
    "utils/formatting.py",
    "models/__init__.py",
    "models/bayes.py",
    "statistics.py",
    "vcfio/__init__.py",
    "vcfio/model.py",
    "vcfio/reader.py",
    "breakpoints.py",
    "bamio/__init__.py",
    "bamio/bai.py",
    "bamio/bam.py",
    "bamio/bgzf.py",
    "bamio/cigar.py",
    "bamio/columns.py",
    "bamio/cram.py",
    "bamio/cram_writer.py",
    "bamio/csi.py",
    "bamio/fasta.py",
    "bamio/rans.py",
    "bamio/records.py",
    "bamio/writer.py",
    "bamio/_native/bamcore.cpp",
    "stats/__init__.py",
    "stats/library.py",
    "oracle/__init__.py",
    "oracle/engine.py",
    "evidence/extract.py",
    "output.py",
    "cli/checkpoint.py",
    "cli/write_alignment.py",
    "simulate.py",
    "parallel/synth.py",
)

# an import statement's module name: "from svtyper_tpu.x import" and
# "import svtyper_tpu.x" at any indentation (lazy imports included)
_IMPORT = re.compile(r"^(\s*)(from|import)(\s+)svtyper_tpu(?=[.\s])", re.M)


def rewrite(text: str) -> str:
    """The port's copy of a source file's text."""
    return _IMPORT.sub(r"\1\2\3svtyper_tpu_torch", text)


def expected(rel: str) -> str:
    with open(os.path.join(SRC, rel)) as fh:
        text = fh.read()
    return rewrite(text) if rel.endswith(".py") else text


def write(rel: str) -> None:
    dst = os.path.join(DST, rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as fh:
        fh.write(expected(rel))


def stale() -> list:
    """The files of ``COPIES`` whose copy is missing or differs."""
    out = []
    for rel in COPIES:
        dst = os.path.join(DST, rel)
        if not os.path.exists(dst):
            out.append(rel)
            continue
        with open(dst) as fh:
            if fh.read() != expected(rel):
                out.append(rel)
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args == ["--check"]:
        bad = stale()
        for rel in bad:
            print("differs: svtyper_tpu_torch/%s" % rel)
        return 1 if bad else 0
    if args:
        print("usage: copy_host_half.py [--check]", file=sys.stderr)
        return 2
    for rel in COPIES:
        write(rel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
