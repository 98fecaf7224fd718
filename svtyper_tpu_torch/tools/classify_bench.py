"""Versions of the classify kernel timed against each other on one card.

    python -m svtyper_tpu_torch.tools.classify_bench \
        [--bam S.bam --vcf V.vcf [--lib L.json]] [--sizes 1024,4096] \
        [--source LABEL=PATH] ...

Each ``--source`` is a version of ``csrc/classify_kernel.cu`` (with none,
the checkout's own, labelled ``this``; ``PATH`` may be another checkout's
copy), built by nvcc with the port's flags (``ops/_build.py``) into
``build/classify_bench/<label>/``. At each
chunk size the engine's own prep of the VCF's first chunk
(``TorchEngine._prepare`` → ``pack_wire``, sent to the card as the engine
sends it) goes through every version, whose counts must be bit-identical
to the plain ``unwire`` → ``classify_compact``. Then, in turns (the
versions in order, then in reverse: old, new, new, old for two), each
version's kernel alone (100 launches in one CUDA graph,
``gl_bench.graph_ms``) and its call (CUDA events around 100 calls,
``gl_bench.time_ms``). Each size's JSON line also holds the chunk's rows,
longest segments and the kernel's bound (``bound``). With no BAM and VCF
it uses the tools' 1,600-event sample, its VCF tiled to the largest size.
It needs CUDA and exits 1 without it.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from svtyper_tpu_torch.evidence.device import classify_compact
from svtyper_tpu_torch.evidence.extract import LIB_INVALID, VARS_I32
from svtyper_tpu_torch.ops import _build, classify_kernel
from svtyper_tpu_torch.tools import common, gl_bench
from svtyper_tpu_torch.utils import fixture

SIZES = (1024, 4096)
BUILD = os.path.join(common.ROOT, "build", "classify_bench")
THIS = os.path.join(_build.CSRC, "classify_kernel.cu")
FIXTURE_EVENTS = 1600
# operations per read and per pair row, counted from
# csrc/classify_kernel.cu's per-row code (each add, multiply, divide,
# compare and select one); the bytes bound the kernel ~8x above them
READ_ROW_OPS = 13
PAIR_ROW_OPS = 26


def parse_source(spec: str) -> Tuple[str, str]:
    """``LABEL=PATH`` → (label, path); an empty PATH is the checkout's
    own source."""
    label, sep, path = spec.partition("=")
    if not sep or not label or "=" in path:
        raise common.ToolError("--source %r: expected LABEL=PATH" % spec)
    return label, path or THIS


def bound(compact, n_var: int, dens) -> Tuple[float, str, int]:
    """→ (least ms the card could take for the classifier on this chunk,
    "bytes" or "operations", the bytes it must move). The bytes: 5 B of
    each read row of a variant (variant, mapq, sa_mapq, flags), 10 B of
    each pair row of a variant (variant, ospan, two mapqs, lib, flags),
    5 B of each variant (vlen, is_del), each distinct density entry the
    pairs look up and the 1 KiB prob_mapq table once, and 20 B of counts
    per variant written, over the card's memory rate. Padding rows and
    the wire's rows the kernel does not read are left out. The
    operations: the rows' over its float32 rate. The larger wins."""
    n_lib, width = dens.shape
    reads = int((compact["cr_u16"][0] < n_var).sum())
    pv = compact["cp_u16"][0]
    real = pv < n_var
    pairs = int(real.sum())
    ospan = compact["cp_i32"][0][real]
    vlen = compact["v_i32"][VARS_I32.index("vlen")][pv[real]]
    lib = compact["cp_u8"][2][real]
    # the kernel's row of dens: lib clamped to [0, n_lib), LIB_INVALID none
    row = np.minimum(lib.astype(np.int64), n_lib - 1)
    entries = []
    for x in (ospan, np.subtract(ospan, vlen, dtype=np.int32)):
        ok = (x >= 0) & (x < width) & (lib != LIB_INVALID)
        entries.append(row[ok] * width + x[ok])
    distinct = len(np.unique(np.concatenate(entries)))
    nbytes = 5 * reads + 10 * pairs + 25 * n_var + 4 * distinct + 4 * 256
    by_bytes = nbytes / gl_bench.PEAK_BYTES_S * 1e3
    by_ops = ((READ_ROW_OPS * reads + PAIR_ROW_OPS * pairs)
              / gl_bench.PEAK_F32_S * 1e3)
    if by_bytes >= by_ops:
        return by_bytes, "bytes", nbytes
    return by_ops, "operations", nbytes


def wires(eng, bps, dev) -> Iterator[tuple]:
    """The engine's own prep of each chunk of ``bps`` → (compact, wire,
    geom, n_var) per chunk, the wire on ``dev`` as ``_launch`` sends it."""
    from svtyper_tpu_torch.gt.engine import pack_wire

    for start in range(0, len(bps), eng.chunk_size):
        (shards,) = eng._prepare(bps[start:start + eng.chunk_size])
        (payload, n_var), = shards
        common.check(payload[0] == "compact", "a non-native chunk")
        wire, geom = pack_wire(payload[1])
        yield payload[1], eng._to_device(wire, dev), geom, n_var


def chunk_stats(compact, n_var: int) -> dict:
    """The chunk's rows and its longest read and pair segments."""
    return {
        "reads": int((compact["cr_u16"] < n_var).sum()),
        "pairs": int((compact["cp_u16"] < n_var).sum()),
        "longest_segment": [int(np.bincount(
            compact[k][0], minlength=n_var + 1)[:n_var].max())
            for k in ("cr_u16", "cp_u16")],
    }


def load_version(label: str, src: str):
    """Build and bind one version → its ``svt_classify_compact`` and
    ptxas's register, memory and spill lines. Always built anew: a
    label's path may differ from the last run's."""
    so = os.path.join(BUILD, label, "libclassify_kernel.so")
    if os.path.exists(so):
        os.remove(so)
    _build.build_source(src, so)
    return classify_kernel.bind(ctypes.CDLL(so)), _build.PTXAS.get(so, [])


def default_inputs(size: int) -> Tuple[str, str]:
    """The tools' 1,600-event sample, its VCF tiled to ``size`` records."""
    bam, vcf = common.default_fixture(FIXTURE_EVENTS)
    tiled = os.path.join(common.CACHE, "classify_bench_%d.vcf" % size)
    if not os.path.exists(tiled):
        fixture.tile_vcf(vcf, tiled, size)
    return bam, tiled


def run(bam=None, vcf=None, lib=None, sizes: Sequence[int] = SIZES,
        sources: Sequence[Tuple[str, str]] = (),
        emit=common.print_json) -> List[dict]:
    from svtyper_tpu_torch.gt.engine import TorchEngine

    device = common.resolve_device(None)
    emit(common.header("classify_bench", device))
    sources = list(sources) or [("this", THIS)]
    labels = [s[0] for s in sources]
    common.check(len(set(labels)) == len(labels),
                 "two sources labelled alike: %s" % labels)
    fns = {}
    for label, src in sources:
        fns[label], report = load_version(label, src)
        emit({"source": label, "path": src, "ptxas": report})
    if bam is None:
        bam, vcf = default_inputs(max(sizes))
    sample, bps = fixture.load_sample_and_breakpoints(bam, vcf, lib_info=lib)
    dev = torch.device(device, 0)
    results = []
    for n in sizes:
        eng = TorchEngine([sample], device=dev, chunk_size=n)
        dens = eng._dens_for(0, dev)
        compact, w, geom, n_var = next(wires(eng, bps, dev))
        want = classify_compact(*classify_kernel.unwire(w, geom), dens,
                                n_var, dtype=torch.float32)
        calls = {label: (lambda fn=fn: classify_kernel.classify_compact_cuda(
            w, geom, dens, n_var, entry=fn)) for label, fn in fns.items()}
        for label, call in calls.items():
            got = call()
            common.check(
                got.shape == want.shape and torch.equal(
                    got.view(torch.int32), want.view(torch.int32)),
                "%s at N=%d: counts differ from the plain version's in %d "
                "variants" % (label, n, int((got != want).any(dim=1).sum())))
        torch.cuda.synchronize()
        res = {"n": n_var, **chunk_stats(compact, n_var),
               "order": labels + labels[::-1]}
        res["bound_ms"], res["bound_by"], res["bound_bytes"] = bound(
            compact, n_var, dens)
        res["device_ms"] = {k: [] for k in labels}
        res["call_ms"] = {k: [] for k in labels}
        for label in res["order"]:
            res["device_ms"][label].append(gl_bench.graph_ms(calls[label]))
            res["call_ms"][label].append(gl_bench.time_ms(calls[label]))
        eng.close()
        results.append(res)
        emit(res)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bam")
    ap.add_argument("--vcf")
    ap.add_argument("--lib", help="the CLI's -l library statistics")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH; repeat to compare")
    args = ap.parse_args(argv)
    if (args.bam is None) != (args.vcf is None):
        ap.error("give --bam and --vcf together")
    return common.run_main(lambda: run(
        args.bam, args.vcf, args.lib,
        [int(s) for s in args.sizes.split(",")],
        [parse_source(s) for s in args.source]))


if __name__ == "__main__":
    sys.exit(main())
