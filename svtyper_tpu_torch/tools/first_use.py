"""A card's first use in a fresh process, split into its parts.

The shipped command runs one process per sample, and that process pays
once for each card it drives: CUDA's init (``cuInit``), the card's primary
context, torch's lazy CUDA init, the pinned host allocator's first
block, the kernel libraries' ``dlopen``, each kernel module's load, the
device allocator's first block and the upload of the sample's density
table. A part runs once per process, so each measurement here runs in a
child process of its own, on the cards ``cuda:0`` … ``cuda:<cards-1>``:

- ``cold``: a ``TorchEngine``'s first chunk with nothing done before it
  but the device count: the first send's wall (``send_s``, plus
  ``warm_wait_s``, the time it waited on the engine's warm-up, which
  starts when the engine is built), against a second chunk's send;
- ``split``: the parts (``PARTS``) one after another on the main thread,
  each timed, then a ``TorchEngine``'s first and second chunk;
- ``lock:<part>``: the parts before ``<part>`` on the main thread, then
  ``<part>`` on a second thread while the main thread runs the CLI's
  VCF pre-scan (``prescan``: the hash and BND filter of
  ``cli/classic.py::sv_genotype``) over ``PRESCAN_RECORDS`` records of
  ``data/example.vcf`` again and again. The pre-scan's rate while the
  part runs, over its rate alone, gives ``lock_share``: the share of the
  part's wall that kept the main thread from running (the interpreter
  lock, or cores), and ``stall_ms``, the pre-scan time that cost;
- ``contexts``: every card's primary context created side by side, a
  thread each (with more than one card).

Each child prints one JSON line; the command prints them and a summary
line. CUDA only: there is nothing to measure on the CPU.

    python -m svtyper_tpu_torch.tools.first_use [--cards N]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List

from svtyper_tpu_torch.gt.engine import KERNELS
from svtyper_tpu_torch.tools import common

PARTS = ("cuinit", "context", "torch_init", "pinned", "dlopen", "modules",
         "device_alloc", "dens")
PRESCAN_RECORDS = 96_000  # the bench's CLI row
# one shard's wire at chunk 1,024 on the bench's 30x fixture is ~2 MB
BLOCK_BYTES = 2_086_517
CHUNK = 1024
MIN_ALONE_S = 0.3  # the pre-scan's rate alone: at least this long
CHILD_TIMEOUT_S = 600
DATA = os.path.join(common.ROOT, "data")


def prescan_lines(n: int = PRESCAN_RECORDS) -> List[str]:
    """``data/example.vcf``'s records tiled to ``n`` lines."""
    with open(os.path.join(DATA, "example.vcf")) as fh:
        body = [l.rstrip("\n") for l in fh if not l.startswith("#")]
    return [body[i % len(body)] for i in range(n)]


def prescan(lines, bnd=None) -> int:
    """The CLI's pre-scan loop over ``lines`` → lines read: each line
    hashed, the BND records kept in ``bnd``."""
    sha = hashlib.sha256()
    bnd = [] if bnd is None else bnd
    n = 0
    for line in lines:
        n += 1
        sha.update(line.encode())
        sha.update(b"\n")
        if "SVTYPE=BND" in line:
            bnd.append(line)
    return n


class _LibCuda:
    """``libcuda``'s API through ctypes (each call drops the interpreter
    lock)."""

    def __init__(self):
        self.lib = ctypes.CDLL("libcuda.so.1")

    def call(self, name, *args):
        rc = getattr(self.lib, name)(*args)
        common.check(rc == 0, "%s failed: CUresult %d" % (name, rc))

    def primary_context(self, index: int) -> None:
        dev = ctypes.c_int()
        ctx = ctypes.c_void_p()
        self.call("cuDeviceGet", ctypes.byref(dev), index)
        self.call("cuDevicePrimaryCtxRetain", ctypes.byref(ctx), dev)


def _parts(cards: int, sample) -> Dict[str, Callable[[], None]]:
    """Each part as a call, on cards 0 … ``cards - 1``."""
    import torch

    from svtyper_tpu_torch.evidence.device import _prob_mapq_table
    from svtyper_tpu_torch.gt.engine import dens_state
    from svtyper_tpu_torch.ops import _build

    devs = [torch.device("cuda", i) for i in range(cards)]
    drv = []

    def cuinit():
        drv.append(_LibCuda())
        drv[0].call("cuInit", 0)

    def dens():
        for d in devs:
            dens_state(sample.dens_matrix(), d, torch.float32)
            _prob_mapq_table(d, torch.float32)
            torch.cuda.synchronize(d)

    return {
        "cuinit": cuinit,
        "context": lambda: [drv[0].primary_context(i) for i in range(cards)],
        "torch_init": torch.cuda.init,
        "pinned": lambda: torch.empty(BLOCK_BYTES, dtype=torch.uint8,
                                      pin_memory=True),
        "dlopen": lambda: [_build.load(k) for k in KERNELS],
        "modules": lambda: [_build.warm(k, i) for i in range(cards)
                            for k in KERNELS],
        "device_alloc": lambda: [torch.empty(BLOCK_BYTES, dtype=torch.uint8,
                                             device=d) for d in devs],
        "dens": dens,
    }


def _first_chunks(cards: int, sample, bps) -> dict:
    """A ``TorchEngine`` on the cards: its first chunk's send and wall,
    and its second's send."""
    from svtyper_tpu_torch.gt.engine import TorchEngine

    eng = TorchEngine([sample], devices=["cuda:%d" % i
                                         for i in range(cards)])
    out = {}
    try:
        for k in (1, 2):
            before = dict(eng.stats)
            t0 = time.time()
            eng.genotype_chunk(bps)
            out["chunk%d_wall_s" % k] = time.time() - t0
            for key in ("send_s", "warm_wait_s"):
                out["chunk%d_%s" % (k, key)] = eng.stats[key] - before[key]
        out["warm_s"] = eng.stats["warm_s"]
        out["warm_parts"] = eng.warm_parts
    finally:
        eng.close()
    return out


def child(mode: str, cards: int) -> dict:
    """One measurement in this (fresh) process → its JSON record."""
    from svtyper_tpu_torch.utils import fixture

    sample, bps = fixture.load_sample_and_breakpoints(
        os.path.join(DATA, "example.sim.sorted.bam"),
        os.path.join(DATA, "example.vcf"), CHUNK, num_samp=60_000)
    out = {"mode": mode, "cards": cards}
    if mode == "cold":
        out.update(_first_chunks(cards, sample, bps))
        return out
    parts = _parts(cards, sample)
    if mode == "split":
        for name in PARTS:
            t0 = time.time()
            parts[name]()
            out[name + "_ms"] = (time.time() - t0) * 1e3
        out.update(_first_chunks(cards, sample, bps))
        return out
    if mode == "contexts":
        parts["cuinit"]()
        threads = [threading.Thread(target=_LibCuda().primary_context,
                                    args=(i,)) for i in range(cards)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["contexts_side_by_side_ms"] = (time.time() - t0) * 1e3
        return out
    kind, _, part = mode.partition(":")
    common.check(kind == "lock" and part in PARTS, "unknown mode %r" % mode)
    for name in PARTS[:PARTS.index(part)]:
        parts[name]()
    lines = prescan_lines()
    n, t0 = 0, time.time()
    while time.time() - t0 < MIN_ALONE_S:
        n += prescan(lines)
    alone = n / (time.time() - t0)
    span = {}

    def run():
        span["t0"] = time.time()
        parts[part]()
        span["t1"] = time.time()

    th = threading.Thread(target=run)
    n, t0 = 0, time.time()
    th.start()
    block = 1000
    while th.is_alive():
        for i in range(0, len(lines), block):
            n += prescan(lines[i:i + block])
            if not th.is_alive():
                break
    th.join()
    wall = time.time() - t0
    during = n / wall
    share = max(0.0, 1.0 - during / alone)
    out.update({
        "part": part,
        "part_ms": (span["t1"] - span["t0"]) * 1e3,
        "prescan_lines_per_s_alone": alone,
        "prescan_lines_per_s_during": during,
        "lock_share": share,
        "stall_ms": share * wall * 1e3,
    })
    return out


_CHILD = ("import sys, json; from svtyper_tpu_torch.tools import RefuseJax; "
          "sys.meta_path.insert(0, RefuseJax()); "
          "from svtyper_tpu_torch.tools import first_use; "
          "print(json.dumps(first_use.child(sys.argv[1], int(sys.argv[2]))))")


def modes(cards: int) -> List[str]:
    """The children one run starts, in order."""
    return (["cold", "split"] + ["lock:" + p for p in PARTS]
            + (["contexts"] if cards > 1 else []))


def run(cards=None, device=None) -> dict:
    """Every measurement in a fresh child on ``cards`` cards (all visible
    by default) → the summary; prints each child's line and the
    summary."""
    dev = common.resolve_device(device)
    common.check(common.is_cuda(dev), "first_use measures a CUDA card's "
                 "first use; there is nothing to measure on %s" % dev)
    import torch

    from svtyper_tpu_torch.bamio.native import require_lib
    from svtyper_tpu_torch.ops import _build

    cards = cards or torch.cuda.device_count()
    require_lib()
    for k in KERNELS:  # built here, so a child times dlopen, not nvcc
        _build.build(k)
    common.print_json(common.header("first_use", dev))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (common.ROOT, os.environ.get("PYTHONPATH")) if p))
    recs = {}
    for mode in modes(cards):
        res = subprocess.run([sys.executable, "-c", _CHILD, mode, str(cards)],
                             cwd=common.ROOT, env=env, capture_output=True,
                             text=True, timeout=CHILD_TIMEOUT_S)
        common.check(res.returncode == 0, "child %s: exit %d\n%s" % (
            mode, res.returncode, res.stderr[-3000:]))
        recs[mode] = json.loads(res.stdout.strip().splitlines()[-1])
        common.print_json(recs[mode])
    split = recs["split"]
    summary = {
        "cards": cards,
        "cold_first_send_s": recs["cold"]["chunk1_send_s"]
        + recs["cold"]["chunk1_warm_wait_s"],
        "cold_second_send_s": recs["cold"]["chunk2_send_s"],
        "parts_ms": {p: split[p + "_ms"] for p in PARTS},
        "lock_share": {p: recs["lock:" + p]["lock_share"] for p in PARTS},
        "stall_ms": {p: recs["lock:" + p]["stall_ms"] for p in PARTS},
        "split_first_send_s": split["chunk1_send_s"],
    }
    if cards > 1:
        summary["contexts_side_by_side_ms"] = \
            recs["contexts"]["contexts_side_by_side_ms"]
    common.print_json(summary)
    return summary


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=None,
                    help="cards cuda:0 .. cuda:N-1 (default: all visible)")
    args = ap.parse_args(argv)
    return common.run_main(lambda: run(args.cards, device))


if __name__ == "__main__":
    sys.exit(main())
