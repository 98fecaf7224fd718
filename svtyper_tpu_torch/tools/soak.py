"""A long streaming run with the flat-memory check, through the library
or the shipped command.

Counterpart of ``scripts/soak_1m.py``, both modes:

- library (default): fresh ``Breakpoint`` objects tiling the fixture's
  loci stream through ``TorchEngine.genotype_stream`` (results are
  yielded, never accumulated). Every ``every`` chunks it samples the
  host RSS and, on CUDA, ``torch.cuda.memory_reserved()``; the first
  sample is skipped (warm-up allocations).
- ``--cli``: the fixture's VCF tiled to N records on disk, genotyped by
  ``svtyper_tpu_torch.cli.classic.main`` in a child process with
  ``SVT_CLI_STATS``. The parent samples the child's RSS every
  ``interval`` seconds from the first chunk written on (the CLI's
  ``--verbose`` progress line; imports, library scan and the first use
  of a card come before it); on CUDA the child samples its own reserved
  device memory at the same interval. The first third of each series
  is skipped.

Either mode fails when a series drifts more than 10% (``common.drift``:
median of the last quarter against the first quarter). BGZF blocks are
warm after the first pass over the loci: this soaks memory and
sustained throughput, not cold I/O.

    python -m svtyper_tpu_torch.tools.soak [n_variants]          # 1,000,000
    python -m svtyper_tpu_torch.tools.soak --cli [n_variants]

Without a BAM/VCF pair it uses bench.py's simulated sample at 9,600
events, cached under ``build/tools/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Iterable, List, Optional

import torch

from svtyper_tpu_torch.breakpoints import Breakpoint
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.tools import common
from svtyper_tpu_torch.utils import fixture

N = 1_000_000
N_EVENTS = 9600
CHUNK = 1024
EVERY = 25  # library mode: chunks between samples
INTERVAL = 2.0  # --cli mode: seconds between samples
_MIB = float(1 << 20)

# the child of --cli mode: refuses jax before it imports the port
_CHILD = (
    "import sys; from svtyper_tpu_torch.tools import RefuseJax; "
    "sys.meta_path.insert(0, RefuseJax()); "
    "from svtyper_tpu_torch.tools.soak import cli_child; "
    "sys.exit(cli_child(%r, %r, %r, sys.argv[1:]))"
)


def fresh_stream(base: List[Breakpoint], n: int) -> Iterable[Breakpoint]:
    """``n`` breakpoints tiling ``base``, a fresh object for each, so the
    soak exercises allocation and lifetime."""
    i = 0
    while i < n:
        for bp in base:
            if i >= n:
                return
            yield Breakpoint(
                bp.svtype, bp.chrom_a, bp.pos_a, bp.ci_a, bp.chrom_b,
                bp.pos_b, bp.ci_b, bp.o1_rev, bp.o2_rev, bp.var_length,
            )
            i += 1


def reserved_mb(devices) -> float:
    """Device memory held by PyTorch's caching allocator, summed over
    ``devices``, in MiB."""
    return sum(torch.cuda.memory_reserved(d) for d in set(devices)) / _MIB


def _memory(rss: List[float], reserved: List[float], cuda: bool) -> dict:
    """Head, tail and drift of the host RSS and, on CUDA, of the
    reserved device memory (None on the CPU)."""
    head, tail, d = common.drift(rss)
    out = {"rss_head_mb": head, "rss_tail_mb": tail, "rss_drift": d}
    head, tail, d = common.drift(reserved) if cuda else (None, None, None)
    out.update(cuda_reserved_head_mb=head, cuda_reserved_tail_mb=tail,
               cuda_drift=d)
    return out


def _check_flat(out: dict, what: str) -> None:
    for key in ("rss_drift", "cuda_drift"):
        d = out[key]
        if d is not None and d > common.DRIFT_LIMIT:
            raise common.ToolError(
                "%s: %s %.1f%% over the soak (limit %.0f%%)"
                % (what, key, 100 * d, 100 * common.DRIFT_LIMIT)
            )


def soak_library(
    bam: Optional[str] = None,
    vcf: Optional[str] = None,
    n: int = N,
    device=None,
    chunk: int = CHUNK,
    every: int = EVERY,
    emit=common.print_json,
) -> dict:
    device = common.resolve_device(device)
    emit(common.header("soak", device))
    if bam is None:
        bam, vcf = common.default_fixture(N_EVENTS)
    sample, base = fixture.load_sample_and_breakpoints(bam, vcf)
    cuda = common.is_cuda(device)
    engine = TorchEngine([sample], chunk_size=chunk, device=device)
    engine.genotype_chunk(base[:chunk])  # warm-up
    for k in engine.stats:
        engine.stats[k] = 0
    t0 = time.time()
    n_done = n_called = n_chunks = 0
    rss, reserved = [], []
    for chunk_results in engine.genotype_stream(fresh_stream(base, n)):
        n_done += len(chunk_results)
        n_called += sum(1 for row in chunk_results if not row[0].null)
        n_chunks += 1
        if n_chunks % every == 0:
            rss.append(common.rss_mb())
            if cuda:
                reserved.append(reserved_mb(engine.devices))
            common.note("%8d variants  %.0f v/s  RSS %.0f MB%s" % (
                n_done, n_done / (time.time() - t0), rss[-1],
                "  CUDA reserved %.0f MB" % reserved[-1] if cuda else ""))
    dt = time.time() - t0
    engine.close()
    common.check(n_done == n, "streamed %d of %d variants" % (n_done, n))
    out = {"soak_variants": n, "variants_per_s": n / dt, "wall_s": dt,
           "called": n_called, "chunks": engine.stats["chunks"],
           "gl_launches": engine.stats["gl_launches"], "samples": len(rss)}
    out.update(_memory(rss[1:], reserved[1:], cuda))
    if out["rss_head_mb"] is None:
        out["rss_head_mb"] = out["rss_tail_mb"] = common.rss_mb()
    emit(out)
    _check_flat(out, "library soak")
    return out


def cli_child(device, mem_log: Optional[str], interval: float, argv) -> int:
    """The ``--cli`` child: the shipped ``main``; with ``mem_log`` a
    thread appends the reserved device memory (MiB, every card) to that
    file every ``interval`` seconds once CUDA is up."""
    import threading

    from svtyper_tpu_torch.cli import classic

    if not mem_log:
        return classic.main(argv, device=device)
    stop = threading.Event()

    def sample():
        with open(mem_log, "w") as fh:
            while not stop.wait(interval):
                if torch.cuda.is_initialized():
                    fh.write("%r\n" % reserved_mb(
                        range(torch.cuda.device_count())))
                    fh.flush()

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        return classic.main(argv, device=device)
    finally:
        stop.set()
        sampler.join()


def _first_chunk_written(err_path: str) -> bool:
    """The CLI's ``--verbose`` progress line after each chunk."""
    with open(err_path) as fh:
        return any(line.startswith("genotyped ") for line in fh)


def soak_cli(
    bam: Optional[str] = None,
    vcf: Optional[str] = None,
    n: int = N,
    device=None,
    interval: float = INTERVAL,
    emit=common.print_json,
) -> dict:
    """``device`` None runs the command as shipped (every visible card)."""
    run_on = common.resolve_device(device)
    emit(common.header("soak --cli", run_on))
    if bam is None:
        bam, vcf = common.default_fixture(N_EVENTS)
    big = os.path.splitext(vcf)[0] + "_soak%d.vcf" % n
    if not os.path.exists(big):
        fixture.tile_vcf(vcf, big, n, "soak")
    cuda = common.is_cuda(run_on)
    with tempfile.TemporaryDirectory() as tmp:
        stats = os.path.join(tmp, "stats.json")
        mem_log = os.path.join(tmp, "cuda_reserved.txt") if cuda else None
        err_path = os.path.join(tmp, "stderr.txt")
        env = dict(os.environ, SVT_CLI_STATS=stats, PYTHONPATH=os.pathsep.join(
            p for p in (common.ROOT, os.environ.get("PYTHONPATH")) if p))
        rss = []
        t0 = time.time()
        with open(err_path, "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-c", _CHILD % (device, mem_log, interval),
                 "-i", big, "-B", bam, "-o", os.devnull, "--verbose"],
                cwd=common.ROOT, env=env, stdout=subprocess.DEVNULL,
                stderr=err,
            )
            started = False  # the child has written its first chunk
            try:
                while proc.poll() is None:
                    time.sleep(interval)
                    r = common.rss_mb(proc.pid)
                    started = started or _first_chunk_written(err_path)
                    if r and started:
                        rss.append(r)
                        if len(rss) % 10 == 0:
                            common.note("cli soak: %.0fs RSS %.0f MB"
                                        % (time.time() - t0, r))
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        if proc.returncode != 0:
            with open(err_path) as fh:
                tail = fh.read()[-3000:]
            raise common.ToolError("CLI exited %d\n%s" % (proc.returncode, tail))
        with open(stats) as fh:
            st = json.load(fh)
        reserved = []
        if cuda and os.path.exists(mem_log):
            with open(mem_log) as fh:
                reserved = [float(line) for line in fh if line.strip()]
    common.check(st["n_variants"] == n, "the CLI wrote %d of %d records"
                 % (st["n_variants"], n))
    out = {"cli_soak_variants": st["n_variants"],
           "variants_per_s": st["n_variants"] / st["genotype_wall_s"],
           "genotype_wall_s": st["genotype_wall_s"],
           "total_wall_s": st["total_wall_s"], "prep_s": st["prep_s"],
           "send_s": st["send_s"], "sync_s": st["sync_s"],
           "chunks": st["chunks"], "gl_launches": st["gl_launches"],
           "classify_launches": st["classify_launches"],
           "rss_samples": len(rss)}
    # the RSS series starts at the first chunk written (imports, library
    # scan and the first use of a card lie before it); of both series
    # the first third is skipped, as in the JAX script
    out.update(_memory(rss[len(rss) // 3:], reserved[len(reserved) // 3:],
                       cuda))
    emit(out)
    _check_flat(out, "CLI soak")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_variants", nargs="?", type=int, default=N)
    ap.add_argument("--cli", action="store_true",
                    help="soak the shipped command in a child process")
    args = ap.parse_args(argv)
    if args.cli:
        return common.run_main(lambda: soak_cli(n=args.n_variants))
    return common.run_main(lambda: soak_library(n=args.n_variants))


if __name__ == "__main__":
    sys.exit(main())
