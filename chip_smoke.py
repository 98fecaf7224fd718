#!/usr/bin/env python3
"""Smoke test of svtyper_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py                # one card: phases 1-18
    python3 chip_smoke.py --multi-card   # two or more cards: 1, 2, 5-7, 10, 13, 14, 16, 18

Drives the port's shipped command (``svtyper_tpu_torch.cli.classic``),
its tools (``svtyper_tpu_torch.tools``), its full-column device step
(``svtyper_tpu_torch.parallel``) and its console scripts on the card and
checks them end to end, in eighteen phases (18 runs right after 5);
any failure exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build, all at once: ``csrc/gl_kernel.cu`` and
   ``csrc/classify_kernel.cu`` with one nvcc each and the port's own
   native BAM decoder (``bamio/_native/bamcore.cpp``, make and g++),
   each into ``build/svtyper_tpu_torch/``, then loads all three (no
   pure-Python fallback) and logs each kernel's registers, shared
   memory and spills (``-Xptxas -v``);
3. kernel against its plain twin, on the card, on the random and
   adversarial GL grids at every ``GRID_SIZES`` N (some below, some not
   a multiple of, the kernel's 32-variant tile): the 14 integer fields
   bit-identical, GL/SQ/AB equal at output-format precision; then
   ``tools.gl_bench`` at N = 1024, 4096 and 65536: kernel, twin and the
   torch ``genotype_batch`` against each other, their times (the
   kernel's as ``kernel_call_ms``, the wrapper's call included, and
   ``kernel_device_ms``, replayed from a CUDA graph) and the bound;
4. golden file: the CLI on ``data/example.vcf`` against
   ``data/example.expected.vcf`` (the float64 oracle): GT and every
   integer FORMAT field identical, GL/SQ/AB/QUAL within one unit of the
   last printed digit;
5. the slice at real size: a simulated 30× paired-end WGS sample with
   1,000 DEL-heavy events, the VCF tiled to 20,500 records (21 chunks of
   1024, the last one ragged), genotyped twice through the CLI on the
   card. The GL kernel must run once per chunk, GT concordance with the
   simulated truth must reach 0.97, and the two outputs must be
   byte-identical; the first 2,048 records through ``TorchEngine`` on
   the card and on the CPU (float32, the plain twin) must give identical
   integer fields. Run 1 saves the library statistics (``-l``) that
   every later run of the fixture reads;
6. multi-device: the multi-device dryrun, then the CLI twice with each
   chunk sharded over every visible card (two shards on ``cuda:0`` when
   there is one card): byte-identical to phase 5's output, with one GL
   launch per shard of every chunk (run 1 carries the first use of any
   card past ``cuda:0``), its prep per chunk beside phase 5's on one
   shard; then ``TorchEngine`` over the same records on one shard and
   on those shards, each shard handle's fetches timed, with a decode
   fan-out that fits every shard's in the usable cores: the shards'
   fetches of a chunk must overlap, the rows equal one shard's bit for
   bit, and prep per chunk, fetch time and fetches in flight are
   logged;
7. multi-host: two CLI processes joined over gloo (``SVT_DIST_*``) on
   the card(s): rank 0's VCF byte-identical to phase 5's, rank 1's
   empty;
8. profile: the CLI with ``--profile`` on the golden example writes a
   Chrome trace that names the classify and GL kernels and no
   ``segment_reduce``, and lists the kernels of the step;
9. ``tools.profile_chunks`` on phase 5's 20,500 records at chunk sizes
   512, 1024, 2048 and 4096: integer fields identical across sizes;
10. ``tools.scaling_curve`` on the same records: 1 and 2 shards on one
    card (1, 2 and 4 cards under ``--multi-card``), each output
    identical to one device's;
11. ``tools.soak``: the library stream and the CLI, each over 200,000
    variants of phase 5's loci, host RSS and reserved device memory
    flat within 10%;
12. ``tools.dump_chunk_args`` writes the first chunk's native fetch
    arguments;
13. the full-column device step (``evidence/device.py::classify``, the
    semantic reference of the engine's ``classify_compact``): (a)
    ``parallel.dryrun.entry()`` on the 64-variant synthetic chunk, every
    variant called, counts bit-identical to ``classify_compact``'s and
    the classify kernel's, int fields equal to the CPU twin's; (b) the
    first 1,024 records of phase 5's fixture through ``prepare_chunk``:
    both classifiers' counts and the classify kernel's, and the GL
    kernel's rows from them, bit-identical, the int
    fields equal to ``TorchEngine``'s, and each classifier's device ms
    per chunk; (c) ``make_sharded_step`` over every card (two shards on
    ``cuda:0`` when there is one): every field equal to each shard's
    local result, one GL launch per shard;
14. ``tools.profile_prep``: the engine's host prep alone (no device
    step, so no GL launch) at chunk 1024 and 4096 over 1 and 2 shards
    (two on ``cuda:0`` with one card, every card under ``--multi-card``),
    each chunk's wall split into preamble, native fetch, export and the
    rest (the parts summed over concurrent shards beside the wall, and
    the wall with a fetch in flight), with the native counters and the
    usable cores; first on phase
    5's tiled records, then on the tools' 1,600-event fixture, whose loci
    are distinct (simulated in a child process while phases 3-13 run).
    The chunk count must be ceil(records / size), the reads and pairs
    those of an unwrapped ``TorchEngine._prepare`` over the same chunks,
    and the tool's wrappers gone after it;
15. the remaining entry points: (a) ``tools.reference_parity --mock``,
    every lane passing, one GL launch per chunk of its float32 lanes;
    (b) the ``svtyper-torch`` and ``svtyper-torch-sso`` console scripts
    resolved from ``setup.py`` under the jax refusal, and
    ``svtyper-torch`` on the golden example byte-identical to phase 4;
    (c) ``tools.make_example_data`` byte-identical to ``data/``;
16. the bench: each cell of ``BENCHMARK.json`` that this mode runs
    (one chip's; under ``--multi-card`` those of more than one) through
    its own command, ``python -m svtyper_tpu_torch.tools.bench`` with
    the cell's seed, in a child process, at reduced sizes (1,600 main
    events, 300 BND, 400 x 2 two-sample, 20,500 CLI records; the
    fixtures simulated by the bench's own builder in a second child
    started after phase 5's timed runs) and with the smoke's own cache.
    Its timed rows run two passes each (``SVT_BENCH_WINDOW=0``). The line
    must hold every key of ``bench.py``'s and every metric
    ``BENCHMARK.json`` names, pass its accuracy gate and its oracle
    check (warm, BND, two-sample and the CLI's output VCF), show its
    cold pass cold (bytes inflated, few cache hits) and its rows equal
    to the warm pass's, run on every visible card (byte-identical to the
    first card alone when there are several), name both kernels among
    its traced pass's device operations, and every engine pass must
    launch the classify and GL kernels once per chunk, shard and sample
    (the CLI row once per chunk and shard). On one card the one-card
    cell's command runs again with ``--control bf16`` (the classify
    counts rounded through bfloat16), and must exit 1 with the warm
    pass's and the CLI's oracle checks failed;
17. the classify kernel (``csrc/classify_kernel.cu``) against its plain
    version on the card, on the CPU tests' adversarial and edge chunks
    (``utils/parity.py``: every branch, empty segments, segments of 1,
    31-33, 63-65 and 2,049 rows off the tile's alignment, 1, 3 and 5
    variants, padding rows only), on every chunk of phase 5's records
    (21 x 1,024, warm) and of phase 14's 1,600 distinct events (cold):
    counts bit-identical to ``unwire`` → ``classify_compact``'s, and the
    engine's ``_step`` rows bit-identical to the plain path's
    (``unwire`` → ``classify_compact`` → the GL kernel); at N = 1,024
    and 4,096 the kernel's device ms (CUDA-graph replay) and call ms
    beside the plain version's, both steps' ms and host enqueue ms per
    shard per chunk, and the bound; then the engine's device profile
    over phase 5's records: H2D, step and D2H per chunk (CUDA events)
    and the device's busy share over a ``genotype_stream`` pass
    (torch.profiler);
18. the card's first use: the shipped command in two fresh child
    processes on every visible card over phase 5's records, each
    byte-identical to phase 5's in-process output, with classify and GL
    launches = chunks x cards; logs each run's first chunk, send, the
    warm-up's own wall and the first send's wait for it, and the
    warm-up's steps (``gt/engine.py::warm_devices``, which the command
    starts before it reads its inputs).

The port runs with jax and the JAX package (``svtyper_tpu``) refused,
and neither may be loaded at the end.

Each phase that drives the CLI, a tool or the full-column step zeroes
both kernels' counts (``gl_kernel.LAUNCHES`` and
``classify_kernel.LAUNCHES``) just before and reads them just after
(phases 7, 11 and 18 read a child process's counts from the engine's
``classify_launches`` and ``gl_launches`` in its ``SVT_CLI_STATS``,
phase 16 its bench child's line: its engine passes' and CLI row's), and
fails unless each kernel ran as often as
the phase's chunks ask: the engine's step launches each once per shard
of every chunk, phase 13's full-column step the GL kernel alone (once
per step and shard), phase 14 neither. The kernel line reports their
sums; phase 17's comparisons are not counted.

``--multi-card`` is the check for a host with several cards: it runs
only the phases that span cards (6, 7, 10, 13, 14, the cells of more
than one chip in 16, and 18 on every card) and the single-card phase 5
they are compared with, and prints no kernel line (phases 3 and 17
measure the kernels).

Prints diagnostics, then the card's name and power limit, one JSON line
describing each kernel, and last the result line
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import ast
import importlib
import json
import math
import os
import shlex
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
WGS_VCF = os.path.join(WORK, "wgs", "wgs.vcf")  # phase 5's 1,000 records
N_EVENTS = 1000
N_RECORDS = 20_500
CHUNK = 1024
CONC_FLOOR = 0.97
N_ENGINE_CMP = 2048
GRID_SIZES = (1, 17, 1000, 1024, 1043, 4096, 65536)
GL_SYMBOL = "gl_rows_kernel"  # the __global__ in csrc/gl_kernel.cu
# the __global__ in csrc/classify_kernel.cu
CLASSIFY_SYMBOL = "classify_compact_kernel"
RANK_TIMEOUT_S = 600
SWEEP_SIZES = (512, 1024, 2048, 4096)
SOAK_N = 200_000
SOAK_EVERY = 5  # library soak: chunks between memory samples
SOAK_INTERVAL = 0.5  # CLI soak: seconds between memory samples
FULL_REPS = 20  # phase 13: classifier calls per CUDA-event window
PREP_SIZES = (1024, 4096)  # phase 14's chunk sizes
PREP_EVENTS = 1600  # phase 14's second fixture: the tools' default, untiled
SIM_TIMEOUT_S = 900  # a fixture simulated beside the phases
BENCH_CACHE = os.path.join(WORK, "bench")
# phase 16's sizes: each cell's command at 1,600 main events (one
# chromosome, as phase 14's), 300 BND, 400 x 2 two-sample and 20,500 CLI
# records
BENCH_VARIANTS = PREP_EVENTS
BENCH_BND_EVENTS = 300
BENCH_MS_VARIANTS = 400
BENCH_CLI_VARIANTS = N_RECORDS
BENCH_TIMEOUT_S = 600
CLASSIFY_SIZES = (1024, 4096)  # phase 17's timed chunk sizes


class _RefuseJax:
    """Meta-path hook: the port must run without jax and without the
    JAX package (``svtyper_tpu``; ``svtyper_tpu_torch`` is the port)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "svtyper_tpu"):
            raise ImportError("chip_smoke: import refused (%s)" % name)
        return None


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit("FAIL: " + msg)


class Launches:
    """The launch counts of the port's two kernels, ``LAUNCHES`` of
    ``ops/gl_kernel.py`` and of ``ops/classify_kernel.py``. A phase
    zeroes both just before it drives the main path and checks both just
    after; ``total`` sums what the phases checked, for the kernel line."""

    def __init__(self, gl_kernel, classify_kernel):
        self.gl_kernel = gl_kernel
        self.classify_kernel = classify_kernel
        self.total = {"gl": 0, "classify": 0}

    def zero(self) -> None:
        self.gl_kernel.LAUNCHES = 0
        self.classify_kernel.LAUNCHES = 0

    def now(self) -> dict:
        return {"gl": self.gl_kernel.LAUNCHES,
                "classify": self.classify_kernel.LAUNCHES}

    def add(self, gl: int, classify: int) -> None:
        """Launches counted elsewhere (a child's ``SVT_CLI_STATS``)."""
        self.total["gl"] += gl
        self.total["classify"] += classify

    def check(self, phase: int, gl: int, classify=None) -> None:
        """Fails unless the launches since ``zero()`` are ``gl`` of the
        GL kernel and ``classify`` of the classify kernel (by default as
        many: the engine's step launches both), ``gl`` > 0; adds them to
        the totals."""
        want = {"gl": gl, "classify": gl if classify is None else classify}
        got = self.now()
        check(got == want and gl > 0, "phase %d: kernel launches %s, "
              "expected %s" % (phase, got, want))
        self.add(**got)


def same_bits(a, b) -> bool:
    """Two float32 tensors of one shape, equal bit for bit."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build(_build, native):
    """Phase 2: both CUDA kernels and the native decoder, built side by
    side from the checkout's sources (one nvcc per kernel, all started
    together; ``_build.load`` locks each library on its own) and
    loaded."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    kernels = ("gl_kernel", "classify_kernel")
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(kernels) + 1) as pool:
        built = [pool.submit(timed, lambda k=k: _build.load(k))
                 for k in kernels]
        decoder = pool.submit(timed, native.require_lib)
        k_s = [f.result() for f in built]
        d_s = decoder.result()
    log("phase 2: built and loaded %s (nvcc %s) and %s in %.2f s (make), "
        "side by side: %.2f s in all"
        % (", ".join("%s in %.2f s" % (_build.build(k), t)
                     for k, t in zip(kernels, k_s)),
           " ".join(_build.NVCC_FLAGS), native._SO, d_s, time.time() - t0))
    for k in kernels:
        report = _build.PTXAS.get(_build.build(k))
        log("phase 2: ptxas -v, %s: %s" % (
            k, "not rebuilt in this process" if report is None
            else " | ".join(report)))


def phase_kernel(torch, gl_kernel, parity, gl_bench):
    """Phase 3 → (max abs error, {N: gl_bench's result})."""
    max_err = 0.0
    for n in GRID_SIZES:
        for grid in (parity.random_counts, parity.adversarial_counts):
            counts, is_dup, force_null = grid(n)
            args = (
                torch.tensor(counts, dtype=torch.float32, device="cuda"),
                torch.tensor(is_dup, dtype=torch.uint8, device="cuda"),
                torch.tensor(force_null, dtype=torch.uint8, device="cuda"),
            )
            got = gl_kernel.genotype_rows_cuda(*args)
            torch.cuda.synchronize()
            want = gl_kernel.genotype_rows_plain(*args)
            got, want = got.cpu().numpy(), want.cpu().numpy()
            check(got.shape == (n, 24), "kernel output shape %s" % (got.shape,))
            bad = (got[:, :14] != want[:, :14]).any(axis=0)
            check(not bad.any(), "N=%d %s: int fields differ in columns %s"
                  % (n, grid.__name__, bad.nonzero()[0].tolist()))
            ref, _, _ = parity.rows_split(want)
            _, ints, flts = parity.rows_split(got)
            parity.assert_format_parity(
                ref, ints, flts, n, min_checked=101 if n >= 1000 else 0
            )
            err = float(abs(got.astype("f8") - want.astype("f8")).max())
            max_err = max(max_err, err)
            log("phase 3: N=%d %s: int fields bit-identical, floats at "
                "format precision (max abs err %.3g)"
                % (n, grid.__name__, err))
    times = {}
    for n in gl_bench.SIZES:
        res = times[n] = gl_bench.bench(n, "cuda")
        log("phase 3: gl_bench %s" % json.dumps(res))
        log("phase 3: N=%d: kernel_device_ms %.6f, kernel_call_ms %.6f, "
            "bound %.6f ms (%s), %.4f of it"
            % (n, res["kernel_device_ms"], res["kernel_call_ms"],
               res["bound_ms"], res["bound_by"], res["bound_share"]))
    return max_err, times


def run_cli(classic, vcf, bam, out, extra=(), stats=None, **devices):
    """The shipped command, in-process, on the card → wall seconds.
    ``devices`` are ``main``'s ``device``/``devices`` arguments."""
    if stats:
        os.environ["SVT_CLI_STATS"] = stats
    t0 = time.time()
    try:
        rc = classic.main(["-i", vcf, "-B", bam, "-o", out, *extra],
                          **devices)
    finally:
        os.environ.pop("SVT_CLI_STATS", None)
    check(rc == 0, "CLI exit code %s" % rc)
    return time.time() - t0


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def phase_golden(classic, parity):
    out = os.path.join(WORK, "example.vcf")
    data = os.path.join(ROOT, "data")
    run_cli(classic, os.path.join(data, "example.vcf"),
            os.path.join(data, "example.sim.sorted.bam"), out,
            extra=("-n", "60000"))
    with open(out) as fh:
        got = fh.read()
    with open(os.path.join(data, "example.expected.vcf")) as fh:
        want = fh.read()
    identical, errors = parity.golden_diff(got, want)
    n_rec = sum(1 for l in want.splitlines() if not l.startswith("#"))
    check(not errors, "golden file: %s" % errors[:10])
    log("phase 4: golden file: %d/%d records byte-identical, the rest "
        "within one unit of the last printed digit" % (identical, n_rec))
    return out


def concordance(path, truth):
    hit = total = 0
    with open(path) as fh:
        body = [l for l in fh if not l.startswith("#")]
    for i, line in enumerate(body):
        gt = line.rstrip("\n").split("\t")[9].split(":")[0]
        total += 1
        hit += gt == truth[i % len(truth)]
    return hit / max(total, 1), total


def phase_slice(torch, classic, K, fixture):
    t0 = time.time()
    bam, vcf, truth = fixture.simulate_wgs(
        os.path.dirname(WGS_VCF), N_EVENTS, depth=30.0
    )
    tiled = os.path.join(WORK, "wgs_tiled.vcf")
    fixture.tile_vcf(vcf, tiled, N_RECORDS)
    log("phase 5: simulated %d events at 30x in %.1f s; VCF tiled to %d "
        "records" % (N_EVENTS, time.time() - t0, N_RECORDS))
    n_chunks = -(-N_RECORDS // CHUNK)
    lib = os.path.join(WORK, "wgs_lib.json")
    runs = []
    for r in (1, 2):
        out = os.path.join(WORK, "wgs_run%d.vcf" % r)
        stats_path = os.path.join(WORK, "stats%d.json" % r)
        K.zero()
        wall = run_cli(classic, tiled, bam, out, extra=("-l", lib),
                       stats=stats_path, device="cuda")
        K.check(5, n_chunks)
        with open(stats_path) as fh:
            st = json.load(fh)
        check(st["chunks"] == n_chunks, "run %d: %s chunks" % (r, st["chunks"]))
        check(st["classify_launches"] == st["gl_launches"] == n_chunks,
              "run %d: the engine counted %d classify and %d GL launches "
              "for %d chunks" % (r, st["classify_launches"],
                                 st["gl_launches"], n_chunks))
        conc, n_eval = concordance(out, truth)
        check(n_eval == N_RECORDS, "run %d: %d records out" % (r, n_eval))
        check(conc >= CONC_FLOOR, "run %d: GT concordance %.4f < %.2f"
              % (r, conc, CONC_FLOOR))
        vps = N_RECORDS / st["genotype_wall_s"]
        log("phase 5: run %d: %d records, %d chunks, %d classify and %d GL "
            "kernel launches, GT concordance %.4f; %.1f variants/s over "
            "genotyping (%.2f s; whole command %.2f s incl. library %s); "
            "prep %.3f s, send %.3f s, sync %.3f s; %d reads, %d pairs"
            % (r, N_RECORDS, st["chunks"], st["classify_launches"],
               st["gl_launches"], conc, vps, st["genotype_wall_s"], wall,
               "scan" if r == 1 else "load", st["prep_s"], st["send_s"],
               st["sync_s"], st["reads"], st["pairs"]))
        runs.append(out)
    check(read_bytes(runs[0]) == read_bytes(runs[1]),
          "two runs gave different output")
    log("phase 5: the two runs are byte-identical")

    from svtyper_tpu_torch.gt.engine import TorchEngine

    sample, bps = fixture.load_sample_and_breakpoints(
        bam, tiled, N_ENGINE_CMP, num_samp=1_000_000
    )
    rows = {}
    for dev in ("cuda", "cpu"):
        eng = TorchEngine([sample], device=dev, dtype=torch.float32)
        rows[dev] = [a[0][:n] for n, a in eng.genotype_stream(bps, raw=True)]
        eng.close()
    import numpy as np

    a = np.concatenate(rows["cuda"])
    b = np.concatenate(rows["cpu"])
    check(a.shape == (N_ENGINE_CMP, 24), "engine rows %s" % (a.shape,))
    check(np.isfinite(a).all(), "non-finite engine rows on the card")
    bad = (a[:, :14] != b[:, :14]).any(axis=0)
    check(not bad.any(), "CUDA vs CPU f32 engine: int fields differ in "
          "columns %s" % bad.nonzero()[0].tolist())
    log("phase 5: first %d records, TorchEngine on the card vs the CPU "
        "(float32, the plain versions): int fields identical; max abs "
        "float diff %.3g"
        % (N_ENGINE_CMP, float(abs(a[:, 14:] - b[:, 14:]).max())))
    return bam, tiled, lib, runs[0]


def stats_line(st):
    return ("genotyping %.6f s, prep %.6f s, send %.6f s, sync %.6f s"
            % (st["genotype_wall_s"], st["prep_s"], st["send_s"],
               st["sync_s"]))


def phase_multidevice(torch, classic, K, wgs):
    """Phase 6: the CLI twice, each chunk sharded over every card; then
    the shards' concurrent prep (``shard_overlap``)."""
    from svtyper_tpu_torch.parallel.dryrun import dryrun_multichip

    bam, tiled, lib, want = wgs
    n_vis = torch.cuda.device_count()
    devices = (["cuda:%d" % i for i in range(n_vis)] if n_vis > 1
               else ["cuda:0", "cuda:0"])
    dryrun_multichip(len(devices), "cuda:0")
    for r in (1, 2):
        out = os.path.join(WORK, "wgs_multidevice%d.vcf" % r)
        stats_path = os.path.join(WORK, "stats_multidevice%d.json" % r)
        K.zero()
        wall = run_cli(classic, tiled, bam, out, extra=("-l", lib),
                       stats=stats_path, devices=devices)
        launches = K.now()
        with open(stats_path) as fh:
            st = json.load(fh)
        check(read_bytes(out) == read_bytes(want),
              "multi-device run %d: output differs from phase 5's" % r)
        n_launch = st["chunks"] * len(devices)
        check(st["classify_launches"] == st["gl_launches"] == n_launch,
              "multi-device run %d: the engine counted %d classify and %d GL "
              "launches for %d chunks x %d shards"
              % (r, st["classify_launches"], st["gl_launches"], st["chunks"],
                 len(devices)))
        K.check(6, n_launch)
        with open(os.path.join(WORK, "stats%d.json" % r)) as fh:
            one = json.load(fh)
        log("phase 6: run %d: %d shards on %s: byte-identical to phase 5; "
            "%d chunks, %d classify and %d GL launches; %s (whole command "
            "%.2f s); prep per chunk %.3f ms against phase 5's run %d on one "
            "shard %.3f ms"
            % (r, len(devices), ",".join(devices), st["chunks"],
               launches["classify"], launches["gl"], stats_line(st), wall,
               st["prep_s"] / st["chunks"] * 1e3, r,
               one["prep_s"] / one["chunks"] * 1e3))
    shard_overlap(torch, K, wgs, devices)


def _overlaps(spans) -> bool:
    """Whether any two of the (start, end) spans intersect."""
    end = float("-inf")
    for t0, t1 in sorted(spans):
        if t0 < end:
            return True
        end = max(end, t1)
    return False


def shard_overlap(torch, K, wgs, devices):
    """Phase 6, engine part: phase 5's records through ``TorchEngine`` on
    one shard and on ``devices``, each shard handle's ``fetch_chunk``
    timed. Each handle's decode fan-out is sized so that every shard's
    fits the usable cores (as ``--cores`` would set it; the auto fan-out
    of an 8-core host leaves room for one fetch at a time), so the
    shards' fetches of a chunk must overlap; the rows must equal one
    shard's bit for bit, with one launch of each kernel per shard of
    every chunk."""
    import threading

    import numpy as np
    from svtyper_tpu_torch.bamio.bam import open_bam
    from svtyper_tpu_torch.gt.engine import TorchEngine
    from svtyper_tpu_torch.stats import Sample
    from svtyper_tpu_torch.tools.profile_prep import span_union
    from svtyper_tpu_torch.utils import fixture

    bam, tiled, lib, _ = wgs
    cores = len(os.sched_getaffinity(0))
    threads = max(1, min(8, cores // len(devices)))
    _, bps = fixture.load_sample_and_breakpoints(bam, tiled, lib_info=lib)
    rows, seen = {}, {}
    for devs in (devices[:1], devices):
        sample = Sample.from_lib_info(open_bam(bam, threads=threads),
                                      Sample.load_lib_info(lib))
        eng = TorchEngine([sample], devices=devs)
        spans, lock = [], threading.Lock()
        for h in {id(h): h for h in eng.shard_bams()[0]}.values():
            def fetch(*a, _fn=h.fetch_chunk, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    with lock:
                        spans.append((t0, time.perf_counter()))
            h.fetch_chunk = fetch
        K.zero()
        rows[len(devs)] = np.concatenate(
            [a[0][:n] for n, a in eng.genotype_stream(bps, raw=True)])
        st = dict(eng.stats)
        eng.close()
        K.check(6, st["chunks"] * len(devs))
        check(st["classify_launches"] == st["gl_launches"]
              == st["chunks"] * len(devs), "phase 6: the engine counted %d "
              "classify and %d GL launches for %d chunks x %d shards"
              % (st["classify_launches"], st["gl_launches"], st["chunks"],
                 len(devs)))
        check(len(spans) == st["chunks"] * len(devs), "phase 6: %d fetches "
              "for %d chunks x %d shards" % (len(spans), st["chunks"],
                                             len(devs)))
        # _prepare runs on one prep thread: a chunk's fetches all end
        # before the next chunk's begin
        spans.sort()
        chunks = [spans[i:i + len(devs)]
                  for i in range(0, len(spans), len(devs))]
        fetch_s = sum(t1 - t0 for t0, t1 in spans)
        union_s = sum(span_union(c) for c in chunks)
        seen[len(devs)] = (st, fetch_s, union_s,
                           sum(_overlaps(c) for c in chunks))
    (st1, f1, _, _), (stn, fn, un, over) = seen[1], seen[len(devices)]
    check(rows[len(devices)].tobytes() == rows[1].tobytes(),
          "phase 6: %d shards' rows differ from one shard's" % len(devices))
    check(over > 0, "phase 6: the %d shards' fetches never overlapped in %d "
          "chunks" % (len(devices), stn["chunks"]))
    log("phase 6: engine, %d records, %d decode threads per handle (%d "
        "usable cores of %d): one shard prep %.3f ms per chunk (fetch %.3f "
        "ms); %d shards prep %.3f ms per chunk (fetches %.3f ms summed, "
        "%.3f ms with one or more in flight, %.2f in flight on average); "
        "%d of %d chunks' shard fetches overlapped; rows bit-identical to "
        "one shard's"
        % (len(bps), threads, cores, os.cpu_count(),
           st1["prep_s"] / st1["chunks"] * 1e3, f1 / st1["chunks"] * 1e3,
           len(devices), stn["prep_s"] / stn["chunks"] * 1e3,
           fn / stn["chunks"] * 1e3, un / stn["chunks"] * 1e3, fn / un,
           over, stn["chunks"]))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# a rank of the CLI under the smoke's jax refusal
_RANK = (
    "import sys; import chip_smoke; "
    "sys.meta_path.insert(0, chip_smoke._RefuseJax()); "
    "from svtyper_tpu_torch.cli.classic import main; "
    "sys.exit(main(sys.argv[1:]))"
)


def phase_multihost(torch, K, wgs):
    """Phase 7: two gloo ranks, their launches added to ``K``."""
    bam, tiled, lib, want = wgs
    port = free_port()
    procs, outs, stats, errs = [], [], [], []
    t0 = time.time()
    try:
        for rank in (0, 1):
            outs.append(os.path.join(WORK, "wgs_rank%d.vcf" % rank))
            stats.append(os.path.join(WORK, "stats_rank%d.json" % rank))
            errs.append(os.path.join(WORK, "rank%d.err" % rank))
            env = dict(
                os.environ, PYTHONPATH=ROOT,
                SVT_DIST_COORD="127.0.0.1:%d" % port,
                SVT_DIST_NPROCS="2", SVT_DIST_PROCID=str(rank),
                SVT_CLI_STATS=stats[-1],
            )
            with open(errs[-1], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _RANK, "-i", tiled, "-B", bam,
                     "-o", outs[-1], "-l", lib],
                    cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err,
                ))
        deadline = time.time() + RANK_TIMEOUT_S
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(deadline - time.time(), 1)))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    for rank, rc in enumerate(rcs):
        if rc != 0:
            with open(errs[rank]) as fh:
                tail = fh.read()[-3000:]
            check(False, "multi-host rank %d: exit %s\n%s" % (rank, rc, tail))
    check(read_bytes(outs[0]) == read_bytes(want),
          "multi-host rank 0 output differs from phase 5's")
    check(os.path.getsize(outs[1]) == 0, "multi-host rank 1 wrote output")
    n_dev = torch.cuda.device_count()
    for rank in (0, 1):
        with open(stats[rank]) as fh:
            st = json.load(fh)
        check(st["classify_launches"] == st["gl_launches"]
              == st["chunks"] * n_dev > 0,
              "multi-host rank %d: %d classify and %d GL launches for %d "
              "chunks" % (rank, st["classify_launches"], st["gl_launches"],
                          st["chunks"]))
        K.add(st["gl_launches"], st["classify_launches"])
        log("phase 7: rank %d: %d chunks, %d classify and %d GL launches; "
            "%s, gather %.6f s (whole command %.2f s)"
            % (rank, st["chunks"], st["classify_launches"],
               st["gl_launches"], stats_line(st), st["gather_s"],
               st["total_wall_s"]))
    log("phase 7: 2 ranks over gloo: rank 0 byte-identical to phase 5, "
        "rank 1 empty; both processes %.2f s" % wall)


def phase_fresh_cli(torch, K, wgs):
    """Phase 18: the shipped command in two fresh child processes on
    every visible card, each card's first use in the process; their
    launches added to ``K``."""
    bam, tiled, lib, want = wgs
    n_dev = torch.cuda.device_count()
    n_chunks = -(-N_RECORDS // CHUNK)
    for r in (1, 2):
        out = os.path.join(WORK, "wgs_fresh%d.vcf" % r)
        stats = os.path.join(WORK, "stats_fresh%d.json" % r)
        err = os.path.join(WORK, "fresh%d.err" % r)
        env = dict(os.environ, PYTHONPATH=ROOT, SVT_CLI_STATS=stats)
        t0 = time.time()
        with open(err, "w") as fh:
            try:
                rc = subprocess.run(
                    [sys.executable, "-c", _RANK, "-i", tiled, "-B", bam,
                     "-o", out, "-l", lib], cwd=ROOT, env=env,
                    stdout=subprocess.DEVNULL, stderr=fh,
                    timeout=RANK_TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        wall = time.time() - t0
        if rc != 0:
            with open(err) as fh:
                check(False, "phase 18: run %d: exit %s\n%s"
                      % (r, rc, fh.read()[-3000:]))
        with open(stats) as fh:
            st = json.load(fh)
        check(read_bytes(out) == read_bytes(want),
              "phase 18: run %d: output differs from phase 5's" % r)
        check(st["chunks"] == n_chunks
              and st["classify_launches"] == st["gl_launches"]
              == n_chunks * n_dev,
              "phase 18: run %d: %d classify and %d GL launches for %d "
              "chunks x %d cards" % (r, st["classify_launches"],
                                     st["gl_launches"], st["chunks"], n_dev))
        K.add(st["gl_launches"], st["classify_launches"])
        log("phase 18: run %d, a fresh process on %d card(s): byte-identical "
            "to phase 5; %d chunks, %d classify and %d GL launches; first "
            "chunk %.6f s, %s; warm-up %.6f s, the first send's wait for it "
            "%.6f s; whole command %.6f s (%.2f s with the interpreter's "
            "start); warm-up steps, s: %s"
            % (r, n_dev, st["chunks"], st["classify_launches"],
               st["gl_launches"], st["first_chunk_s"], stats_line(st),
               st["warm_s"], st["warm_wait_s"], st["total_wall_s"], wall,
               json.dumps(st["warm_parts"], sort_keys=True)))


def phase_profile(classic, K, golden_out):
    """Phase 8: the profiled CLI; its trace must name both kernels and
    no ``segment_reduce``."""
    data = os.path.join(ROOT, "data")
    prof = os.path.join(WORK, "profile")
    out = os.path.join(WORK, "example_profiled.vcf")
    K.zero()
    wall = run_cli(classic, os.path.join(data, "example.vcf"),
                   os.path.join(data, "example.sim.sorted.bam"), out,
                   extra=("-n", "60000", "--profile", prof))
    launches = K.now()["gl"]
    K.check(8, launches)
    check(read_bytes(out) == read_bytes(golden_out),
          "profiled output differs from phase 4's")
    traces = os.listdir(prof)
    check(len(traces) == 1, "profile dir holds %s" % traces)
    with open(os.path.join(prof, traces[0])) as fh:
        events = json.load(fh)["traceEvents"]
    named = {sym: [e for e in events if sym in e.get("name", "")]
             for sym in (CLASSIFY_SYMBOL, GL_SYMBOL)}
    for sym, evs in named.items():
        check(len(evs) > 0, "the trace does not name %s" % sym)
    seg = sorted({e["name"] for e in events
                  if "segment_reduce" in e.get("name", "")})
    check(not seg, "the profiled step still runs %s" % seg)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e["name"][:60] for e in kernels})
    log("phase 8: --profile wrote %s (%d events); %s for %d launches of "
        "each; no segment_reduce; %d device kernel events of %d names "
        "(%.2f per launch): %s; whole command %.2f s"
        % (traces[0], len(events), ", ".join(
            "%d %s events, %.1f us in all"
            % (len(evs), sym, sum(e.get("dur", 0) for e in evs))
            for sym, evs in named.items()), launches, len(kernels),
           len(names), len(kernels) / launches, " | ".join(names), wall))


def phase_logger(phase: int):
    return lambda obj: log("phase %d: %s" % (phase, json.dumps(obj)))


def phase_chunk_sweep(K, profile_chunks, wgs):
    """Phase 9: one launch of each kernel for the first call of each
    chunk size, then one per chunk of every rep."""
    bam, tiled = wgs[:2]
    K.zero()
    results, _ = profile_chunks.run(bam, tiled, sizes=SWEEP_SIZES,
                                    device="cuda", emit=phase_logger(9))
    want = sum(1 + sum(rep["chunks"] for rep in r["reps"]) for r in results)
    K.check(9, want)
    best = max(results, key=lambda r: r["median_variants_per_s"])
    base = next(r for r in results if r["chunk_size"] == CHUNK)
    log("phase 9: int fields identical across chunk sizes %s; fastest "
        "chunk %d at %.1f variants/s (median of %d), %.3fx chunk %d's; %d "
        "classify and GL launches each" % (
            list(SWEEP_SIZES), best["chunk_size"],
            best["median_variants_per_s"], len(best["reps"]),
            best["median_variants_per_s"] / base["median_variants_per_s"],
            CHUNK, want))


def phase_scaling(torch, K, scaling_curve, wgs):
    """Phase 10: a warm-up and a timed run per device count, one launch
    of each kernel per shard of every chunk."""
    bam, tiled = wgs[:2]
    counts = (1, 2) if torch.cuda.device_count() == 1 else (1, 2, 4)
    K.zero()
    rows = scaling_curve.run(bam, tiled, device="cuda", counts=counts,
                             emit=phase_logger(10))
    want = sum(2 * r["chunks"] * r["devices"] for r in rows)
    K.check(10, want)
    log("phase 10: %s devices on %s card(s): every output identical to one "
        "device's; %d classify and GL launches each"
        % ([r["devices"] for r in rows], [r["cards"] for r in rows], want))


def phase_soak(K, soak, wgs_vcf, bam):
    """Phase 11: the library and the CLI soak."""
    K.zero()
    lib = soak.soak_library(bam, wgs_vcf, n=SOAK_N, device="cuda",
                            every=SOAK_EVERY, emit=phase_logger(11))
    K.check(11, 1 + lib["chunks"])
    cli = soak.soak_cli(bam, wgs_vcf, n=SOAK_N, interval=SOAK_INTERVAL,
                        emit=phase_logger(11))
    check(cli["classify_launches"] == cli["gl_launches"] == cli["chunks"] > 0,
          "phase 11: the CLI soak launched %d classify and %d GL kernels "
          "for %d chunks" % (cli["classify_launches"], cli["gl_launches"],
                             cli["chunks"]))
    K.add(cli["gl_launches"], cli["classify_launches"])
    log("phase 11: library soak %d variants, RSS drift %.4f, CUDA reserved "
        "drift %.4f; CLI soak %d records, RSS drift %.4f, CUDA reserved "
        "drift %.4f (limit 0.10 each); %d + %d launches of each kernel"
        % (lib["soak_variants"], lib["rss_drift"], lib["cuda_drift"],
           cli["cli_soak_variants"], cli["rss_drift"], cli["cuda_drift"],
           1 + lib["chunks"], cli["gl_launches"]))


def phase_dump(K, dump_chunk_args, wgs):
    """Phase 12: one chunk, one launch of each kernel."""
    bam, tiled = wgs[:2]
    out = os.path.join(WORK, "chunkbin")
    K.zero()
    written = dump_chunk_args.dump(bam, tiled, out, device="cuda",
                                   emit=phase_logger(12))
    K.check(12, 1)
    check(all(os.path.getsize(p) > 0 for p in written),
          "phase 12: an empty dump file")
    log("phase 12: %d files in %s; 1 classify and 1 GL launch"
        % (len(written), out))


def device_ms(torch, fn, reps: int):
    """→ (ms per call between two CUDA events around ``reps``
    back-to-back calls, ms per call the host took to enqueue them),
    after one warm-up call. Equal numbers mean the host's dispatch, not
    the device, sets the pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def _on(torch, cols, dev):
    import numpy as np

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in cols.items()}


def _compact_counts(torch, chunk, dens, dev):
    """``chunk``'s compact wire, sent as the engine sends it (``pack_wire``
    → one uint8 buffer) → (the plain classifier on it: ``unwire`` →
    ``classify_compact``, the classify kernel on it)."""
    from svtyper_tpu_torch.evidence.device import classify_compact
    from svtyper_tpu_torch.evidence.extract import compact_chunk
    from svtyper_tpu_torch.gt.engine import pack_wire
    from svtyper_tpu_torch.ops.classify_kernel import (
        classify_compact_cuda, unwire,
    )

    wire, geom = pack_wire(compact_chunk(chunk, min_aligned=20))
    wire = torch.from_numpy(wire).to(dev)
    parts = unwire(wire, geom)
    dens = dens.contiguous()
    return (lambda: classify_compact(*parts, dens, chunk.n_var,
                                     dtype=torch.float32),
            lambda: classify_compact_cuda(wire, geom, dens, chunk.n_var))


def phase_full_column(torch, K, wgs, dev="cuda:0"):
    """Phase 13: the full-column device step (GL launches only: it
    classifies with ``classify``)."""
    import numpy as np

    from svtyper_tpu_torch.evidence.device import classify
    from svtyper_tpu_torch.evidence.extract import prepare_chunk
    from svtyper_tpu_torch.gt.engine import INT_FIELDS, TorchEngine, dens_state
    from svtyper_tpu_torch.parallel import (
        make_mesh, make_sharded_step, stack_shards,
    )
    from svtyper_tpu_torch.parallel.dryrun import entry
    from svtyper_tpu_torch.parallel.mesh import genotype_step
    from svtyper_tpu_torch.parallel.synth import make_synthetic_chunk
    from svtyper_tpu_torch.utils import fixture

    n_int = len(INT_FIELDS)
    f32 = torch.float32
    gl_kernel = K.gl_kernel

    # (a) entry() on the card against the compact path and the CPU twin
    step, args = entry(device=dev)
    K.zero()
    got = {k: v.cpu().numpy() for k, v in step(*args).items()}
    K.check(13, 1, classify=0)
    chunk, _ = make_synthetic_chunk(n_var=64, frags_per_var=8)
    plain, kernel = _compact_counts(torch, chunk, args[3], dev)
    compact, kern = plain(), kernel()
    check(same_bits(compact, kern), "phase 13: the classify kernel's counts "
          "differ from classify_compact's on the synthetic chunk")
    compact = compact.cpu().numpy()
    cstep, cargs = entry(device="cpu")
    twin = {k: v.numpy() for k, v in cstep(*cargs).items()}
    check(got["gt_idx"].shape == (64,) and not got["null"].any(),
          "phase 13: entry() left variants uncalled")
    check(np.array_equal(got["counts"], compact),
          "phase 13: entry() counts differ from classify_compact's")
    bad = [k for k in INT_FIELDS if not np.array_equal(got[k], twin[k])]
    check(not bad, "phase 13: entry() int fields %s differ from the CPU "
          "twin's" % bad)
    log("phase 13: (a) entry() on %s: 64/64 variants called, counts "
        "bit-identical to classify_compact's and the classify kernel's, "
        "int fields equal to the CPU twin's; 1 GL launch" % dev)

    # (b) one main-path chunk of phase 5's fixture, both classifiers
    bam, tiled, lib = wgs[:3]
    sample, bps = fixture.load_sample_and_breakpoints(bam, tiled, CHUNK,
                                                      lib_info=lib)
    chunk = prepare_chunk(sample, bps, min_aligned=20)
    n_var = chunk.n_var
    check(n_var == CHUNK, "phase 13: %d variants in the chunk" % n_var)
    dens = dens_state(sample.dens_matrix(), dev, f32)
    reads, pairs, variants = (_on(torch, c, dev) for c in (
        chunk.reads, chunk.pairs, chunk.variants))

    def full():
        return classify(reads, pairs, variants, dens, n_var, 20, dtype=f32,
                        rows_sorted=True)

    comp, comp_kernel = _compact_counts(torch, chunk, dens, dev)
    c_full, c_comp, c_kern = full(), comp(), comp_kernel()
    check(torch.equal(c_full, c_comp), "phase 13: full-column counts differ "
          "from classify_compact's in %d variants"
          % int((c_full != c_comp).any(dim=1).sum()))
    check(same_bits(c_full, c_kern), "phase 13: full-column counts differ "
          "from the classify kernel's in %d variants"
          % int((c_full != c_kern).any(dim=1).sum()))
    flags = [variants[k].to(torch.uint8) for k in ("is_dup", "force_null")]
    K.zero()
    rows = gl_kernel.genotype_rows(c_full, *flags)
    K.check(13, 1, classify=0)
    rows_comp = gl_kernel.genotype_rows(c_comp, *flags)
    check(torch.equal(rows, rows_comp),
          "phase 13: GL rows of the two classifiers differ")
    with TorchEngine([sample], device=dev, dtype=f32) as eng:
        eng_rows = np.concatenate(
            [a[0][:n] for n, a in eng.genotype_stream(bps, raw=True)])
    rows = rows.cpu().numpy()
    check(np.isfinite(rows).all(), "phase 13: non-finite GL rows")
    bad = (rows[:, :n_int] != eng_rows[:, :n_int]).any(axis=0)
    check(not bad.any(), "phase 13: int fields differ from TorchEngine's in "
          "columns %s" % bad.nonzero()[0].tolist())
    ms = {"classify": [], "classify_compact": []}
    for name in ("classify", "classify_compact", "classify_compact",
                 "classify"):
        fn = full if name == "classify" else comp
        ms[name].append(device_ms(torch, fn, FULL_REPS))
    log("phase 13: (b) %d records of phase 5's fixture (%d reads, %d "
        "pairs): full-column counts bit-identical to classify_compact's "
        "and the classify kernel's, GL rows to the compact path's, int "
        "fields equal to TorchEngine's; ms per chunk "
        "(%d calls, in turns), CUDA events (host enqueue): classify %s, "
        "classify_compact %s" % (
            n_var, int((chunk.reads["var"] < n_var).sum()),
            int((chunk.pairs["var"] < n_var).sum()), FULL_REPS,
            " / ".join("%.6f (%.6f)" % t for t in ms["classify"]),
            " / ".join("%.6f (%.6f)" % t for t in ms["classify_compact"])))

    # (c) the sharded step over every card (two shards on one card)
    n_vis = torch.cuda.device_count()
    devices = make_mesh() if n_vis > 1 else make_mesh(devices=[dev] * 2)
    n_dev = len(devices)
    per = CHUNK // n_dev
    parts = [bps[d * per:(d + 1) * per] for d in range(n_dev)]
    sizes = [prepare_chunk(sample, p, min_aligned=20) for p in parts]
    r_pad = max(len(c.reads["var"]) for c in sizes)
    f_pad = max(len(c.pairs["var"]) for c in sizes)
    shards = [prepare_chunk(sample, p, min_aligned=20, pad_reads=r_pad,
                            pad_pairs=f_pad) for p in parts]
    stacked = stack_shards(shards)
    dens_np = dens_state(sample.dens_matrix(), "cpu", torch.float64).numpy()
    sharded = make_sharded_step(devices, per, dtype=f32)
    K.zero()
    out = sharded(stacked["reads"], stacked["pairs"], stacked["variants"],
                  np.stack([dens_np] * n_dev))
    K.check(13, n_dev, classify=0)
    for d, (c, d_dev) in enumerate(zip(shards, devices)):
        local = genotype_step(
            _on(torch, c.reads, d_dev), _on(torch, c.pairs, d_dev),
            _on(torch, c.variants, d_dev),
            torch.as_tensor(dens_np).to(d_dev, f32), per, rows_sorted=True,
        )
        bad = [k for k in local
               if not torch.equal(out[k][d], local[k].cpu())]
        check(not bad, "phase 13: shard %d on %s: %s differ from its local "
              "result" % (d, d_dev, bad))
        check(not out["null"][d].all(), "phase 13: shard %d called nothing"
              % d)
    log("phase 13: (c) make_sharded_step over %s: %d shards of %d variants, "
        "every field equal to each shard's local result; %d GL launches"
        % (",".join(str(d) for d in devices), n_dev, per, n_dev))


def start_child(name, code):
    """Runs ``code`` in a child process under the jax refusal, beside
    the phases that follow → (the process, its stderr path)."""
    err = os.path.join(WORK, name + ".err")
    code = ("import sys; import chip_smoke; "
            "sys.meta_path.insert(0, chip_smoke._RefuseJax()); " + code)
    with open(err, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=ROOT),
                                stdout=subprocess.DEVNULL, stderr=fh)
    return proc, err


def start_prep_fixture():
    """Simulates phase 14's second fixture (``tools.common.default_fixture``
    at ``PREP_EVENTS``)."""
    return start_child("prep_fixture", "from svtyper_tpu_torch.tools import "
                       "common; common.default_fixture(%d)" % PREP_EVENTS)


def bench_cells(multi_card: bool):
    """``BENCHMARK.json`` → (its metrics, the cells this mode runs: one
    card's, or under ``--multi-card`` those of more than one)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    return spec["metrics"], [c for c in spec["workloads"]
                             if (c["chips"] > 1) == multi_card]


def cell_args(bench, cell):
    """A cell's command → its bench arguments (``bench.parse_args``)."""
    argv = shlex.split(cell["cmd"])
    check(argv[:3] == ["python", "-m", "svtyper_tpu_torch.tools.bench"],
          "phase 16: cell %s runs %s, not the bench" % (cell["name"], argv))
    return bench.parse_args(argv[3:])


def start_bench_fixtures(bench, seed: int):
    """Simulates phase 16's fixtures at the cells' seed into the bench's
    cache with the bench's own builder."""
    return start_child("bench_fixtures", (
        "from svtyper_tpu_torch.tools import bench; "
        "bench.build_fixtures(bench.knobs(seed=%d, cache=%r, depth=30.0, "
        "n_variants=%d, bnd_events=%d, ms_variants=%d))")
        % (seed, BENCH_CACHE, BENCH_VARIANTS, BENCH_BND_EVENTS,
           BENCH_MS_VARIANTS))


def wait_child(sim, phase: int, what: str) -> None:
    """Fails unless the child ``sim`` ends with 0 inside the time limit."""
    proc, err = sim
    t0 = time.time()
    try:
        rc = proc.wait(timeout=SIM_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != 0:
        with open(err) as fh:
            check(False, "phase %d: simulating %s: exit %s\n%s"
                  % (phase, what, rc, fh.read()[-3000:]))
    log("phase %d: %s ready %.1f s after the phase began"
        % (phase, what, time.time() - t0))


def stop_children(sims) -> None:
    for proc, _ in sims:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _prep_line(name, r):
    med, p90, nat = r["median"], r["p90"], r["native"]
    return (
        "phase 14: %s, chunk %d x %d shard(s) on %d card(s): %d chunks, "
        "prep %.1f variants/s (%.6f s); per chunk ms, median (p90): wall "
        "%.3f (%.3f), preamble %.3f (%.3f), fetch %.3f (%.3f), export %.3f "
        "(%.3f), the three summed %.3f (%.3f), other %.3f (%.3f), wall "
        "with a fetch in flight %.3f (%.3f); native: inflate %.6f s wall, "
        "%.6f s CPU, workers %.6f s, %d blocks, %d cache hits, %d bytes "
        "inflated; %d reads, %d pairs; %d usable cores" % (
            name, r["chunk_size"], r["shards"], r["cards"], r["chunks"],
            r["prep_variants_per_s"], r["wall_s"], med["wall_ms"],
            p90["wall_ms"], med["preamble_ms"], p90["preamble_ms"],
            med["fetch_ms"], p90["fetch_ms"], med["export_ms"],
            p90["export_ms"], med["parts_ms"], p90["parts_ms"],
            med["other_ms"], p90["other_ms"], med["fetch_union_ms"],
            p90["fetch_union_ms"], nat["inflate_s"], nat["inflate_cpu_s"],
            nat["worker_s"], nat["blocks"], nat["cache_hits"],
            nat["inflate_bytes"],
            r["reads"], r["pairs"], r["usable_cores"]))


def phase_prep(torch, K, common, profile_prep, wgs, sim):
    """Phase 14: the engine's host prep per chunk, split, on phase 5's
    tiled fixture and on the tools' untiled one. Runs no device step."""
    from svtyper_tpu_torch.evidence import extract
    from svtyper_tpu_torch.gt.engine import TorchEngine
    from svtyper_tpu_torch.tools.scaling_curve import device_lists
    from svtyper_tpu_torch.utils import fixture

    n_vis = torch.cuda.device_count()
    shards = (1, 2) if n_vis == 1 else (1, n_vis)
    orig = (extract._chunk_preamble, extract._pack_variant_tables)
    K.zero()
    fixtures = [("wgs30 tiled to %d records" % N_RECORDS, wgs[0], wgs[1])]
    wait_child(sim, 14, "the %d-event fixture" % PREP_EVENTS)
    fixtures.append(("%d distinct events" % PREP_EVENTS,)
                    + common.default_fixture(PREP_EVENTS))
    for name, bam, vcf in fixtures:
        results, prof = profile_prep.run(
            bam, vcf, sizes=PREP_SIZES, shards=shards, device="cuda",
            emit=lambda obj: None)
        check((extract._chunk_preamble, extract._pack_variant_tables)
              == orig, "phase 14: a prep wrapper was left in place")
        path = os.path.join(WORK, "profile_prep_%s.txt" % name.split()[0])
        with open(path, "w") as fh:
            fh.write(prof)
        sample, bps = fixture.load_sample_and_breakpoints(bam, vcf)
        for r in results:
            n_chunks = -(-len(bps) // r["chunk_size"])
            check(r["chunks"] == n_chunks, "phase 14: %d chunks of %d for "
                  "%d records" % (r["chunks"], r["chunk_size"], len(bps)))
            (_, devices), = device_lists("cuda", [r["shards"]])
            engine = TorchEngine([sample], chunk_size=r["chunk_size"],
                                 devices=devices)
            for chunk in profile_prep.chunks_of(bps, r["chunk_size"]):
                engine._prepare(chunk)
            engine.close()
            check((engine.stats["reads"], engine.stats["pairs"])
                  == (r["reads"], r["pairs"]),
                  "phase 14: %s reads/pairs %d/%d, unwrapped %d/%d"
                  % (name, r["reads"], r["pairs"], engine.stats["reads"],
                     engine.stats["pairs"]))
            log(_prep_line(name, r))
        log("phase 14: %s: reads and pairs equal an unwrapped "
            "TorchEngine._prepare's, wrappers removed; cProfile of 3 "
            "passes in %s, top:\n%s"
            % (name, path, "\n".join(prof.splitlines()[:16])))
    check(K.now() == {"gl": 0, "classify": 0}, "phase 14: kernel launches "
          "%s during host prep alone" % K.now())
    log("phase 14: no classify or GL kernel launch (host prep alone)")


def console_scripts(setup_py):
    """setup.py's ``console_scripts`` entry points → {name: target}."""
    with open(setup_py) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "console_scripts":
                    return dict(e.split("=", 1) for e in ast.literal_eval(v))
    return {}


def resolve(target):
    module, attr = target.split(":")
    return getattr(importlib.import_module(module), attr)


def phase_entry_points(K, reference_parity, make_example_data, golden_out):
    """Phase 15: the remaining entry points on the card (launches: the
    mock parity's float32 lanes and the console script)."""
    # (a) the reference-parity harness against the mock checkout
    K.zero()
    res = reference_parity.run(workdir=os.path.join(WORK, "parity"),
                               device="cuda", mock=True,
                               emit=lambda obj: None)
    card = [l for l in res["lanes"] if l["flavour"] == "cuda"]
    check(res["ok"] and len(card) == 3,
          "phase 15: mock parity lanes %s" % res["lanes"])
    n_chunks = sum(l["chunks"] for l in card)
    K.check(15, n_chunks)
    log("phase 15: (a) reference_parity --mock: %d lanes pass (%s); the "
        "float32 lanes ran %d chunks, %d classify and GL launches each" % (
            len(res["lanes"]), ", ".join(
                "%s/%s" % (l["lane"], l["flavour"]) for l in res["lanes"]),
            n_chunks, n_chunks))

    # (b) the console scripts, resolved from setup.py under the jax refusal
    scripts = console_scripts(os.path.join(ROOT, "setup.py"))
    mains = {name: resolve(scripts[name])
             for name in ("svtyper-torch", "svtyper-torch-sso")}
    out = os.path.join(WORK, "example_console.vcf")
    data = os.path.join(ROOT, "data")
    K.zero()
    rc = mains["svtyper-torch"](
        ["-i", os.path.join(data, "example.vcf"),
         "-B", os.path.join(data, "example.sim.sorted.bam"), "-n", "60000",
         "-o", out])
    check(rc == 0, "phase 15: svtyper-torch exit code %s" % rc)
    K.check(15, 1)
    check(read_bytes(out) == read_bytes(golden_out),
          "phase 15: svtyper-torch's output differs from phase 4's")
    log("phase 15: (b) console scripts %s resolved with jax refused; "
        "svtyper-torch on the golden example byte-identical to phase 4, "
        "1 classify and 1 GL launch" % ", ".join(
            "%s=%s" % (k, scripts[k]) for k in sorted(mains)))

    # (c) the example data, regenerated
    t0 = time.time()
    bam, vcf = make_example_data.make(os.path.join(WORK, "example"))
    for name in (bam, bam + ".bai", vcf):
        check(read_bytes(name) == read_bytes(
            os.path.join(data, os.path.basename(name))),
            "phase 15: %s differs from data/'s" % os.path.basename(name))
    log("phase 15: (c) make_example_data wrote the BAM, BAI and VCF "
        "byte-identical to data/ in %.1f s" % (time.time() - t0))


def phase_bench(K, bench, sim, multi_card: bool, n_cards: int):
    """Phase 16: each cell of ``BENCHMARK.json`` that this mode runs,
    through its own command in a child process, at the phase's sizes and
    with the smoke's cache; the children's launches join ``K``."""
    wait_child(sim, 16, "the bench's fixtures")
    metrics, cells = bench_cells(multi_card)
    check(cells, "phase 16: BENCHMARK.json has no cell for this mode")
    with open(os.path.join(ROOT, "BENCH_r05.json")) as fh:
        keys = set(json.load(fh)["parsed"])
    env = dict(os.environ, PYTHONPATH=ROOT, **{
        "SVT_BENCH_VARIANTS": str(BENCH_VARIANTS),
        "SVT_BENCH_BND_EVENTS": str(BENCH_BND_EVENTS),
        "SVT_BENCH_MS_VARIANTS": str(BENCH_MS_VARIANTS),
        "SVT_BENCH_CLI_VARIANTS": str(BENCH_CLI_VARIANTS),
        "SVT_BENCH_WINDOW": "0"})
    for cell in cells:
        args = cell_args(bench, cell)
        argv = [sys.executable, "-m", "svtyper_tpu_torch.tools.bench",
                "--seed", str(args.seed), "--cache", BENCH_CACHE]
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=BENCH_TIMEOUT_S)
        with open(os.path.join(WORK, "bench_%s.err" % cell["name"]),
                  "w") as fh:
            fh.write(proc.stderr)
        check(proc.returncode == 0, "phase 16: %s exited %d\n%s" % (
            cell["name"], proc.returncode, proc.stderr[-3000:]))
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        name = cell["name"]
        missing = sorted(keys - set(res)) + sorted(
            m for m in metrics if res.get(m) is None)
        check(not missing, "phase 16: %s: bench.py's keys or the metrics "
              "of BENCHMARK.json missing or null in the bench's line: %s"
              % (name, missing))
        check(res["accuracy_degraded"] is None, "phase 16: %s: accuracy "
              "gate: %s" % (name, res["accuracy_degraded"]))
        check(res["cold_checked"] and res["cold_inflate_bytes"] > 0,
              "phase 16: %s: the cold pass was not shown cold (%d bytes "
              "inflated, %d cache hits)" % (name, res["cold_inflate_bytes"],
                                            res["cold_cache_hits"]))
        oc = res["oracle_check"]
        check(oc["mismatches"] == 0 and min(
            oc[r] for r in ("warm", "bnd", "multisample", "cli")) > 0,
            "phase 16: %s: oracle check %s" % (name, oc))
        check(res["cold_identical"] == res["n_cold"] > 0,
              "phase 16: %s: the cold pass's rows held against the warm "
              "pass's: %s of %d" % (name, res["cold_identical"],
                                    res["n_cold"]))
        # every visible card: the cell's chips where the host has them
        check(res["shards"] == n_cards, "phase 16: %s ran on %d shards, "
              "expected %d" % (name, res["shards"], n_cards))
        check(res["one_card_identical"] is (True if multi_card else None),
              "phase 16: %s: one-card comparison %s"
              % (name, res["one_card_identical"]))
        ops = [o["name"] for o in res["breakdown"]["top_ops"]]
        check({"classify_compact", "genotype_rows"} <= set(ops),
              "phase 16: %s: the traced pass's top device operations %s "
              "lack a kernel" % (name, ops))
        for p in res["engine_passes"]:
            check(p["classify_launches"] == p["gl_launches"]
                  == p["chunks"] * p["shards"] * p["samples"] > 0,
                  "phase 16: %s: %s" % (name, p))
        check(res["cli_classify_launches"] == res["cli_gl_launches"]
              == res["cli_chunks"] * res["shards"] > 0,
              "phase 16: %s: the CLI row launched %d classify and %d GL "
              "kernels for %d chunks" % (
                  name, res["cli_classify_launches"], res["cli_gl_launches"],
                  res["cli_chunks"]))
        launches = sum(p["gl_launches"] for p in res["engine_passes"])
        K.add(launches + res["cli_gl_launches"],
              launches + res["cli_classify_launches"])
        b = res["breakdown"]
        log("phase 16: %s (%s) on %d shard(s): warm %.1f, cold %.1f (%d "
            "distinct, %d bytes inflated, %d cache hits), oracle %.2f, BND "
            "%.1f, two-sample %.1f, CLI %.1f (steady %.1f, first chunk "
            "%.3f s) variants/s; concordance %.4f / %.4f / %.4f; oracle "
            "check %s; one card identical %s; "
            "traced pass %.1f variants/s, device busy %.6f %s, idle by host "
            "%s, top %s; %d + %d launches of each kernel; fixtures %.1f s "
            "(rebuilt %s), run %.1f s" % (
                name, " ".join(shlex.quote(a) for a in argv[1:]),
                res["shards"], res["value"], res["cold_vps"], res["n_cold"],
                res["cold_inflate_bytes"], res["cold_cache_hits"],
                res["oracle_vps"], res["bnd_vps"], res["multisample_vps"],
                res["cli_vps"], res["cli_steady_vps"],
                res["cli_first_chunk_s"], res["gt_concordance"],
                res["bnd_concordance"], res["multisample_concordance"],
                {r: oc[r] for r in ("warm", "bnd", "multisample", "cli")},
                res["one_card_identical"],
                b["traced_vps"], b["busy_share"], b["busy_share_by_card"],
                b["idle_by_host_s"], [(o["name"], o["ms"]) for o in
                                      b["top_ops"]],
                launches, res["cli_gl_launches"], res["fixture_build_s"],
                res["fixtures_rebuilt"], res["run_s"]))
    if not multi_card:
        # the control: a lower-precision classify step must fail the run
        proc = subprocess.run(argv + ["--control", "bf16"], cwd=ROOT, env=env,
                              capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT_S)
        with open(os.path.join(WORK, "bench_control.err"), "w") as fh:
            fh.write(proc.stderr)
        failed = [line.split(" field(s)")[0] for line in
                  proc.stderr.splitlines() if line.startswith("oracle check")]
        check(proc.returncode == 1 and proc.stdout.strip() == ""
              and "oracle check: warm" in proc.stderr
              and "oracle check: the CLI's output VCF" in proc.stderr,
              "phase 16: the bf16 control exited %d, its oracle checks "
              "failed %s\n%s" % (proc.returncode, failed,
                                  proc.stderr[-3000:]))
        log("phase 16: the bf16 control (%s --control bf16) exited 1: %s"
            % (cells[0]["name"], "; ".join(failed)))


def busy_share(trace_path, wall_s):
    """→ (the share of ``wall_s`` in which the card ran a kernel or a
    copy: the union of the trace's device intervals, their count by
    category)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    cats = {}
    for e in device:
        cats[e["cat"]] = cats.get(e["cat"], 0) + 1
    return busy / 1e6 / wall_s, cats


def phase_classify(torch, K, common, gl_bench, classify_bench, wgs):
    """Phase 17: the classify kernel against its plain version on the
    card → (max abs error, {N: its times and bound}) for the kernel line.
    Its launches are comparisons, not the main path, so ``K`` does not
    count them."""
    import numpy as np

    from svtyper_tpu_torch.evidence.device import classify_compact
    from svtyper_tpu_torch.evidence.extract import VARS_BOOL
    from svtyper_tpu_torch.gt.engine import TorchEngine, pack_wire
    from svtyper_tpu_torch.ops.classify_kernel import (
        classify_compact_cuda, unwire,
    )
    from svtyper_tpu_torch.utils import fixture, parity

    dev = torch.device("cuda", 0)
    f32 = torch.float32
    gl_kernel = K.gl_kernel
    is_dup, force_null = (VARS_BOOL.index(k) for k in ("is_dup", "force_null"))

    def held(name, w, geom, dens, n_var):
        """The kernel's counts bit-identical to the plain version's →
        their max abs difference (0)."""
        got = classify_compact_cuda(w, geom, dens, n_var)
        want = classify_compact(*unwire(w, geom), dens, n_var, dtype=f32)
        check(same_bits(got, want), "phase 17: %s: the kernel's counts "
              "differ from the plain version's in %d variants"
              % (name, int((got != want).any(dim=1).sum())))
        return float((got - want).abs().max())

    # the branch and segment-edge chunks of the CPU tests
    chunks = [("adversarial", *parity.adversarial_compact()),
              ("adversarial, 1,024 variants", *parity.adversarial_compact(
                  seed=4, n_var=1024, n_reads=40_000, n_pairs=20_000,
                  width=1024))]
    chunks += [("edge: " + name, c, d, n) for name, c, d, n
               in parity.edge_compacts()]
    max_err = 0.0
    for name, compact, dens, n_var in chunks:
        wire, geom = pack_wire(compact)
        max_err = max(max_err, held(name, torch.from_numpy(wire).to(dev),
                                    geom, torch.from_numpy(dens).to(dev),
                                    n_var))
    log("phase 17: %s: the kernel's counts bit-identical to unwire -> "
        "classify_compact's" % ", ".join(c[0] for c in chunks))

    def plain_step(eng, w, geom, n_var):
        parts = unwire(w, geom)
        counts = classify_compact(*parts, eng._dens_for(0, dev), n_var,
                                  dtype=f32)
        return gl_kernel.genotype_rows(counts, parts[6][is_dup],
                                       parts[6][force_null])

    bam, tiled, lib = wgs[:3]
    cold_bam, cold_vcf = common.default_fixture(PREP_EVENTS)
    warm = None
    for name, b, v, li in (("wgs30 tiled, warm", bam, tiled, lib),
                           ("%d distinct events, cold" % PREP_EVENTS,
                            cold_bam, cold_vcf, None)):
        sample, bps = fixture.load_sample_and_breakpoints(b, v, lib_info=li)
        if warm is None:
            warm = sample, bps
        eng = TorchEngine([sample], device=dev)
        dens = eng._dens_for(0, dev)
        n_chunks = reads = pairs = 0
        for compact, w, geom, n_var in classify_bench.wires(eng, bps, dev):
            max_err = max(max_err, held("%s, chunk %d" % (name, n_chunks),
                                        w, geom, dens, n_var))
            check(same_bits(eng._step(w, geom, 0, n_var),
                            plain_step(eng, w, geom, n_var)),
                  "phase 17: %s, chunk %d: the engine's step rows differ "
                  "from the plain path's" % (name, n_chunks))
            n_chunks += 1
            reads += int((compact["cr_u16"] < n_var).sum())
            pairs += int((compact["cp_u16"] < n_var).sum())
        eng.close()
        check(n_chunks == -(-len(bps) // CHUNK), "phase 17: %d chunks"
              % n_chunks)
        log("phase 17: %s: %d chunks of %d (%d reads, %d pairs): the "
            "kernel's counts bit-identical to unwire -> classify_compact's "
            "and the engine's step rows to the plain path's"
            % (name, n_chunks, CHUNK, reads, pairs))

    sample, bps = warm
    times = {}
    for n in CLASSIFY_SIZES:
        eng = TorchEngine([sample], device=dev, chunk_size=n)
        dens = eng._dens_for(0, dev)
        compact, w, geom, n_var = next(classify_bench.wires(eng, bps, dev))
        torch.cuda.synchronize()
        fns = {
            "kernel": lambda: classify_compact_cuda(w, geom, dens, n_var),
            "plain": lambda: classify_compact(*unwire(w, geom), dens, n_var,
                                              dtype=f32),
            "step": lambda: eng._step(w, geom, 0, n_var),
            "plain step": lambda: plain_step(eng, w, geom, n_var),
        }
        # a warp walks each segment: the longest sets the tail
        res = {"n": n, "wire_bytes": int(w.numel()),
               **classify_bench.chunk_stats(compact, n_var),
               "device_ms": gl_bench.graph_ms(fns["kernel"]),
               "call_ms": gl_bench.time_ms(fns["kernel"]),
               "plain_ms": gl_bench.time_ms(fns["plain"])}
        res["bound_ms"], res["bound_by"], res["bound_bytes"] = \
            classify_bench.bound(compact, n_var, dens)
        res["bound_share"] = res["bound_ms"] / res["device_ms"]
        turns = {}
        for name in ("kernel", "plain", "plain", "kernel",
                     "step", "plain step", "plain step", "step"):
            turns.setdefault(name, []).append(
                device_ms(torch, fns[name], FULL_REPS))
        res["events_ms"] = {k: [t[0] for t in v] for k, v in turns.items()}
        res["enqueue_ms"] = {k: [t[1] for t in v] for k, v in turns.items()}
        eng.close()
        times[n] = res
        log("phase 17: %s" % json.dumps(res))
        log("phase 17: N=%d (%d reads, %d pairs, %d wire bytes, longest "
            "segments %d reads and %d pairs): kernel "
            "device %.6f ms (CUDA graph), call %.6f ms, plain %.6f ms; bound "
            "%.6f ms (%s, %d B), %.4f of it; per shard per chunk, CUDA events "
            "(host enqueue) in turns: kernel %s, plain %s; engine step %s, "
            "plain step %s" % (
                n, res["reads"], res["pairs"], res["wire_bytes"],
                *res["longest_segment"], res["device_ms"], res["call_ms"],
                res["plain_ms"],
                res["bound_ms"], res["bound_by"], res["bound_bytes"],
                res["bound_share"],
                *(" / ".join("%.6f (%.6f)" % (e, h) for e, h in zip(
                    res["events_ms"][k], res["enqueue_ms"][k]))
                  for k in ("kernel", "plain", "step", "plain step"))))

    # the engine's device profile over phase 5's records: per chunk H2D,
    # step and D2H by CUDA events, then the busy share of a stream pass
    eng = TorchEngine([sample], device=dev)
    per = {"h2d": [], "step": [], "d2h": []}
    for start in range(0, len(bps), CHUNK):
        (shards,) = eng._prepare(bps[start:start + CHUNK])
        (payload, n_var), = shards
        wire, geom = pack_wire(payload[1])
        pinned = torch.from_numpy(wire).pin_memory()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        w = pinned.to(dev, non_blocking=True)
        ev[1].record()
        rows = eng._step(w, geom, 0, n_var)
        ev[2].record()
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        ev[3].record()
        ev[3].synchronize()
        for key, i in (("h2d", 0), ("step", 1), ("d2h", 2)):
            per[key].append(ev[i].elapsed_time(ev[i + 1]))
    med = {k: float(np.median(v)) for k, v in per.items()}
    eng.genotype_all(bps[:CHUNK])  # warm
    trace = os.path.join(WORK, "phase17_stream.trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        eng.genotype_all(bps)
        wall = time.time() - t0
    prof.export_chrome_trace(trace)
    share, cats = busy_share(trace, wall)
    st = eng.stats
    eng.close()
    log("phase 17: engine device profile over %d records (%d chunks of %d): "
        "per chunk median ms (CUDA events) H2D %.6f, step %.6f, D2H %.6f; "
        "profiled genotype_all %.6f s, device busy %.6f of it (device "
        "intervals %s); prep %.6f s, send %.6f s, sync %.6f s"
        % (len(bps), len(per["step"]), CHUNK, med["h2d"], med["step"],
           med["d2h"], wall, share, json.dumps(cats), st["prep_s"],
           st["send_s"], st["sync_s"]))
    return max_err, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-card", action="store_true",
                    help="phases 1, 2, 5-7, 10, 13, 14, 16 and 18 on a "
                         "host with two or more cards (phase 16 runs the "
                         "cells of more than one chip)")
    multi_card = ap.parse_args(argv).multi_card
    sys.meta_path.insert(0, _RefuseJax())
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if multi_card and torch.cuda.device_count() < 2:
        print("FAIL: --multi-card needs two or more cards, found %d"
              % torch.cuda.device_count(), file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from svtyper_tpu_torch.bamio import native
    from svtyper_tpu_torch.cli import classic
    from svtyper_tpu_torch.ops import _build, classify_kernel, gl_kernel
    from svtyper_tpu_torch.tools import (
        bench, classify_bench, common, dump_chunk_args, gl_bench,
        make_example_data, profile_chunks, profile_prep, reference_parity,
        scaling_curve, soak,
    )
    from svtyper_tpu_torch.utils import fixture, parity

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    K = Launches(gl_kernel, classify_kernel)
    smi = common.nvidia_smi_line()
    log("phase 1: %s | torch %s, CUDA %s, %d device(s)"
        % (smi, torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    phase_build(_build, native)
    sims = [start_prep_fixture()]
    n_cards = torch.cuda.device_count()
    seeds = {cell_args(bench, c).seed for c in bench_cells(multi_card)[1]}
    check(len(seeds) == 1, "phase 16: the cells' seeds %s" % seeds)
    try:
        if not multi_card:
            max_err, times = phase_kernel(torch, gl_kernel, parity, gl_bench)
            golden_out = phase_golden(classic, parity)
        wgs = phase_slice(torch, classic, K, fixture)
        phase_fresh_cli(torch, K, wgs)
        # after the timed CLI runs of phases 5 and 18, so it takes no
        # core from them
        sims.append(start_bench_fixtures(bench, seeds.pop()))
        phase_multidevice(torch, classic, K, wgs)
        phase_multihost(torch, K, wgs)
        if not multi_card:
            phase_profile(classic, K, golden_out)
            phase_chunk_sweep(K, profile_chunks, wgs)
        phase_scaling(torch, K, scaling_curve, wgs)
        if not multi_card:
            phase_soak(K, soak, WGS_VCF, wgs[0])
            phase_dump(K, dump_chunk_args, wgs)
        phase_full_column(torch, K, wgs)
        phase_prep(torch, K, common, profile_prep, wgs, sims[0])
        if not multi_card:
            phase_entry_points(K, reference_parity, make_example_data,
                               golden_out)
        phase_bench(K, bench, sims[1], multi_card, n_cards)
        if not multi_card:
            cls_err, cls_times = phase_classify(torch, K, common, gl_bench,
                                                classify_bench, wgs)
    finally:
        stop_children(sims)
    check("jax" not in sys.modules, "jax was imported")
    check("svtyper_tpu" not in sys.modules, "svtyper_tpu was imported")
    if multi_card:
        log("multi-card: phases 5-7, 10, 13, 14, 16 and 18 ok on %d "
            "cards, %d classify and %d GL launches"
            % (torch.cuda.device_count(), K.total["classify"],
               K.total["gl"]))
        log(smi)
        log(json.dumps(result_line(torch)))
        return 0

    t = times[CHUNK]
    c = cls_times[CHUNK]
    kernels = [{
        "name": "gl_rows",
        "route": "cuda",
        "source": "svtyper_tpu_torch/csrc/gl_kernel.cu",
        "replaces": "svtyper_tpu/ops/pallas_gl.py:164",
        "launches": K.total["gl"],
        "max_abs_err": max_err,
        "ms": t["kernel_call_ms"],
        "device_ms": t["kernel_device_ms"],
        "plain_ms": t["twin_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_share": t["bound_share"],
        # no single PyTorch call computes the GL stage
        "library_ms": None,
    }, {
        "name": "classify_compact",
        "route": "cuda",
        "source": "svtyper_tpu_torch/csrc/classify_kernel.cu",
        # no Pallas original: what XLA compiles from this function inside
        # jit(step_wire), svtyper_tpu/gt/engine.py:298
        "replaces": "svtyper_tpu/evidence/device.py:27",
        "launches": K.total["classify"],
        "max_abs_err": cls_err,
        "ms": c["call_ms"],
        "device_ms": c["device_ms"],
        "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"],
        "bound_share": c["bound_share"],
        # no single PyTorch call computes classify_compact
        "library_ms": None,
    }]
    check(all(math.isfinite(v) for v in (
        max_err, t["kernel_call_ms"], t["kernel_device_ms"], t["twin_ms"],
        t["bound_share"], cls_err, c["call_ms"], c["device_ms"],
        c["plain_ms"], c["bound_share"])), "non-finite kernel numbers")
    check(K.total["classify"] > 0 and K.total["gl"] > 0,
          "a kernel of the main path never ran: %s" % K.total)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps(result_line(torch)))
    return 0


def result_line(torch):
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


if __name__ == "__main__":
    sys.exit(main())
