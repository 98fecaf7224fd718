#!/usr/bin/env python3
"""Smoke test of svtyper_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py                # one card: phases 1-13
    python3 chip_smoke.py --multi-card   # two or more cards: 1, 2, 5-7, 10, 13

Drives the port's shipped command (``svtyper_tpu_torch.cli.classic``),
its tools (``svtyper_tpu_torch.tools``) and its full-column device step
(``svtyper_tpu_torch.parallel``) on the card and checks them end to end,
in thirteen phases; any failure exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build, both at once: ``csrc/gl_kernel.cu`` with nvcc and the port's
   own native BAM decoder (``bamio/_native/bamcore.cpp``, make and g++),
   each into ``build/svtyper_tpu_torch/``, then loads both (no
   pure-Python fallback);
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
   card past ``cuda:0``);
7. multi-host: two CLI processes joined over gloo (``SVT_DIST_*``) on
   the card(s): rank 0's VCF byte-identical to phase 5's, rank 1's
   empty;
8. profile: the CLI with ``--profile`` on the golden example writes a
   Chrome trace that names the GL kernel;
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
    int fields equal to the CPU twin's; (b) the first 1,024 records of
    phase 5's fixture through ``prepare_chunk``: both classifiers'
    counts, and the GL kernel's rows from them, bit-identical, the int
    fields equal to ``TorchEngine``'s, and each classifier's device ms
    per chunk; (c) ``make_sharded_step`` over every card (two shards on
    ``cuda:0`` when there is one): every field equal to each shard's
    local result, one GL launch per shard.

The port runs with jax and the JAX package (``svtyper_tpu``) refused,
and neither may be loaded at the end.

Each phase that drives the CLI, a tool or the full-column step zeroes
``gl_kernel.LAUNCHES`` just before and reads it just after (phases 7 and
11 read a child process's count from the engine's ``gl_launches`` in its
``SVT_CLI_STATS``), and fails if the kernel did not run as often as the
phase's chunks (phase 13: its steps and shards) ask; the kernel line
reports their sum.

``--multi-card`` is the check for a host with several cards: it runs
only the phases that span cards (6, 7, 10 and 13) and the single-card
phase 5 they are compared with, and prints no kernel line (phase 3
measures the kernel).

Prints diagnostics, then the card's name and power limit, one JSON line
describing each kernel, and last the result line
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
RANK_TIMEOUT_S = 600
SWEEP_SIZES = (512, 1024, 2048, 4096)
SOAK_N = 200_000
SOAK_EVERY = 5  # library soak: chunks between memory samples
SOAK_INTERVAL = 0.5  # CLI soak: seconds between memory samples
FULL_REPS = 20  # phase 13: classifier calls per CUDA-event window


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


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build(_build, native):
    """Phase 2: the CUDA kernel and the native decoder, built side by
    side from the checkout's sources and loaded."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        kernel = pool.submit(timed, lambda: _build.load("gl_kernel"))
        decoder = pool.submit(timed, native.require_lib)
        k_s, d_s = kernel.result(), decoder.result()
    log("phase 2: built and loaded %s in %.2f s (nvcc %s) and %s in %.2f s "
        "(make), side by side"
        % (_build.build("gl_kernel"), k_s, " ".join(_build.NVCC_FLAGS),
           native._SO, d_s))


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


def phase_slice(torch, classic, gl_kernel, fixture):
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
        gl_kernel.LAUNCHES = 0
        wall = run_cli(classic, tiled, bam, out, extra=("-l", lib),
                       stats=stats_path, device="cuda")
        launches = gl_kernel.LAUNCHES
        with open(stats_path) as fh:
            st = json.load(fh)
        check(launches == n_chunks, "run %d: GL kernel launched %d times "
              "for %d chunks" % (r, launches, n_chunks))
        check(st["chunks"] == n_chunks, "run %d: %s chunks" % (r, st["chunks"]))
        conc, n_eval = concordance(out, truth)
        check(n_eval == N_RECORDS, "run %d: %d records out" % (r, n_eval))
        check(conc >= CONC_FLOOR, "run %d: GT concordance %.4f < %.2f"
              % (r, conc, CONC_FLOOR))
        vps = N_RECORDS / st["genotype_wall_s"]
        log("phase 5: run %d: %d records, %d chunks, %d GL kernel launches, "
            "GT concordance %.4f; %.1f variants/s over genotyping "
            "(%.2f s; whole command %.2f s incl. library %s); prep %.3f s, "
            "send %.3f s, sync %.3f s; %d reads, %d pairs"
            % (r, N_RECORDS, st["chunks"], launches, conc, vps,
               st["genotype_wall_s"], wall, "scan" if r == 1 else "load",
               st["prep_s"], st["send_s"], st["sync_s"], st["reads"],
               st["pairs"]))
        runs.append((out, launches))
    check(read_bytes(runs[0][0]) == read_bytes(runs[1][0]),
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
        "(float32 twin): int fields identical; max abs float diff %.3g"
        % (N_ENGINE_CMP, float(abs(a[:, 14:] - b[:, 14:]).max())))
    return (bam, tiled, lib, runs[0][0]), runs[0][1] + runs[1][1]


def stats_line(st):
    return ("genotyping %.6f s, prep %.6f s, send %.6f s, sync %.6f s"
            % (st["genotype_wall_s"], st["prep_s"], st["send_s"],
               st["sync_s"]))


def phase_multidevice(torch, classic, gl_kernel, wgs):
    """Phase 6 → GL launches of the two CLI runs."""
    from svtyper_tpu_torch.parallel.dryrun import dryrun_multichip

    bam, tiled, lib, want = wgs
    n_vis = torch.cuda.device_count()
    devices = (["cuda:%d" % i for i in range(n_vis)] if n_vis > 1
               else ["cuda:0", "cuda:0"])
    dryrun_multichip(len(devices), "cuda:0")
    total = 0
    for r in (1, 2):
        out = os.path.join(WORK, "wgs_multidevice%d.vcf" % r)
        stats_path = os.path.join(WORK, "stats_multidevice%d.json" % r)
        gl_kernel.LAUNCHES = 0
        wall = run_cli(classic, tiled, bam, out, extra=("-l", lib),
                       stats=stats_path, devices=devices)
        launches = gl_kernel.LAUNCHES
        with open(stats_path) as fh:
            st = json.load(fh)
        check(read_bytes(out) == read_bytes(want),
              "multi-device run %d: output differs from phase 5's" % r)
        check(launches == st["gl_launches"] == st["chunks"] * len(devices),
              "multi-device run %d: %d GL launches (engine: %d) for %d "
              "chunks x %d shards" % (r, launches, st["gl_launches"],
                                      st["chunks"], len(devices)))
        log("phase 6: run %d: %d shards on %s: byte-identical to phase 5; "
            "%d chunks, %d GL launches; %s (whole command %.2f s)"
            % (r, len(devices), ",".join(devices), st["chunks"], launches,
               stats_line(st), wall))
        total += launches
    return total


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


def phase_multihost(torch, wgs):
    """Phase 7: two gloo ranks → their summed GL launches."""
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
    total = 0
    for rank in (0, 1):
        with open(stats[rank]) as fh:
            st = json.load(fh)
        check(st["gl_launches"] == st["chunks"] * n_dev > 0,
              "multi-host rank %d: %d GL launches for %d chunks"
              % (rank, st["gl_launches"], st["chunks"]))
        total += st["gl_launches"]
        log("phase 7: rank %d: %d chunks, %d GL launches; %s, gather %.6f s "
            "(whole command %.2f s)"
            % (rank, st["chunks"], st["gl_launches"], stats_line(st),
               st["gather_s"], st["total_wall_s"]))
    log("phase 7: 2 ranks over gloo: rank 0 byte-identical to phase 5, "
        "rank 1 empty; both processes %.2f s" % wall)
    return total


def phase_profile(classic, gl_kernel, golden_out):
    """Phase 8 → GL launches of the profiled run."""
    data = os.path.join(ROOT, "data")
    prof = os.path.join(WORK, "profile")
    out = os.path.join(WORK, "example_profiled.vcf")
    gl_kernel.LAUNCHES = 0
    wall = run_cli(classic, os.path.join(data, "example.vcf"),
                   os.path.join(data, "example.sim.sorted.bam"), out,
                   extra=("-n", "60000", "--profile", prof))
    launches = gl_kernel.LAUNCHES
    check(launches > 0, "profiled run launched no GL kernel")
    check(read_bytes(out) == read_bytes(golden_out),
          "profiled output differs from phase 4's")
    traces = os.listdir(prof)
    check(len(traces) == 1, "profile dir holds %s" % traces)
    with open(os.path.join(prof, traces[0])) as fh:
        events = json.load(fh)["traceEvents"]
    gl = [e for e in events if GL_SYMBOL in e.get("name", "")]
    check(len(gl) > 0, "the trace does not name %s" % GL_SYMBOL)
    log("phase 8: --profile wrote %s (%d events); %d %s events for %d "
        "launches, %.1f us in all; whole command %.2f s"
        % (traces[0], len(events), len(gl), GL_SYMBOL, launches,
           sum(e.get("dur", 0) for e in gl), wall))
    return launches


def phase_logger(phase: int):
    return lambda obj: log("phase %d: %s" % (phase, json.dumps(obj)))


def launched(gl_kernel, phase: int, want: int) -> int:
    """The GL launches since the phase zeroed the count; fails unless
    they are the ``want`` its chunks ask for."""
    got = gl_kernel.LAUNCHES
    check(got == want > 0, "phase %d: %d GL kernel launches, expected %d"
          % (phase, got, want))
    return got


def phase_chunk_sweep(gl_kernel, profile_chunks, wgs):
    """Phase 9 → its GL launches: one for the first call of each chunk
    size, then one per chunk of every rep."""
    bam, tiled = wgs[:2]
    gl_kernel.LAUNCHES = 0
    results, _ = profile_chunks.run(bam, tiled, sizes=SWEEP_SIZES,
                                    device="cuda", emit=phase_logger(9))
    want = sum(1 + sum(rep["chunks"] for rep in r["reps"]) for r in results)
    launches = launched(gl_kernel, 9, want)
    best = max(results, key=lambda r: r["median_variants_per_s"])
    base = next(r for r in results if r["chunk_size"] == CHUNK)
    log("phase 9: int fields identical across chunk sizes %s; fastest "
        "chunk %d at %.1f variants/s (median of %d), %.3fx chunk %d's; %d "
        "GL launches" % (
            list(SWEEP_SIZES), best["chunk_size"],
            best["median_variants_per_s"], len(best["reps"]),
            best["median_variants_per_s"] / base["median_variants_per_s"],
            CHUNK, launches))
    return launches


def phase_scaling(torch, gl_kernel, scaling_curve, wgs):
    """Phase 10 → its GL launches: a warm-up and a timed run per device
    count, one launch per shard of every chunk."""
    bam, tiled = wgs[:2]
    counts = (1, 2) if torch.cuda.device_count() == 1 else (1, 2, 4)
    gl_kernel.LAUNCHES = 0
    rows = scaling_curve.run(bam, tiled, device="cuda", counts=counts,
                             emit=phase_logger(10))
    want = sum(2 * r["chunks"] * r["devices"] for r in rows)
    launches = launched(gl_kernel, 10, want)
    log("phase 10: %s devices on %s card(s): every output identical to one "
        "device's; %d GL launches"
        % ([r["devices"] for r in rows], [r["cards"] for r in rows],
           launches))
    return launches


def phase_soak(gl_kernel, soak, wgs_vcf, bam):
    """Phase 11 → the GL launches of the library and the CLI soak."""
    gl_kernel.LAUNCHES = 0
    lib = soak.soak_library(bam, wgs_vcf, n=SOAK_N, device="cuda",
                            every=SOAK_EVERY, emit=phase_logger(11))
    launches = launched(gl_kernel, 11, 1 + lib["chunks"])
    cli = soak.soak_cli(bam, wgs_vcf, n=SOAK_N, interval=SOAK_INTERVAL,
                        emit=phase_logger(11))
    check(cli["gl_launches"] == cli["chunks"] > 0,
          "phase 11: the CLI soak launched %d GL kernels for %d chunks"
          % (cli["gl_launches"], cli["chunks"]))
    log("phase 11: library soak %d variants, RSS drift %.4f, CUDA reserved "
        "drift %.4f; CLI soak %d records, RSS drift %.4f, CUDA reserved "
        "drift %.4f (limit 0.10 each); %d + %d GL launches"
        % (lib["soak_variants"], lib["rss_drift"], lib["cuda_drift"],
           cli["cli_soak_variants"], cli["rss_drift"], cli["cuda_drift"],
           launches, cli["gl_launches"]))
    return launches + cli["gl_launches"]


def phase_dump(gl_kernel, dump_chunk_args, wgs):
    """Phase 12 → its GL launch (one chunk)."""
    bam, tiled = wgs[:2]
    out = os.path.join(WORK, "chunkbin")
    gl_kernel.LAUNCHES = 0
    written = dump_chunk_args.dump(bam, tiled, out, device="cuda",
                                   emit=phase_logger(12))
    launches = launched(gl_kernel, 12, 1)
    check(all(os.path.getsize(p) > 0 for p in written),
          "phase 12: an empty dump file")
    log("phase 12: %d files in %s; %d GL launch"
        % (len(written), out, launches))
    return launches


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
    """``classify_compact`` on ``chunk``'s compact wire, sent and unpacked
    as the engine does (``pack_wire`` → one uint8 buffer → ``unwire``)."""
    from svtyper_tpu_torch.evidence.device import classify_compact
    from svtyper_tpu_torch.evidence.extract import compact_chunk
    from svtyper_tpu_torch.gt.engine import pack_wire, unwire

    wire, geom = pack_wire(compact_chunk(chunk, min_aligned=20))
    parts = unwire(torch.from_numpy(wire).to(dev), geom)
    return lambda: classify_compact(*parts, dens, chunk.n_var,
                                    dtype=torch.float32)


def phase_full_column(torch, gl_kernel, wgs, dev="cuda:0"):
    """Phase 13: the full-column device step → its GL launches."""
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

    # (a) entry() on the card against the compact path and the CPU twin
    step, args = entry(device=dev)
    gl_kernel.LAUNCHES = 0
    got = {k: v.cpu().numpy() for k, v in step(*args).items()}
    total = launched(gl_kernel, 13, 1)
    chunk, _ = make_synthetic_chunk(n_var=64, frags_per_var=8)
    compact = _compact_counts(torch, chunk, args[3], dev)().cpu().numpy()
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
        "bit-identical to classify_compact's, int fields equal to the CPU "
        "twin's; 1 GL launch" % dev)

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

    comp = _compact_counts(torch, chunk, dens, dev)
    c_full, c_comp = full(), comp()
    check(torch.equal(c_full, c_comp), "phase 13: full-column counts differ "
          "from classify_compact's in %d variants"
          % int((c_full != c_comp).any(dim=1).sum()))
    flags = [variants[k].to(torch.uint8) for k in ("is_dup", "force_null")]
    gl_kernel.LAUNCHES = 0
    rows = gl_kernel.genotype_rows(c_full, *flags)
    total += launched(gl_kernel, 13, 1)
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
        "pairs): full-column counts and GL rows bit-identical to the "
        "compact path's, int fields equal to TorchEngine's; ms per chunk "
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
    gl_kernel.LAUNCHES = 0
    out = sharded(stacked["reads"], stacked["pairs"], stacked["variants"],
                  np.stack([dens_np] * n_dev))
    total += launched(gl_kernel, 13, n_dev)
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
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-card", action="store_true",
                    help="phases 1, 2, 5-7, 10 and 13 on a host with two "
                         "or more cards")
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
    from svtyper_tpu_torch.ops import _build, gl_kernel
    from svtyper_tpu_torch.tools import (
        common, dump_chunk_args, gl_bench, profile_chunks, scaling_curve,
        soak,
    )
    from svtyper_tpu_torch.utils import fixture, parity

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    smi = common.nvidia_smi_line()
    log("phase 1: %s | torch %s, CUDA %s, %d device(s)"
        % (smi, torch.__version__, torch.version.cuda,
           torch.cuda.device_count()))
    phase_build(_build, native)

    if not multi_card:
        max_err, times = phase_kernel(torch, gl_kernel, parity, gl_bench)
        golden_out = phase_golden(classic, parity)
    wgs, launches = phase_slice(torch, classic, gl_kernel, fixture)
    launches += phase_multidevice(torch, classic, gl_kernel, wgs)
    launches += phase_multihost(torch, wgs)
    if not multi_card:
        launches += phase_profile(classic, gl_kernel, golden_out)
        launches += phase_chunk_sweep(gl_kernel, profile_chunks, wgs)
    launches += phase_scaling(torch, gl_kernel, scaling_curve, wgs)
    if not multi_card:
        launches += phase_soak(gl_kernel, soak, WGS_VCF, wgs[0])
        launches += phase_dump(gl_kernel, dump_chunk_args, wgs)
    launches += phase_full_column(torch, gl_kernel, wgs)
    check("jax" not in sys.modules, "jax was imported")
    check("svtyper_tpu" not in sys.modules, "svtyper_tpu was imported")
    if multi_card:
        log("multi-card: phases 5-7, 10 and 13 ok on %d cards, %d GL "
            "launches"
            % (torch.cuda.device_count(), launches))
        log(smi)
        log(json.dumps(result_line(torch)))
        return 0

    t = times[CHUNK]
    kernels = [{
        "name": "gl_rows",
        "route": "cuda",
        "source": "svtyper_tpu_torch/csrc/gl_kernel.cu",
        "replaces": "svtyper_tpu/ops/pallas_gl.py:164",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["kernel_call_ms"],
        "device_ms": t["kernel_device_ms"],
        "plain_ms": t["twin_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "bound_share": t["bound_share"],
        # no single PyTorch call computes the GL stage
        "library_ms": None,
    }]
    check(all(math.isfinite(v) for v in (
        max_err, t["kernel_call_ms"], t["kernel_device_ms"], t["twin_ms"],
        t["bound_share"])), "non-finite kernel numbers")
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
