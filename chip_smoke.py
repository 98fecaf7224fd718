#!/usr/bin/env python3
"""Smoke test of svtyper_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Drives the port's shipped command (``svtyper_tpu_torch.cli.classic``)
on the card and checks it end to end, in five phases; any failure exits
non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, which BAM decoder loaded;
2. build: compiles ``csrc/gl_kernel.cu`` with nvcc and loads it;
3. kernel against its plain twin, on the card, on the random and
   adversarial GL grids at N = 1, 1000, 1024, 65536: the 14 integer
   fields bit-identical, GL/SQ/AB equal at output-format precision; the
   kernel's and the twin's times at N = 1024 and 65536;
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
   integer fields.

Prints diagnostics, then the card's name and power limit, one JSON line
describing each kernel, and last the result line
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
N_EVENTS = 1000
N_RECORDS = 20_500
CHUNK = 1024
CONC_FLOOR = 0.97
N_ENGINE_CMP = 2048
GRID_SIZES = (1, 1000, 1024, 65536)
TIMED_SIZES = (1024, 65536)


class _RefuseJax:
    """Meta-path hook: the port must run without jax."""

    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("chip_smoke: jax import refused (%s)" % name)
        return None


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit("FAIL: " + msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def phase_kernel(torch, gl_kernel, parity):
    """Phase 3 → (max abs error, {N: (kernel ms, twin ms)})."""
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
    for n in TIMED_SIZES:
        counts, is_dup, force_null = parity.random_counts(n)
        args = (
            torch.tensor(counts, dtype=torch.float32, device="cuda"),
            torch.tensor(is_dup, dtype=torch.uint8, device="cuda"),
            torch.tensor(force_null, dtype=torch.uint8, device="cuda"),
        )
        k_ms = time_ms(lambda: gl_kernel.genotype_rows_cuda(*args), 500)
        p_ms = time_ms(lambda: gl_kernel.genotype_rows_plain(*args), 100)
        times[n] = (k_ms, p_ms)
        log("phase 3: N=%d kernel %.6f ms, plain twin %.6f ms per call"
            % (n, k_ms, p_ms))
    return max_err, times


def run_cli(classic, vcf, bam, out, extra=(), stats=None):
    """The shipped command, in-process, on the card → wall seconds."""
    if stats:
        os.environ["SVT_CLI_STATS"] = stats
    t0 = time.time()
    try:
        rc = classic.main(["-i", vcf, "-B", bam, "-o", out, *extra])
    finally:
        os.environ.pop("SVT_CLI_STATS", None)
    check(rc == 0, "CLI exit code %s" % rc)
    return time.time() - t0


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
        os.path.join(WORK, "wgs"), N_EVENTS, depth=30.0
    )
    tiled = os.path.join(WORK, "wgs_tiled.vcf")
    fixture.tile_vcf(vcf, tiled, N_RECORDS)
    log("phase 5: simulated %d events at 30x in %.1f s; VCF tiled to %d "
        "records" % (N_EVENTS, time.time() - t0, N_RECORDS))
    n_chunks = -(-N_RECORDS // CHUNK)
    runs = []
    for r in (1, 2):
        out = os.path.join(WORK, "wgs_run%d.vcf" % r)
        stats_path = os.path.join(WORK, "stats%d.json" % r)
        gl_kernel.LAUNCHES = 0
        wall = run_cli(classic, tiled, bam, out, stats=stats_path)
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
            "(%.2f s; whole command %.2f s incl. library scan); prep %.3f s, "
            "send %.3f s, sync %.3f s; %d reads, %d pairs"
            % (r, N_RECORDS, st["chunks"], launches, conc, vps,
               st["genotype_wall_s"], wall, st["prep_s"], st["send_s"],
               st["sync_s"], st["reads"], st["pairs"]))
        runs.append((out, launches))
    with open(runs[0][0], "rb") as a, open(runs[1][0], "rb") as b:
        check(a.read() == b.read(), "two runs gave different output")
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
    return runs[0][1]


def main() -> int:
    sys.meta_path.insert(0, _RefuseJax())
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from svtyper_tpu_torch.cli import classic
    from svtyper_tpu_torch.ops import _build, gl_kernel
    from svtyper_tpu_torch.utils import fixture, parity

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    smi = nvidia_smi_line()
    log("phase 1: %s | torch %s, CUDA %s, %d device(s) | decoder: %s"
        % (smi, torch.__version__, torch.version.cuda,
           torch.cuda.device_count(), fixture.decoder_name()))

    t0 = time.time()
    _build.load("gl_kernel")
    log("phase 2: built and loaded %s in %.2f s (nvcc %s)"
        % (_build.build("gl_kernel"), time.time() - t0,
           " ".join(_build.NVCC_FLAGS)))

    max_err, times = phase_kernel(torch, gl_kernel, parity)
    phase_golden(classic, parity)
    launches = phase_slice(torch, classic, gl_kernel, fixture)
    check("jax" not in sys.modules, "jax was imported")

    k_ms, p_ms = times[CHUNK]
    kernels = [{
        "name": "gl_rows",
        "route": "cuda",
        "source": "svtyper_tpu_torch/csrc/gl_kernel.cu",
        "replaces": "svtyper_tpu/ops/pallas_gl.py:164",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]
    check(all(math.isfinite(v) for v in (max_err, k_ms, p_ms)),
          "non-finite kernel numbers")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
