"""The port's tools (``svtyper_tpu_torch/tools``) on the CPU against the
JAX package and its scripts, on one small simulated sample.

- soak: the fresh-object stream through ``TorchEngine(device="cpu")``
  (float64, chunk 256) against ``TpuEngine.genotype_stream``: integer
  fields exact, floats within 1e-12 (torch's and XLA's CPU pow/log10
  differ by an ulp); the drift rule of ``scripts/soak_1m.py``; the
  ``--cli`` mode through a child process;
- profile_chunks at 64/128/256 against ``TpuEngine`` at chunk 128;
- scaling_curve over ``[cpu] * k``, k = 1, 2, 4, 8;
- gl_bench's seed-7 input through the twin against the JAX f32
  ``genotype_batch`` and ``genotype_batch_pallas(interpret=True)``;
- dump_chunk_args against ``scripts/native_profile/dump_chunk_args.py``:
  identical ``.bin`` files;
- every tool imports with jax refused, and refuses to run without CUDA
  unless a caller names the CPU.
"""

import itertools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svtyper_tpu.bamio.bam import open_bam as jopen_bam
from svtyper_tpu.breakpoints import resolve_breakpoint as jresolve
from svtyper_tpu.gt import TpuEngine
from svtyper_tpu.ops import gl as jgl
from svtyper_tpu.ops.pallas_gl import genotype_batch_pallas
from svtyper_tpu.stats import Sample as JSample
from svtyper_tpu.vcfio.model import Variant as JVariant
from svtyper_tpu.vcfio.model import Vcf as JVcf
from svtyper_tpu.vcfio.reader import read_vcf_lines as jread_vcf_lines
from svtyper_tpu_torch.gt import engine as teng
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.ops import gl_kernel
from svtyper_tpu_torch.tools import (
    common,
    dump_chunk_args,
    gl_bench,
    profile_chunks,
    scaling_curve,
    soak,
)
from svtyper_tpu_torch.simulate import SimConfig, events_to_vcf, simulate_events
from svtyper_tpu_torch.utils import fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("gl_bench", "profile_chunks", "scaling_curve", "soak",
         "dump_chunk_args")
N_TILED = 600
TIMEOUT = 240


def _quiet(_obj):
    pass


@pytest.fixture(scope="module")
def sample_files(tmp_path_factory):
    """bench.py's generator at 24 events, 20x → (bam, vcf, vcf tiled to
    600 records)."""
    d = tmp_path_factory.mktemp("torch_tools")
    refs, events = fixture.bench_events(24)
    bam = str(d / "s.bam")
    simulate_events(bam, refs, events, SimConfig(depth=20), seed=5,
                    extra_background=500)
    vcf = str(d / "s.vcf")
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(events, refs))
    tiled = str(d / "tiled.vcf")
    fixture.tile_vcf(vcf, tiled, N_TILED)
    return bam, vcf, tiled


def _jax_sample_and_breakpoints(bam, vcf):
    """``fixture.load_sample_and_breakpoints`` through the JAX package's
    host half, for its engine."""
    sample = JSample.from_bam(jopen_bam(bam), num_samp=200_000)
    v = JVcf()
    with open(vcf) as fh:
        header, body = jread_vcf_lines(fh)
        v.add_header(header)
        bps = [jresolve(JVariant(line, v)) for line in body]
    return sample, bps


def _split(rows):
    return rows[:, : teng._NI], rows[:, teng._NI:]


def _assert_rows_equal(got, want):
    assert got.shape == want.shape
    gi, gf = _split(got)
    wi, wf = _split(want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gf, wf, rtol=1e-12, atol=1e-12)


def test_soak_stream_matches_tpu_engine(sample_files):
    bam, vcf, _ = sample_files
    sample, base = fixture.load_sample_and_breakpoints(bam, vcf)
    jsample, jbase = _jax_sample_and_breakpoints(bam, vcf)
    n = 3000

    def rows(engine, bps):
        return np.concatenate([
            a[0][:k] for k, a in engine.genotype_stream(bps, raw=True)
        ])

    got = rows(TorchEngine([sample], chunk_size=256, device="cpu"),
               soak.fresh_stream(base, n))
    want = rows(TpuEngine([jsample], chunk_size=256),
                itertools.islice(itertools.cycle(jbase), n))
    assert got.shape == (n, teng.ROW_WIDTH)
    _assert_rows_equal(got, want)

    out = soak.soak_library(bam, vcf, n=n, device="cpu", chunk=256,
                            every=2, emit=_quiet)
    assert out["soak_variants"] == n
    assert out["called"] == int((want[:, teng._I["null"]] == 0).sum())
    assert out["chunks"] == -(-n // 256) and out["gl_launches"] == 0
    assert out["samples"] == out["chunks"] // 2
    assert out["rss_drift"] <= common.DRIFT_LIMIT
    assert out["cuda_drift"] is None


@pytest.mark.parametrize("series,drifts,fails", [
    ([500.0] * 12, 0.0, False),  # flat
    ([500.0] * 6 + [600.0] * 6, 0.2, True),  # a 20% climb
    ([100.0, 400.0, 900.0], 0.0, False),  # too few samples to judge
])
def test_drift_rule(series, drifts, fails):
    head, tail, d = common.drift(series)
    assert d == pytest.approx(drifts)
    if len(series) < 4:
        assert head == tail == series[-1]
    out = soak._memory(series, [], cuda=False)
    assert out["rss_drift"] == d and out["cuda_drift"] is None
    if fails:
        with pytest.raises(common.ToolError, match="rss_drift"):
            soak._check_flat(out, "test")
    else:
        soak._check_flat(out, "test")
    assert common.drift([]) == (None, None, 0.0)


def test_soak_cli_child(sample_files):
    bam, vcf, _ = sample_files
    out = soak.soak_cli(bam, vcf, n=300, device="cpu", interval=0.2,
                        emit=_quiet)
    assert out["cli_soak_variants"] == 300
    assert out["chunks"] == 1 and out["gl_launches"] == 0
    assert out["rss_drift"] <= common.DRIFT_LIMIT
    assert out["cuda_drift"] is None


def test_profile_chunks_matches_tpu_engine(sample_files):
    bam, _, tiled = sample_files
    results, rows = profile_chunks.run(bam, tiled, sizes=(64, 128, 256),
                                       device="cpu", emit=_quiet)
    assert [r["chunk_size"] for r in results] == [64, 128, 256]
    for r in results:
        assert r["variants"] == N_TILED and r["int_fields_identical"]
        assert len(r["reps"]) == profile_chunks.REPS
        for rep in r["reps"]:
            assert rep["chunks"] == -(-N_TILED // r["chunk_size"])
            assert rep["gl_launches"] == 0
    jsample, jbps = _jax_sample_and_breakpoints(bam, tiled)
    want = profile_chunks.result_rows(
        TpuEngine([jsample], chunk_size=128).genotype_all(jbps)
    )
    _assert_rows_equal(rows, want)


def test_scaling_curve_identical_over_shards(sample_files):
    bam, _, tiled = sample_files
    rows = scaling_curve.run(bam, tiled, device="cpu", emit=_quiet)
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert all(r["identical_to_1dev"] and r["cards"] == 1 for r in rows)
    assert all(r["variants"] == N_TILED and r["chunks"] == 1 for r in rows)
    sample, bps = fixture.load_sample_and_breakpoints(bam, tiled)
    jsample, jbps = _jax_sample_and_breakpoints(bam, tiled)
    one = TorchEngine([sample], device="cpu").genotype_all(bps)
    assert scaling_curve._formatted(one) == scaling_curve._formatted(
        TpuEngine([jsample]).genotype_all(jbps)
    )


def _perturbed_rows(real):
    """``result_rows`` that flips one GT from its second call on."""
    calls = []

    def rows(results):
        out = real(results)
        calls.append(1)
        if len(calls) > 1:
            out[0, teng._I["gt_idx"]] += 1
        return out

    return rows


def _perturbed_formatted(real):
    """``_formatted`` that changes one GT from its second call on."""
    calls = []

    def fmt(results):
        out = real(results)
        calls.append(1)
        if len(calls) > 1:
            out[0] = ("./.", out[0][1])
        return out

    return fmt


@pytest.mark.parametrize("tool", ["profile_chunks", "scaling_curve"])
def test_identity_check_fails_the_run(tool, sample_files, monkeypatch):
    """Output that differs between chunk sizes or device counts fails
    the tool's command (exit 1), never a pass."""
    bam, vcf, _ = sample_files
    if tool == "profile_chunks":
        monkeypatch.setattr(profile_chunks, "result_rows",
                            _perturbed_rows(profile_chunks.result_rows))

        def go():
            profile_chunks.run(bam, vcf, sizes=(8, 16), device="cpu",
                               emit=_quiet)
    else:
        monkeypatch.setattr(scaling_curve, "_formatted",
                            _perturbed_formatted(scaling_curve._formatted))

        def go():
            scaling_curve.run(bam, vcf, device="cpu", counts=(1, 2),
                              emit=_quiet)
    assert common.run_main(go) == 1


def test_gl_bench_twin_matches_jax():
    n = 1024
    (res,) = gl_bench.run([n], device="cpu", emit=_quiet)
    assert res["n"] == n and res["int_fields"] == "exact"
    assert res["sq_max_abs_diff_twin"] < 1e-3
    # the CPU times nothing: every timed key says so, and the wrapper's
    # time is kernel_call_ms beside the graph-replayed kernel_device_ms
    assert "kernel_ms" not in res
    assert "kernel_call_ms" in gl_bench.DEVICE_KEYS
    for key in gl_bench.DEVICE_KEYS:
        assert res[key] == "not measured (CPU run)", key
    assert res["bytes"] == n * 118 and res["bound_by"] == "bytes"
    assert res["bound_ms"] == pytest.approx(n * 118 / 3.35e12 * 1e3)
    counts, is_dup, force_null = gl_bench.gl_inputs(n)
    twin = gl_kernel.genotype_rows_plain(
        torch.tensor(counts), torch.tensor(is_dup.astype(np.uint8)),
        torch.tensor(force_null.astype(np.uint8)),
    ).numpy()
    ints = twin[:, : teng._NI].astype(np.int64)
    ref = jgl.genotype_batch(
        jnp.asarray(counts), jnp.asarray(is_dup), jnp.asarray(force_null),
        jnp.asarray(jgl.log_choose_table(1 << 17, use_f64=False)),
    )
    for i, key in enumerate(teng.INT_FIELDS):
        np.testing.assert_array_equal(
            ints[:, i], np.asarray(ref[key]).astype(np.int64), err_msg=key
        )
    p_ints, _ = genotype_batch_pallas(
        jnp.asarray(counts.T), jnp.asarray(is_dup), jnp.asarray(force_null),
        interpret=True,
    )
    np.testing.assert_array_equal(ints.T, np.asarray(p_ints))


def test_dump_chunk_args_matches_jax_script(sample_files, tmp_path):
    bam, _, tiled = sample_files
    mine = tmp_path / "torch"
    written = dump_chunk_args.dump(bam, tiled, str(mine), device="cpu",
                                   emit=_quiet)
    assert str(mine / "chunk_names.txt") in written
    theirs = tmp_path / "jax"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    res = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "scripts", "native_profile", "dump_chunk_args.py"),
         bam, tiled, str(theirs)],
        env=env, capture_output=True, timeout=TIMEOUT,
    )
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    bins = sorted(p for p in os.listdir(theirs) if p.endswith(".bin"))
    assert "rt.bin" in bins and "v_u8.bin" in bins
    assert sorted(p for p in os.listdir(mine) if p.endswith(".bin")) == bins
    for name in bins:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    with open(mine / "chunk_names.txt") as fh:
        refs, rgs = fh.read().split("\n--\n")
    assert refs.split("\n") == [r for r, _ in fixture.bench_events(24)[0]]


def test_tools_import_with_jax_refused():
    code = (
        "import sys\n"
        "from svtyper_tpu_torch.tools import RefuseJax\n"
        "sys.meta_path.insert(0, RefuseJax())\n"
        + "".join("import svtyper_tpu_torch.tools.%s\n" % t for t in TOOLS)
        + "assert 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_refuse_without_cuda(tool, monkeypatch, capsys):
    """No CUDA device and no device named: the command exits 1 before it
    simulates or reads anything, and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = sys.modules["svtyper_tpu_torch.tools." + tool]
    argv = ["in.bam", "in.vcf"] if tool == "dump_chunk_args" else []
    assert mod.main(argv) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_tools_refuse_pure_python_decoder_on_cuda(monkeypatch):
    monkeypatch.setattr(fixture, "decoder_name", lambda: "pure-Python")
    monkeypatch.setattr(common, "nvidia_smi_line", lambda: "card, 700.00 W")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(common.ToolError, match="pure-Python"):
        common.header("soak", "cuda")
    assert common.header("gl_bench", "cuda", reads_bam=False)["decoder"] \
        == "pure-Python"
    assert common.header("soak", "cpu") == {
        "tool": "soak", "device": "cpu", "decoder": "pure-Python"}
