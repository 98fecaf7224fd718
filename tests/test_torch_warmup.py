"""The cards' warm-up (``gt/engine.py::warm_devices``) on the CPU.

A fresh process's first use of each card (its context, both kernels'
modules, the pinned allocator, the density uploads) runs on warm-up
threads that the first send joins. Here, with no card, the CUDA steps
are stubbed where a test needs them to run:

- a CPU engine and the CLI with ``device="cpu"`` never call into
  ``torch.cuda`` (its entry points stubbed to raise);
- the first send waits for a warm-up and re-raises its error, and takes
  its density tables into ``_dens_for``'s cache;
- a card warms once per process, across calls and engines, while each
  call uploads its own samples' tables;
- the warm-up's steps launch no kernel: both launch counters stay put;
- the CLI starts the warm-up after its clock starts and before it opens
  the BAMs and reads the libraries;
- the rows are byte-identical with and without a warm-up;
- ``tools/first_use.py``'s CPU parts.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from svtyper_tpu_torch.cli import classic
from svtyper_tpu_torch.gt import engine as teng
from svtyper_tpu_torch.gt.engine import TorchEngine, Warmup, _Warm, dens_state
from svtyper_tpu_torch.ops import _build, classify_kernel, gl_kernel
from svtyper_tpu_torch.stats import Sample
from svtyper_tpu_torch.tools import common, first_use
from svtyper_tpu_torch.utils import fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
BAM = os.path.join(DATA, "example.sim.sorted.bam")
VCF = os.path.join(DATA, "example.vcf")
CPU = torch.device("cpu")
JOIN_S = 30  # a warm-up thread's join in these tests


@pytest.fixture(scope="module")
def example():
    """(sample, the first 96 records' breakpoints) of ``data/``."""
    return fixture.load_sample_and_breakpoints(BAM, VCF, 96, num_samp=60_000)


@pytest.fixture
def woken(monkeypatch):
    """A fresh per-process registry of woken cards."""
    reg = {}
    monkeypatch.setattr(teng, "_WOKEN", reg)
    return reg


def _no_cuda(monkeypatch):
    """Every ``torch.cuda`` entry the warm-up or a first send reaches,
    and the kernels' build, raise."""
    def refuse(*_a, **_k):
        raise AssertionError("torch.cuda touched on a CPU run")

    for name in ("init", "_lazy_init", "is_available", "device_count",
                 "current_device", "set_device", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "warm", refuse)


def _rows(engine, bps):
    return [a[0][:n] for n, a in engine.genotype_stream(bps, raw=True)]


@pytest.mark.parametrize("entry", ["engine", "cli"])
def test_cpu_run_never_touches_cuda(entry, example, woken, monkeypatch,
                                    tmp_path):
    _no_cuda(monkeypatch)
    if entry == "engine":
        sample, bps = example
        eng = TorchEngine([sample], chunk_size=32, device="cpu")
        assert eng._warm is None
        assert len(np.concatenate(_rows(eng, bps))) == len(bps)
        eng.close()
    else:
        out = tmp_path / "out.vcf"
        assert classic.main(["-i", VCF, "-B", BAM, "-n", "60000",
                             "-o", str(out)], device="cpu") == 0
        with open(os.path.join(DATA, "example.expected.vcf")) as fh:
            assert out.read_text() == fh.read()
    assert woken == {}


def test_first_send_waits_and_takes_the_dens_tables(example):
    sample, bps = example
    eng = TorchEngine([sample], chunk_size=32, device="cpu")
    table = dens_state(sample.dens_matrix(), CPU, torch.float64)
    release = threading.Event()

    def slow(parts):
        parts["dens_s"] = 0.0
        release.wait(JOIN_S)
        return {(0, CPU): table}

    eng._warm = Warmup({}, _Warm("test-warm", slow))
    threading.Timer(0.2, release.set).start()
    t0 = time.time()
    eng.genotype_chunk(bps[:32])
    assert time.time() - t0 >= 0.2
    assert eng._warm is None
    assert eng.stats["warm_wait_s"] >= 0.15
    assert eng.stats["warm_s"] >= 0.15
    assert eng.warm_parts == {"dens": {"dens_s": 0.0}}
    assert eng._dens_for(0, CPU) is table
    # later sends do not wait again
    wait = eng.stats["warm_wait_s"]
    eng.genotype_chunk(bps[32:64])
    assert eng.stats["warm_wait_s"] == wait


def test_first_send_reraises_the_warmup_error(example):
    sample, bps = example
    eng = TorchEngine([sample], chunk_size=32, device="cpu")

    def boom(_parts):
        raise RuntimeError("no context on the card")

    eng._warm = Warmup({CPU: _Warm("test-card", boom)}, None)
    with pytest.raises(RuntimeError, match="no context on the card"):
        eng.genotype_chunk(bps[:32])
    # close() waits for the warm-up without raising
    eng.close()


def test_a_card_warms_once_per_process(example, woken, monkeypatch):
    """The cards' part runs once per card across calls and engines; each
    call uploads its own samples' tables, after the cards' part."""
    sample, _ = example
    woke, uploads, inits = [], [], []
    monkeypatch.setattr(teng, "_wake", lambda dev, parts: woke.append(dev))
    monkeypatch.setattr(torch.cuda, "init", lambda: inits.append(1))
    monkeypatch.setattr(teng, "dens_state", lambda d, dev, dt: uploads.append(
        (dev, dt)) or torch.zeros(1))
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    first = teng.warm_devices([c0, "cuda:0", c1])
    again = teng.warm_devices(["cuda:1", "cuda:0", "cpu"], [sample, sample])
    for w in (first, again):
        w.join()
        assert set(w.cards) == {c0, c1}
    assert sorted(woke, key=str) == [c0, c1]
    assert first.dens is None
    assert set(again.dens.join()) == {(0, c0), (1, c0), (0, c1), (1, c1)}
    assert sorted(uploads, key=str) == [(c0, torch.float32)] * 2 \
        + [(c1, torch.float32)] * 2
    assert len(inits) == 2  # torch's lazy init on the caller, each call
    assert set(again.parts()) == {"cuda:0", "cuda:1", "dens"}
    assert again.busy_s() >= 0.0
    # a CPU-only call starts nothing
    assert teng.warm_devices(["cpu"], [sample]).cards == {}
    assert len(woke) == 2 and len(inits) == 2


def test_warmup_launches_no_kernel(example, woken, monkeypatch):
    """The real ``_wake`` with the CUDA calls stubbed: it loads both
    libraries and each kernel's module by ``svt_warm`` on the card's
    index, takes a pinned block, and both launch counters stay put."""
    sample, _ = example
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: calls.append(
        ("load", name)))
    monkeypatch.setattr(_build, "warm", lambda name, idx: calls.append(
        ("warm", name, idx)))
    monkeypatch.setattr(torch.cuda, "init", lambda: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    real_empty = torch.empty

    def empty(*args, **kw):
        calls.append(("empty", args, kw.get("pin_memory")))
        kw.pop("pin_memory", None)
        return real_empty(*args, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(teng, "_prob_mapq_table", lambda dev, dt: calls.append(
        ("table", dev, dt)))
    monkeypatch.setattr(teng, "dens_state", lambda d, dev, dt: torch.zeros(1))
    before = (gl_kernel.LAUNCHES, classify_kernel.LAUNCHES)
    w = teng.warm_devices(["cuda:2"], [sample])
    w.join()
    assert (gl_kernel.LAUNCHES, classify_kernel.LAUNCHES) == before
    dev = torch.device("cuda", 2)
    assert calls == [
        ("load", "classify_kernel"), ("load", "gl_kernel"),
        ("warm", "classify_kernel", 2), ("warm", "gl_kernel", 2),
        ("empty", (teng.WARM_BLOCK_BYTES,), True),
        ("table", dev, torch.float32),
    ]
    assert set(w.parts()[str(dev)]) == {"libs_s", "modules_s", "pinned_s",
                                         "tables_s"}


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_cli_starts_the_warmup_before_reading_its_inputs(monkeypatch,
                                                         tmp_path):
    order = []
    real_warm = teng.warm_devices
    monkeypatch.setattr(teng, "warm_devices", lambda devices, samples=(): (
        order.append(("warm", [str(d) for d in devices]))
        or real_warm(devices, samples)))

    class Clock:
        def __getattr__(self, name):
            return getattr(time, name)

        @staticmethod
        def time():
            order.append("clock")
            return time.time()

    monkeypatch.setattr(classic, "time", Clock())
    real_open = classic.open_bam
    monkeypatch.setattr(classic, "open_bam", lambda *a, **k: (
        order.append("open_bam") or real_open(*a, **k)))
    for name in ("from_bam", "from_lib_info"):
        real = getattr(Sample, name).__func__
        monkeypatch.setattr(Sample, name, classmethod(
            lambda cls, *a, _n=name, _r=real, **k: (
                order.append(_n) or _r(cls, *a, **k))))
    lib = str(tmp_path / "lib.json")
    for run in (1, 2):  # a library scan, then its saved file
        order.clear()
        assert classic.main(["-i", VCF, "-B", BAM, "-n", "60000", "-l", lib,
                             "-o", str(tmp_path / "out.vcf")],
                            device="cpu") == 0
        seen = [o if isinstance(o, str) else o[0] for o in order]
        assert seen[0] == "clock"  # t0
        assert seen.index("warm") < seen.index("open_bam") \
            < seen.index("from_bam" if run == 1 else "from_lib_info")
        assert order[seen.index("warm")] == ("warm", ["cpu"])
    # the oracle engine wakes nothing
    order.clear()
    assert classic.main(["-i", VCF, "-B", BAM, "-n", "60000", "-l", lib,
                         "--engine", "oracle",
                         "-o", str(tmp_path / "oracle.vcf")]) == 0
    assert "warm" not in [o if isinstance(o, str) else o[0] for o in order]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rows_identical_with_and_without_warmup(dtype, example):
    sample, bps = example
    plain = TorchEngine([sample], chunk_size=32, device="cpu", dtype=dtype)
    want = np.concatenate(_rows(plain, bps))
    warmed = TorchEngine([sample], chunk_size=32, device="cpu", dtype=dtype)
    warmed._warm = Warmup({}, _Warm("test-dens", lambda parts: {
        (0, CPU): dens_state(sample.dens_matrix(), CPU, dtype)}))
    got = np.concatenate(_rows(warmed, bps))
    assert got.tobytes() == want.tobytes()
    assert warmed.stats["warm_wait_s"] >= 0.0 and warmed._warm is None


def test_cli_stats_carry_the_warmup(monkeypatch, tmp_path):
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("SVT_CLI_STATS", str(stats))
    assert classic.main(["-i", VCF, "-B", BAM, "-n", "60000",
                         "-o", str(tmp_path / "out.vcf")], device="cpu") == 0
    st = json.loads(stats.read_text())
    assert st["warm_s"] == st["warm_wait_s"] == 0.0
    assert st["warm_parts"] == {}


def test_first_use_tool_cpu_parts():
    lines = first_use.prescan_lines(1000)
    assert len(lines) == 1000 and not any(l.startswith("#") for l in lines)
    bnd = []
    assert first_use.prescan(lines, bnd=bnd) == 1000
    assert all("SVTYPE=BND" in l for l in bnd)
    assert first_use.modes(1)[:2] == ["cold", "split"]
    assert first_use.modes(4)[-1] == "contexts"
    assert {m.split(":")[1] for m in first_use.modes(1)[2:]} \
        == set(first_use.PARTS)
    with pytest.raises(common.ToolError, match="CUDA"):
        first_use.run(device="cpu")


def test_first_use_command_refuses_without_cuda(monkeypatch, capsys):
    """No CUDA device and none named: exit 1, no result line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert first_use.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_first_use_child_imports_with_jax_refused():
    """A measurement child starts under the jax refusal, as ``run``
    starts it; its body needs CUDA, so the import is what runs here."""
    code = first_use._CHILD.split("print(")[0] + "print('ok')"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
