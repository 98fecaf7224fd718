"""The port's last entry points on the CPU, against their JAX or script
counterparts.

- ``tools.profile_prep``, native path, at chunk 128 over one and two
  shards: each chunk's compact wire identical, array for array, to the
  JAX ``prepare_compact_chunk``'s, the wrapped run's wires identical to
  an unwrapped ``TorchEngine._prepare``'s, one fetch per shard handle,
  the parts of each chunk no more than its wall when they ran one at a
  time, and the wrappers gone after the run; Python path:
  its chunks equal the JAX ``prepare_chunk``'s;
- ``tools.parity_diff`` against ``scripts/parity_diff.py``: the same
  stdout and exit code on five VCF pairs;
- ``tools.reference_parity``: ``--mock`` passes every lane, a mock
  reference with one GT corrupted fails, and with no reference it exits
  0 and says so;
- ``tools.make_example_data`` byte-identical to ``data/``, and the
  replay harness's copy to its original;
- the ``svtyper-torch`` console scripts in ``setup.py``, resolved with
  jax and the JAX package refused, the JAX entries unchanged;
- every new tool imports with jax refused; those that drive the engine
  exit 1 without CUDA unless a device is named.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svtyper_tpu.bamio.bam import open_bam as jopen_bam
from svtyper_tpu.breakpoints import resolve_breakpoint as jresolve
from svtyper_tpu.evidence import extract as jextract
from svtyper_tpu.stats import Sample as JSample
from svtyper_tpu.vcfio.model import Variant as JVariant
from svtyper_tpu.vcfio.model import Vcf as JVcf
from svtyper_tpu.vcfio.reader import read_vcf_lines as jread_vcf_lines
from svtyper_tpu_torch.evidence import extract
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.simulate import SimConfig, events_to_vcf, simulate_events
from svtyper_tpu_torch.tools import (
    make_example_data,
    parity_diff,
    profile_prep,
    reference_parity,
)
from svtyper_tpu_torch.utils import fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
N_TILED = 600
CHUNK = 128
TIMEOUT = 300
NEW_TOOLS = ("profile_prep", "reference_parity", "parity_diff",
             "make_example_data")
ENGINE_TOOLS = ("profile_prep", "reference_parity")


def _quiet(_obj):
    pass


@pytest.fixture(scope="module")
def sample_files(tmp_path_factory):
    """``test_torch_tools.py``'s sample: bench.py's generator at 24
    events, 20x → (bam, vcf tiled to 600 records)."""
    d = tmp_path_factory.mktemp("torch_entry_points")
    refs, events = fixture.bench_events(24)
    bam = str(d / "s.bam")
    simulate_events(bam, refs, events, SimConfig(depth=20), seed=5,
                    extra_background=500)
    vcf = str(d / "s.vcf")
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(events, refs))
    tiled = str(d / "tiled.vcf")
    fixture.tile_vcf(vcf, tiled, N_TILED)
    return bam, tiled


def _jax_sample_and_breakpoints(bam, vcf):
    """``fixture.load_sample_and_breakpoints`` through the JAX package's
    host half."""
    sample = JSample.from_bam(jopen_bam(bam), num_samp=200_000)
    v = JVcf()
    with open(vcf) as fh:
        header, body = jread_vcf_lines(fh)
        v.add_header(header)
        bps = [jresolve(JVariant(line, v)) for line in body]
    return sample, bps


def _spy_prepare(monkeypatch):
    """Records every ``TorchEngine._prepare`` result."""
    seen = []
    real = TorchEngine._prepare

    def spy(self, bps):
        seen.append(real(self, bps))
        return seen[-1]

    monkeypatch.setattr(TorchEngine, "_prepare", spy)
    return seen


def _wires(payloads):
    """One ``_prepare`` result (one sample) → its shards' compact wires."""
    (shards,) = payloads
    out = []
    for (kind, compact), _n_var in shards:
        assert kind == "compact"
        out.append(compact)
    return out


def _assert_wires_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("shards", [1, 2])
def test_profile_prep_native_wires_match_jax(shards, sample_files,
                                             monkeypatch):
    bam, tiled = sample_files
    originals = (extract._chunk_preamble, extract._pack_variant_tables)
    seen = _spy_prepare(monkeypatch)
    results, prof = profile_prep.run(bam, tiled, sizes=(CHUNK,),
                                     shards=(shards,), device="cpu",
                                     emit=_quiet)
    assert (extract._chunk_preamble,
            extract._pack_variant_tables) == originals
    (res,) = results
    n_chunks = -(-N_TILED // CHUNK)
    assert (res["chunk_size"], res["shards"], res["chunks"]) == (
        CHUNK, shards, n_chunks)
    assert res["usable_cores"] == len(os.sched_getaffinity(0))
    assert "prepare_compact_chunk" in prof
    assert len(res["per_chunk"]) == n_chunks
    for part in res["per_chunk"]:
        assert min(part[k] for k in profile_prep.PARTS[:3]) > 0
        parts = sum(part[k] for k in profile_prep.PARTS[:3])
        assert part["parts_ms"] == pytest.approx(parts)
        assert part["other_ms"] == pytest.approx(part["wall_ms"] - parts)
        # every shard's handle is wrapped: one fetch per shard
        assert part["fetches"] == shards
        assert 0 < part["fetch_union_ms"] <= part["wall_ms"]
        assert part["fetch_union_ms"] <= part["fetch_ms"] * (1 + 1e-9)
        assert 1 <= part["max_in_flight"] <= shards
        if part["max_in_flight"] == 1:  # the parts ran one at a time
            assert parts <= part["wall_ms"]
            assert part["other_ms"] >= 0
    # the warm-up chunk, the timed pass, then the cProfile passes
    assert len(seen) == (1 + (1 + profile_prep.PROFILE_PASSES) * n_chunks)
    timed = [_wires(p) for p in seen[1:1 + n_chunks]]

    # an unwrapped engine over the same chunks gives the same wires
    sample, bps = fixture.load_sample_and_breakpoints(bam, tiled)
    engine = TorchEngine([sample], chunk_size=CHUNK, devices=["cpu"] * shards)
    chunks = profile_prep.chunks_of(bps, CHUNK)
    engine._prepare(chunks[0])
    for key in engine.stats:
        engine.stats[key] = 0
    for want, chunk in zip(timed, chunks):
        _assert_wires_equal(_wires(engine._prepare(chunk)), want)
    assert (engine.stats["reads"], engine.stats["pairs"]) == (
        res["reads"], res["pairs"])

    # ... and the JAX package's prepare_compact_chunk, shard by shard
    jsample, jbps = _jax_sample_and_breakpoints(bam, tiled)
    per = CHUNK // shards
    for i, want in enumerate(timed):
        chunk = jbps[i * CHUNK:(i + 1) * CHUNK]
        chunk = chunk + [None] * (CHUNK - len(chunk))
        for d, mine in enumerate(want):
            theirs, n_var, _, _ = jextract.prepare_compact_chunk(
                jsample, chunk[d * per:(d + 1) * per], min_aligned=20,
                pad_reads=mine["cr_u16"].shape[1],
                pad_pairs=mine["cp_u16"].shape[1],
            )
            assert n_var == per
            _assert_wires_equal([mine], [theirs])


def test_profile_prep_python_chunks_match_jax(sample_files, monkeypatch):
    bam, tiled = sample_files
    seen = []
    real = profile_prep.prepare_chunk

    def spy(sample, bps):
        seen.append((list(bps), real(sample, bps)))
        return seen[-1][1]

    monkeypatch.setattr(profile_prep, "prepare_chunk", spy)
    (res,), prof = profile_prep.run(bam, tiled, sizes=(CHUNK,),
                                    path="python", device="cpu", emit=_quiet)
    n_chunks = -(-N_TILED // CHUNK)
    assert (res["path"], res["chunks"], res["variants"]) == (
        "python", n_chunks, N_TILED)
    assert "prepare_chunk" in prof
    assert len(seen) == 1 + (1 + profile_prep.PROFILE_PASSES) * n_chunks
    jsample, jbps = _jax_sample_and_breakpoints(bam, tiled)
    for i, (bps, mine) in enumerate(seen[1:1 + n_chunks]):
        assert len(bps) == CHUNK
        chunk = jbps[i * CHUNK:(i + 1) * CHUNK]
        theirs = jextract.prepare_chunk(
            jsample, chunk + [None] * (CHUNK - len(chunk)))
        assert mine.n_var == theirs.n_var == CHUNK
        assert mine.packed.keys() == theirs.packed.keys()
        for k in mine.packed:
            np.testing.assert_array_equal(mine.packed[k], theirs.packed[k],
                                          err_msg=k)


def test_profile_prep_rejects_unknown_path():
    with pytest.raises(ValueError, match="path"):
        profile_prep.run(path="rust", device="cpu", emit=_quiet)


# ------------------------------------------------------------ parity_diff


def _vcf_pairs(tmp_path):
    with open(os.path.join(DATA, "example.expected.vcf")) as fh:
        text = fh.read()
    lines = text.splitlines(True)
    body = [i for i, l in enumerate(lines) if not l.startswith("#")]
    fmt = [i for i, l in enumerate(lines) if l.startswith("##FORMAT")]

    def gl_changed():
        out = list(lines)
        cols = out[body[0]].split("\t")
        keys = cols[8].split(":")
        vals = cols[9].rstrip("\n").split(":")
        gl = vals[keys.index("GL")].split(",")
        gl[0] = str(int(gl[0]) - 1)
        vals[keys.index("GL")] = ",".join(gl)
        cols[9] = ":".join(vals) + "\n"
        out[body[0]] = "\t".join(cols)
        return out

    def reordered():
        out = list(lines)
        out[fmt[0]], out[fmt[1]] = out[fmt[1]], out[fmt[0]]
        return out

    gt = text.replace("\t0/1:", "\t1/1:", 1) if "\t0/1:" in text \
        else text.replace("\t1/1:", "\t0/1:", 1)
    cases = {
        "identical": text,
        "gt_flipped": gt,
        "gl_changed": "".join(gl_changed()),
        "record_missing": "".join(l for i, l in enumerate(lines)
                                  if i != body[-1]),
        "format_reordered": "".join(reordered()),
    }
    ref = tmp_path / "ref.vcf"
    ref.write_text(text)
    for name, ours in cases.items():
        (tmp_path / ("%s.vcf" % name)).write_text(ours)
    return str(ref), list(cases)


@pytest.mark.parametrize("case", ["identical", "gt_flipped", "gl_changed",
                                  "record_missing", "format_reordered"])
def test_parity_diff_matches_script(case, tmp_path):
    ref, cases = _vcf_pairs(tmp_path)
    assert case in cases
    ours = str(tmp_path / ("%s.vcf" % case))
    runs = [
        subprocess.run(cmd + [ref, ours, case], capture_output=True,
                       text=True, timeout=TIMEOUT, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT))
        for cmd in (
            [sys.executable, os.path.join(ROOT, "scripts", "parity_diff.py")],
            [sys.executable, "-m", "svtyper_tpu_torch.tools.parity_diff"],
        )
    ]
    script, port = runs
    assert port.stdout == script.stdout and port.stdout
    assert port.returncode == script.returncode == (case != "identical")
    assert parity_diff.main([ref, ours, case]) == script.returncode


# ------------------------------------------------------- reference_parity


def test_reference_parity_mock_passes(tmp_path, capsys):
    assert reference_parity.main(["--mock", str(tmp_path)],
                                 device="cpu") == 0
    out = capsys.readouterr().out
    assert "MOCK MODE" in out and "PARITY: all lanes passed" in out
    for label in ("bundled/cpu", "bundled/oracle", "sim/cpu", "sim/oracle"):
        assert "%-16s 12 records: PASS" % label in out
    assert "PASS lib-json lib/cpu" in out and "PASS lib-json lib/oracle" in out


def test_reference_parity_detects_divergence(tmp_path, capsys):
    """A mock reference whose output has one GT flipped fails the run
    (``tests/test_parity_harness.py``'s divergence drill)."""
    mock = reference_parity.make_mock(str(tmp_path / "mock"))
    classic = os.path.join(mock, "svtyper", "classic.py")
    with open(classic) as fh:
        src = fh.read()
    corrupt = (
        "_real_main = main\n\n\n"
        "def main(argv=None):\n"
        "    rc = _real_main(argv)\n"
        "    out = sys.argv[sys.argv.index('-o') + 1]\n"
        "    with open(out) as fh:\n"
        "        text = fh.read()\n"
        "    with open(out, 'w') as fh:\n"
        "        fh.write(text.replace('\\t0/1:', '\\t1/1:', 1))\n"
        "    return rc\n\n\n"
    )
    tail = 'if __name__ == "__main__":'
    with open(classic, "w") as fh:
        fh.write(src.replace(tail, corrupt + tail))
    assert reference_parity.main([mock, str(tmp_path / "w")],
                                 device="cpu") == 1
    out = capsys.readouterr().out
    assert "GT=1" in out and "PARITY: mismatches found" in out
    assert "PASS lib-json lib/cpu" in out  # only the records diverge


def test_reference_parity_without_reference(tmp_path, monkeypatch, capsys):
    with open(reference_parity.SCRIPT) as fh:
        script = fh.read()
    probes = reference_parity.probe_locations()
    assert len(probes) == 3 and all(p in script for p in probes)
    monkeypatch.setattr(reference_parity, "probe_locations",
                        lambda: [str(tmp_path / "absent")])
    assert reference_parity.main([], device="cpu") == 0
    assert reference_parity.main([str(tmp_path / "absent")],
                                 device="cpu") == 0
    assert "reference unavailable" in capsys.readouterr().err


# ------------------------------------------- example data, replay harness


def test_make_example_data_matches_data(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert make_example_data.main([str(tmp_path)]) == 0  # needs no device
    for name in ("example.sim.sorted.bam", "example.sim.sorted.bam.bai",
                 "example.vcf"):
        with open(os.path.join(DATA, name), "rb") as fh:
            assert (tmp_path / name).read_bytes() == fh.read(), name
    assert make_example_data.OUTDIR == os.path.join(
        ROOT, "build", "tools", "example")


def test_replay_harness_copy_is_identical():
    paths = [os.path.join(ROOT, "scripts", "native_profile",
                          "replay_harness.cpp"),
             os.path.join(ROOT, "svtyper_tpu_torch", "tools",
                          "native_profile", "replay_harness.cpp")]
    texts = []
    for p in paths:
        with open(p, "rb") as fh:
            texts.append(fh.read())
    assert texts[0] == texts[1] and b"svt_fetch_chunk" in texts[0]


# -------------------------------------------------------- console scripts


def _setup_entry_points():
    with open(os.path.join(ROOT, "setup.py")) as fh:
        tree = ast.parse(fh.read())
    (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, "id", None) == "setup"]
    kw = {k.arg: k.value for k in call.keywords}
    return (ast.literal_eval(kw["entry_points"]),
            ast.literal_eval(kw["package_data"]))


def test_console_scripts_resolve_with_jax_refused():
    entry_points, package_data = _setup_entry_points()
    scripts = dict(e.split("=", 1) for e in entry_points["console_scripts"])
    assert scripts == {
        "svtyper": "svtyper_tpu.cli.classic:main",
        "svtyper-sso": "svtyper_tpu.cli.sso:main",
        "svtyper-torch": "svtyper_tpu_torch.cli.classic:main",
        "svtyper-torch-sso": "svtyper_tpu_torch.cli.sso:main",
    }
    assert package_data["svtyper_tpu_torch.tools"] == [
        "native_profile/*.cpp"]
    targets = [scripts["svtyper-torch"], scripts["svtyper-torch-sso"]]
    code = (
        "import importlib, sys\n"
        "from svtyper_tpu_torch.tools import RefuseJax, REFUSED\n"
        "sys.meta_path.insert(0, RefuseJax())\n"
        "for target in sys.argv[1:]:\n"
        "    module, attr = target.split(':')\n"
        "    assert callable(getattr(importlib.import_module(module), attr))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in REFUSED]\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code, *targets], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


# ------------------------------------------------------ the no-CUDA rules


def test_new_tools_import_with_jax_refused():
    code = (
        "import sys\n"
        "from svtyper_tpu_torch.tools import RefuseJax, REFUSED\n"
        "sys.meta_path.insert(0, RefuseJax())\n"
        + "".join("import svtyper_tpu_torch.tools.%s\n" % t
                  for t in NEW_TOOLS)
        + "assert not [m for m in sys.modules if m.split('.')[0] in REFUSED]\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("tool", ENGINE_TOOLS)
@pytest.mark.parametrize("argv", [[], ["--mock"]], ids=["bare", "mock"])
def test_engine_tools_refuse_without_cuda(tool, argv, monkeypatch, capsys):
    """No CUDA device and no device named: the command exits 1 before it
    simulates, reads or runs anything, and prints no result."""
    if tool == "profile_prep" and argv:
        argv = ["1024"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"profile_prep": profile_prep,
           "reference_parity": reference_parity}[tool]
    assert mod.main(argv) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
