"""The port's command lines (svtyper_tpu_torch.cli) on the CPU.

- float64: byte-identical to the oracle's golden files, and to the JAX
  CLI's ``svtyper-sso``;
- float32 (the CUDA kernel's twin): byte-identical to the JAX CLI run
  with its Pallas GL kernel interpreted, ``JAX_ENABLE_X64=0
  SVT_PALLAS=interpret`` (the tests/test_pallas_engine.py setup);
- the vectorized emitter copy against the original on 512 random rows,
  and fast vs object emission on a two-sample run with a BND;
- checkpoint/resume, ``--num_shards``, ``--profile``, ``-w`` on a
  sharded run, the CUDA refusal, and the package importing with jax
  refused.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svtyper_tpu_torch.cli import classic as tclassic
from svtyper_tpu_torch.cli.sso import main as tsso_main
from svtyper_tpu_torch.simulate import (
    Event,
    SimConfig,
    events_to_vcf,
    simulate_events,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
EXAMPLE = ["-i", os.path.join(DATA, "example.vcf"),
           "-B", os.path.join(DATA, "example.sim.sorted.bam"), "-n", "60000"]


def _run(argv, entry=tclassic.main):
    assert entry(argv, device="cpu") == 0


def _read(p):
    with open(p) as fh:
        return fh.read()


@pytest.mark.parametrize("engine", ["torch", "oracle"])
@pytest.mark.parametrize(
    "golden,extra",
    [("example.expected.vcf", []),
     ("example.expected.gated.vcf",
      ["--max_ci_dist", "50", "--max_reads", "2000"])],
    ids=["default", "gated"],
)
def test_example_golden(engine, golden, extra, tmp_path):
    out = str(tmp_path / "out.vcf")
    _run(EXAMPLE + ["-o", out, "--engine", engine] + extra)
    assert _read(out) == _read(os.path.join(DATA, golden))


REFS = [("chr1", 9_000_000)]
PE_EVENTS = [
    Event(["DEL", "DEL", "DUP", "INV"][i % 4], "chr1",
          200_000 + i * 300_000, 200_000 + i * 300_000 + 900 + 71 * i,
          ["0/0", "0/1", "1/1"][i % 3], var_id="v%d" % i)
    for i in range(24)
]


@pytest.fixture(scope="module")
def pe_fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pallas_engine")
    bam = str(d / "pe.bam")
    simulate_events(bam, REFS, PE_EVENTS, SimConfig(depth=35), seed=33,
                    extra_background=1500)
    vcf = str(d / "pe.vcf")
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(PE_EVENTS, REFS))
    return bam, vcf, str(d)


def test_f32_matches_jax_pallas_interpret_cli(pe_fixture):
    bam, vcf, d = pe_fixture
    out_jax = os.path.join(d, "jax_pallas.vcf")
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        JAX_ENABLE_X64="0",
        XLA_FLAGS="--xla_force_host_platform_device_count=1",
        SVT_PALLAS="interpret",
        PYTHONPATH=ROOT,
    )
    res = subprocess.run(
        [sys.executable, "-m", "svtyper_tpu.cli.classic",
         "-i", vcf, "-B", bam, "-o", out_jax, "-n", "20000"],
        env=env, capture_output=True, timeout=600,
    )
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    out_t = os.path.join(d, "torch_f32.vcf")
    with open(vcf) as fi, open(out_t, "w") as fo:
        tclassic.sv_genotype(bam, fi, fo, num_samp=20000, device="cpu",
                             dtype=torch.float32)
    assert _read(out_t) == _read(out_jax)


def test_sso_matches_jax_sso(pe_fixture, tmp_path):
    from svtyper_tpu.cli.sso import main as jsso_main

    bam, vcf, _d = pe_fixture
    a, b = str(tmp_path / "t.vcf"), str(tmp_path / "j.vcf")
    argv = ["-i", vcf, "-B", bam, "-n", "20000"]
    _run(argv + ["-o", a], entry=tsso_main)
    assert jsso_main(argv + ["-o", b]) == 0
    assert _read(a) == _read(b)
    assert tsso_main(["-B", "x.bam,y.bam"], device="cpu") == 2


def test_checkpoint_resume_and_shards(pe_fixture, tmp_path):
    bam, vcf, _d = pe_fixture
    argv = ["-i", vcf, "-B", bam, "-n", "20000"]
    base = str(tmp_path / "base.vcf")
    _run(argv + ["-o", base])
    ck = str(tmp_path / "ck")
    ck_argv = argv + ["--checkpoint_dir", ck, "--batch_size", "5"]
    _run(ck_argv + ["-o", str(tmp_path / "c1.vcf")])
    parts = sorted(p for p in os.listdir(ck) if p.endswith(".vcfpart"))
    assert parts == ["part_%06d.vcfpart" % i for i in range(5)]
    assert _read(str(tmp_path / "c1.vcf")) == _read(base)
    # one part gone: only that chunk is re-genotyped, output identical
    os.unlink(os.path.join(ck, parts[2]))
    _run(ck_argv + ["-o", str(tmp_path / "c2.vcf")])
    assert _read(str(tmp_path / "c2.vcf")) == _read(base)
    outs = []
    for i in range(3):
        o = str(tmp_path / ("shard%d.vcf" % i))
        _run(argv + ["-o", o, "--num_shards", "3", "--shard_index", str(i)])
        outs.append(_read(o))
    assert "".join(outs) == _read(base)


FE_REFS = [("chr1", 8_000_000), ("chr2", 2_000_000)]
FE_EVENTS = [
    Event("DEL", "chr1", 1_000_000, 1_003_000, "0/1"),
    Event("DUP", "chr1", 2_000_000, 2_003_000, "1/1"),
    Event("INV", "chr1", 3_000_000, 3_002_000, "0/1"),
    Event("BND", "chr1", 4_000_000, 500_000, "0/1", chrom2="chr2"),
    Event("DEL", "chr1", 5_000_000, 5_002_000, "0/0"),
]


def test_fast_vs_object_emission_two_samples(tmp_path, monkeypatch):
    """Two samples (the second lacks the BND) through the fast emitter
    and through --debug's object path: byte-identical, with the fast
    formatter shown to run."""
    bam_a, bam_b = str(tmp_path / "a.bam"), str(tmp_path / "b.bam")
    simulate_events(bam_a, FE_REFS, FE_EVENTS,
                    SimConfig(depth=34, sample_name="SAMPLE_A"),
                    seed=5, extra_background=1500)
    simulate_events(bam_b, FE_REFS, FE_EVENTS[:3],
                    SimConfig(depth=34, sample_name="SAMPLE_B"),
                    seed=6, extra_background=1500)
    vcf = str(tmp_path / "in.vcf")
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(FE_EVENTS, FE_REFS, sample="SAMPLE_A"))
    import svtyper_tpu_torch.cli.fast_emit as fe

    calls = []
    orig = fe.format_chunk_lines
    monkeypatch.setattr(
        fe, "format_chunk_lines",
        lambda *a, **k: calls.append(1) or orig(*a, **k),
    )
    argv = ["-i", vcf, "-B", "%s,%s" % (bam_a, bam_b), "-n", "50000"]
    fast, slow = str(tmp_path / "fast.vcf"), str(tmp_path / "slow.vcf")
    _run(argv + ["-o", fast])
    assert calls, "fast path did not engage"
    _run(argv + ["-o", slow, "--debug"])
    assert _read(fast) == _read(slow)
    body = [l.split("\t") for l in _read(fast).splitlines()
            if not l.startswith("#")]
    bnd = [c for c in body if "SVTYPE=BND" in c[7]]
    assert len(bnd) == 1 and bnd[0][10].startswith("./.")


def test_fast_emit_copy_matches_original():
    """The port's fast_emit (a copy with its imports changed) formats 512
    random packed rows exactly as the original does (the
    tests/test_fast_emit.py fuzz rows)."""
    from svtyper_tpu.cli import fast_emit as jfe
    from svtyper_tpu_torch.cli import fast_emit as tfe
    from svtyper_tpu_torch.gt.engine import _I, _NI

    rng = np.random.default_rng(99)
    n = 512
    a = np.zeros((n, 24), dtype=np.float32)
    a[:, _I["null"]] = rng.integers(0, 2, n)
    a[:, _I["gt_idx"]] = rng.integers(0, 3, n)
    a[:, _I["gq"]] = rng.integers(0, 201, n)
    a[:, _I["qr"]] = rng.integers(0, 5000, n)
    a[:, _I["qa"]] = rng.integers(0, 5000, n)
    a[:, _I["ab_valid"]] = rng.integers(0, 2, n)
    a[:, _NI + 0 : _NI + 3] = -rng.exponential(50, (n, 3))
    a[:, _NI + 3] = rng.exponential(100, n)
    a[:, _NI + 4] = rng.random(n)
    a[:, _NI + 5 : _NI + 10] = rng.exponential(40, (n, 5))
    a[:, _NI + 8] -= 5
    a[0, _NI:] = 0.0
    a[1, _NI + 3] = 1e-7
    a[2, _NI + 4] = 0.9999999
    a[3, _NI + 5 : _NI + 10] = 16_000_000.0
    got = tfe._format_sample(a, n)
    want = jfe._format_sample(a, n)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert tfe.FIELD_ORDER == jfe.FIELD_ORDER and tfe._ROW_FMT == jfe._ROW_FMT
    for i in range(n):
        r, s = tfe._to_result(a, i), jfe._to_result(a, i)
        assert [getattr(r, k) for k in r.__slots__] == [
            getattr(s, k) for k in s.__slots__
        ]


def test_unported_modes_raise(monkeypatch, pe_fixture, tmp_path, capsys):
    """The modes the port once refused now run: ``--profile`` writes a Chrome
    trace, and ``-w`` on a sharded run (4 CPU shards, the engine-export
    path with per-shard evidence merged) writes the same BAM records as
    one device. Without CUDA the CLI's default device still refuses."""
    import json

    from svtyper_tpu_torch.bamio.bam import BamFile
    from svtyper_tpu_torch.bamio.native import get_lib

    out = str(tmp_path / "o.vcf")
    prof = tmp_path / "prof"
    _run(EXAMPLE + ["-o", out, "--profile", str(prof)])
    assert _read(out) == _read(os.path.join(DATA, "example.expected.vcf"))
    (trace,) = list(prof.iterdir())
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::segment_reduce" for e in events)

    bam, vcf, _d = pe_fixture
    argv = ["-i", vcf, "-B", bam, "-n", "20000", "--batch_size", "5"]
    ev = {}
    for key, kw in (("one", {"device": "cpu"}),
                    ("sharded", {"devices": ["cpu"] * 4})):
        capsys.readouterr()
        path = str(tmp_path / ("ev_%s.bam" % key))
        assert tclassic.main(
            argv + ["-o", str(tmp_path / (key + ".vcf")), "-w", path], **kw
        ) == 0
        err = capsys.readouterr().err
        assert ("re-fetch" in err) == (get_lib() is None), err
        ev[key] = BamFile(path).fetch("chr1", 0, REFS[0][1])
    assert "rounded to 8" in err
    assert _read(str(tmp_path / "sharded.vcf")) == _read(
        str(tmp_path / "one.vcf"))
    a, b = ev["one"], ev["sharded"]
    assert a.n == b.n > 0
    for col in ("qname_hash", "pos", "flag"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tclassic.main(EXAMPLE + ["-o", out])  # default: the CUDA devices


_JAX_FREE = r"""
import sys

class RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "svtyper_tpu"):
            raise ImportError("refused: " + name)

sys.meta_path.insert(0, RefuseJax())
import svtyper_tpu_torch
import svtyper_tpu_torch.cli.classic
import svtyper_tpu_torch.cli.sso
import svtyper_tpu_torch.gt.engine
import svtyper_tpu_torch.ops.gl_kernel
import svtyper_tpu_torch.parallel.dryrun
import svtyper_tpu_torch.parallel.multihost
import svtyper_tpu_torch.utils.fixture
import svtyper_tpu_torch.utils.parity
import chip_smoke
assert "jax" not in sys.modules and "svtyper_tpu" not in sys.modules
print("ok")
"""


def test_package_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _JAX_FREE], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA device: the smoke exits non-zero and prints no result
    line, from the checkout and from a directory holding only itself."""
    import shutil

    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(lone))):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        res = subprocess.run(
            [sys.executable, script], env=env, cwd=cwd,
            capture_output=True, text=True, timeout=300,
        )
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
