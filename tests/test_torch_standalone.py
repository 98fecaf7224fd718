"""The port stands alone: it imports nothing of jax or of the JAX package,
and its copy of the host half behaves as the JAX package's does.

- with ``jax``, ``jaxlib`` and ``svtyper_tpu`` refused (a subprocess: the
  test workers hold ``svtyper_tpu`` already), every module of
  ``svtyper_tpu_torch`` and ``chip_smoke.py`` import, and the lazily
  imported paths run: the oracle engine, checkpoints, ``-w``, the
  simulator and CRAM;
- no ``.py`` file of the port, nor ``chip_smoke.py``, names
  ``svtyper_tpu`` in an import (an AST scan);
- each copied module equals its original with only the imports changed
  (``scripts/copy_host_half.py``);
- on the CPU, against the JAX package: both BAM decoders column by
  column on ``data/example.sim.sorted.bam``, the simulator's bytes from
  one seed, the oracle on ``data/example.vcf``, the VCF round trip and
  ``__version__``;
- the port's native decoder is its own library, and a CUDA run refuses
  the pure-Python decoder.
"""

import ast
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svtyper_tpu import version as jversion
from svtyper_tpu.bamio import bam as jbam
from svtyper_tpu.bamio import native as jnative
from svtyper_tpu.bamio.columns import FIELD_NAMES
from svtyper_tpu.breakpoints import resolve_breakpoint as jresolve
from svtyper_tpu.oracle import OracleEngine as JOracleEngine
from svtyper_tpu.output import add_format_headers as jadd_format_headers
from svtyper_tpu.simulate import Event as JEvent
from svtyper_tpu.simulate import SimConfig as JSimConfig
from svtyper_tpu.simulate import simulate_events as jsimulate_events
from svtyper_tpu.stats import Sample as JSample
from svtyper_tpu.vcfio.model import Variant as JVariant
from svtyper_tpu.vcfio.model import Vcf as JVcf
from svtyper_tpu.vcfio.reader import read_vcf_lines as jread_vcf_lines
from svtyper_tpu_torch import version as tversion
from svtyper_tpu_torch.bamio import bam as tbam
from svtyper_tpu_torch.bamio import native as tnative
from svtyper_tpu_torch.breakpoints import resolve_breakpoint as tresolve
from svtyper_tpu_torch.cli import classic as tclassic
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.oracle import OracleEngine as TOracleEngine
from svtyper_tpu_torch.output import add_format_headers as tadd_format_headers
from svtyper_tpu_torch.simulate import Event as TEvent
from svtyper_tpu_torch.simulate import SimConfig as TSimConfig
from svtyper_tpu_torch.simulate import simulate_events as tsimulate_events
from svtyper_tpu_torch.stats import Sample as TSample
from svtyper_tpu_torch.vcfio.model import Variant as TVariant
from svtyper_tpu_torch.vcfio.model import Vcf as TVcf
from svtyper_tpu_torch.vcfio.reader import read_vcf_lines as tread_vcf_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "svtyper_tpu_torch")
DATA = os.path.join(ROOT, "data")
BAM = os.path.join(DATA, "example.sim.sorted.bam")
VCF = os.path.join(DATA, "example.vcf")
TIMEOUT = 300


def _copy_script():
    spec = importlib.util.spec_from_file_location(
        "copy_host_half", os.path.join(ROOT, "scripts", "copy_host_half.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


COPY = _copy_script()


def _port_sources():
    out = []
    for d, dirs, files in os.walk(PORT):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        out += [os.path.relpath(os.path.join(d, f), ROOT)
                for f in sorted(files) if f.endswith(".py")]
    return out + ["chip_smoke.py"]


PORT_SOURCES = _port_sources()

# a subprocess's first lines: jax, jaxlib and the JAX package refused
_REFUSE = r"""
import sys

REFUSED = ("jax", "jaxlib", "svtyper_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)


sys.meta_path.insert(0, Refuse())


def assert_none_loaded():
    bad = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not bad, bad
"""


def _run_refused(code: str, *args) -> str:
    res = subprocess.run(
        [sys.executable, "-c", _REFUSE + code, *args], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=TIMEOUT,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_every_module_imports_with_jax_and_package_refused():
    out = _run_refused(r"""
import importlib
import pkgutil

import svtyper_tpu_torch

names = [m.name for m in pkgutil.walk_packages(
    svtyper_tpu_torch.__path__, "svtyper_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
assert_none_loaded()
print(len(names))
""")
    assert int(out) >= len(COPY.COPIES) + 20


def test_lazy_paths_run_with_jax_and_package_refused(tmp_path):
    """The oracle engine, checkpoints and ``-w`` (imported inside
    ``sv_genotype``), the simulator, and CRAM writing and reading
    (``cram_writer``, ``cram``, ``rans``, reached lazily from ``bam``)."""
    out = _run_refused(r"""
import os

from svtyper_tpu_torch.bamio.bam import open_bam
from svtyper_tpu_torch.bamio.cram_writer import bam_to_cram
from svtyper_tpu_torch.cli import classic
from svtyper_tpu_torch.simulate import Event, SimConfig, simulate_events

bam, vcf, golden, d = sys.argv[1:]
out = os.path.join(d, "oracle.vcf")
assert classic.main(
    ["-i", vcf, "-B", bam, "-n", "60000", "-o", out, "--engine", "oracle",
     "--checkpoint_dir", os.path.join(d, "ck"),
     "-w", os.path.join(d, "ev.bam")],
    device="cpu") == 0
with open(out) as a, open(golden) as b:
    assert a.read() == b.read()
sim = os.path.join(d, "sim.bam")
simulate_events(sim, [("chr1", 200_000)],
                [Event("DEL", "chr1", 50_000, 52_000, "0/1")],
                SimConfig(depth=10), seed=1, extra_background=100)
cram = os.path.join(d, "sim.cram")
bam_to_cram(sim, cram)
reads = open_bam(cram).fetch("chr1", 0, 200_000)
assert reads.n == open_bam(sim).fetch("chr1", 0, 200_000).n > 0
assert_none_loaded()
print("ok")
""", BAM, VCF, os.path.join(DATA, "example.expected.vcf"), str(tmp_path))
    assert out.strip() == "ok"


def _imported_modules(path):
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_no_import_of_the_jax_package(path):
    names = list(_imported_modules(path))
    assert not [n for n in names
                if n.split(".")[0] in ("svtyper_tpu", "jax", "jaxlib")]


@pytest.mark.parametrize("rel", COPY.COPIES)
def test_copy_differs_only_in_imports(rel):
    with open(os.path.join(PORT, rel)) as fh:
        assert fh.read() == COPY.expected(rel)


def test_copy_script_check_passes():
    assert COPY.stale() == []
    assert COPY.rewrite(
        "from svtyper_tpu.bamio import bam\n"
        "    import svtyper_tpu.simulate as s\n"
        "x = 'svtyper_tpu.simulate'\n"
        "from svtyper_tpu_torch import y\n"
    ) == (
        "from svtyper_tpu_torch.bamio import bam\n"
        "    import svtyper_tpu_torch.simulate as s\n"
        "x = 'svtyper_tpu.simulate'\n"
        "from svtyper_tpu_torch import y\n"
    )


def _columns(batch):
    cols = {k: getattr(batch, k) for k in FIELD_NAMES}
    cols.update(n=batch.n, blk_off=batch.blk_off, blk_start=batch.blk_start,
                blk_end=batch.blk_end)
    return cols


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_decoder_matches_jax_column_by_column(native):
    mine = tbam.BamFile(BAM, use_native=native)
    theirs = jbam.BamFile(BAM, use_native=native)
    assert (mine._get_native() is not None) == native
    assert (theirs._get_native() is not None) == native
    assert mine.header.refs == theirs.header.refs
    total = 0
    for name, length in mine.header.refs:
        for lo, hi in ((0, length), (length // 3, length // 3 + 5000)):
            a = _columns(mine.fetch(name, lo, hi))
            b = _columns(theirs.fetch(name, lo, hi))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            total += a["n"]
    assert total > 0


def test_native_libraries_are_separate():
    mine, theirs = tnative.get_lib(), jnative.get_lib()
    assert mine is not None and theirs is not None
    assert tnative._SO == os.path.join(
        ROOT, "build", "svtyper_tpu_torch", "libsvtbam.so")
    assert os.path.exists(tnative._SO) and tnative._SO != jnative._SO
    assert mine._handle != theirs._handle
    assert tnative.require_lib() is mine


def test_simulator_bytes_match_jax(tmp_path):
    refs = [("chr1", 400_000), ("chr2", 150_000)]
    spec = [("DEL", "chr1", 60_000, 63_000, "0/1", {}),
            ("DUP", "chr1", 200_000, 202_500, "1/1", {}),
            ("BND", "chr1", 320_000, 80_000, "0/1", {"chrom2": "chr2"})]
    out = {}
    for key, Event, SimConfig, simulate in (
        ("mine", TEvent, TSimConfig, tsimulate_events),
        ("theirs", JEvent, JSimConfig, jsimulate_events),
    ):
        d = tmp_path / key
        d.mkdir()
        events = [Event(t, c, a, b, gt, **kw) for t, c, a, b, gt, kw in spec]
        simulate(str(d / "s.bam"), refs, events, SimConfig(depth=12),
                 seed=17, extra_background=300)
        out[key] = {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}
    assert "s.bam" in out["mine"]
    assert out["mine"] == out["theirs"]


def _example(pkg):
    """(sample, variants, breakpoints, vcf) of the example through one
    package's host half."""
    if pkg == "mine":
        bam_mod, Sample, Vcf, Variant, read_lines, resolve, add_fmt = (
            tbam, TSample, TVcf, TVariant, tread_vcf_lines, tresolve,
            tadd_format_headers)
    else:
        bam_mod, Sample, Vcf, Variant, read_lines, resolve, add_fmt = (
            jbam, JSample, JVcf, JVariant, jread_vcf_lines, jresolve,
            jadd_format_headers)
    sample = Sample.from_bam(bam_mod.open_bam(BAM), num_samp=60_000)
    vcf = Vcf()
    with open(VCF) as fh:
        header, body = read_lines(fh)
        body = list(body)
    vcf.add_header(header)
    add_fmt(vcf)
    vcf.add_sample(sample.name)
    variants = [Variant(line, vcf) for line in body]
    return sample, variants, [resolve(v) for v in variants], vcf


def test_oracle_matches_jax_on_example():
    ms, _, mbps, _ = _example("mine")
    js, _, jbps, _ = _example("theirs")
    assert ms.to_json_obj() == js.to_json_obj()
    mine, theirs = TOracleEngine([ms]), JOracleEngine([js])
    called = 0
    for a, b in zip(mbps, jbps):
        if a is None:
            assert b is None
            continue
        (ra,), (rb,) = mine.genotype_variant(a), theirs.genotype_variant(b)
        assert type(ra).__slots__ == type(rb).__slots__
        assert [getattr(ra, k) for k in ra.__slots__] == [
            getattr(rb, k) for k in rb.__slots__]
        called += not ra.null
    assert called > 0


@pytest.mark.parametrize("name", ["example.vcf", "example.expected.vcf"])
def test_vcf_round_trip_matches_jax(name):
    path = os.path.join(DATA, name)
    texts = []
    for Vcf, Variant, read_lines in ((TVcf, TVariant, tread_vcf_lines),
                                     (JVcf, JVariant, jread_vcf_lines)):
        with open(path) as fh:
            header, body = read_lines(fh)
            body = list(body)
        vcf = Vcf()
        vcf.add_header(header)
        texts.append(
            (header, body, vcf.get_header(),
             [Variant(line, vcf).get_var_string() for line in body])
        )
    assert texts[0] == texts[1]
    header, body, _, lines = texts[0]
    assert body and lines == body  # the round trip itself is exact
    with open(path) as fh:
        assert tread_vcf_lines(io.StringIO(fh.read()))[0] == header


def test_version_equal():
    assert tversion.__version__ == jversion.__version__
    assert tversion.REFERENCE_VERSION == jversion.REFERENCE_VERSION
    import svtyper_tpu_torch

    assert svtyper_tpu_torch.__version__ == jversion.__version__


def test_emit_path_shares_one_gt_strings_and_format_defs():
    from svtyper_tpu_torch import output
    from svtyper_tpu_torch.cli import fast_emit
    from svtyper_tpu_torch.gt import engine
    from svtyper_tpu_torch.models import bayes

    assert fast_emit.GT_STRINGS is engine.GT_STRINGS is bayes.GT_STRINGS
    assert fast_emit.FORMAT_DEFS is output.FORMAT_DEFS
    assert engine.GenotypeResult is bayes.GenotypeResult


def _no_native(monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_failed", True)
    monkeypatch.setattr(tnative, "_why", "make exit 2: no compiler")


def test_cuda_run_refuses_pure_python_decoder(monkeypatch, tmp_path):
    _no_native(monkeypatch)
    with pytest.raises(RuntimeError, match="no compiler"):
        tnative.require_lib()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="pure-Python decoder"):
        TorchEngine([], device="cuda:0")
    with pytest.raises(RuntimeError, match="pure-Python decoder"):
        tclassic.main(["-i", VCF, "-B", BAM, "-n", "2000",
                       "-o", str(tmp_path / "o.vcf")], device="cuda:0")
    # the CPU keeps the pure-Python fallback
    assert TorchEngine([], device="cpu").n_dev == 1
