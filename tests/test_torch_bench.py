"""The port's bench (``svtyper_tpu_torch/tools/bench.py``) on the CPU at
tiny sizes, against ``bench.py`` and the JAX package.

- the three fixture builders and the tiled CLI VCF write what bench.py's
  write, byte for byte (bench.py imported from the repo root, its
  module globals and ``SVT_BENCH_*`` environment set to the same sizes);
- ``main(device="cpu")`` prints one JSON line holding every key of
  bench.py's line (``BENCH_r05.json``'s ``parsed`` block);
- its main, BND and two-sample concordances equal those of the JAX
  ``OracleEngine``'s GTs on the same fixtures;
- concordance floors above 1.0 exit 3, the JSON line still printed with
  ``accuracy_degraded`` set;
- no CUDA and no device named: exit 1, nothing printed;
- a CLI run that exits non-zero, or times out, fails the bench;
- the knobs' precedence and the cold-pass check.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest
import torch

from svtyper_tpu.bamio.bam import BamFile as JBamFile
from svtyper_tpu.breakpoints import BndRegistry as JBndRegistry
from svtyper_tpu.breakpoints import resolve_breakpoint as jresolve
from svtyper_tpu.oracle import OracleEngine as JOracleEngine
from svtyper_tpu.stats import Sample as JSample
from svtyper_tpu.vcfio.model import Variant as JVariant
from svtyper_tpu.vcfio.model import Vcf as JVcf
from svtyper_tpu.vcfio.reader import read_vcf_lines as jread_vcf_lines
from svtyper_tpu_torch.tools import bench as tbench
from svtyper_tpu_torch.tools import common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, DEPTH, BND, MS, CLI = 48, 10.0, 30, 24, 96
SIZES = {
    "SVT_BENCH_VARIANTS": str(N), "SVT_BENCH_DEPTH": str(DEPTH),
    "SVT_BENCH_BND_EVENTS": str(BND), "SVT_BENCH_MS_VARIANTS": str(MS),
    "SVT_BENCH_CHUNK": "16", "SVT_BENCH_ORACLE_N": "8",
    "SVT_BENCH_CLI_VARIANTS": str(CLI),
}
FLOORS = {"SVT_BENCH_CONC_FLOOR": "1.01", "SVT_BENCH_BND_CONC_FLOOR": "1.01"}
MAIN = "bench_v3_n%d_d%g" % (N, DEPTH)
BND_TAG = "bench_bnd_n%d_d%g" % (BND, DEPTH)
MS_TAG = "bench_ms_n%d_d%g" % (MS, DEPTH)
FILES = (
    [MAIN + s for s in (".bam", ".bam.bai", ".vcf", ".vcf.truth.json")]
    + [BND_TAG + s for s in (".bam", ".bam.bai", ".vcf")]
    + ["%s_%s%s" % (MS_TAG, x, s) for x in "AB" for s in (".bam", ".bam.bai")]
    + [MS_TAG + ".vcf"]
)


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main(cache, env):
    """``bench.main([], device="cpu")`` under ``env`` → (exit code,
    stdout lines, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(SIZES, SVT_BENCH_CACHE=cache, **env).items():
            mp.setenv(k, v)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = tbench.main([], device="cpu")
    return rc, out.getvalue().splitlines(), err.getvalue()


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """One tiny run with the floors above 1.0 → (cache, exit code,
    stdout lines)."""
    cache = str(tmp_path_factory.mktemp("torch_bench"))
    rc, lines, _ = _main(cache, FLOORS)
    return cache, rc, lines


@pytest.fixture(scope="module")
def result(bench_run):
    return json.loads(bench_run[2][-1])


@pytest.fixture(scope="module")
def jax_fixtures(tmp_path_factory):
    """bench.py's three builders at the same sizes → (dir, bnd truth, ms
    truth)."""
    d = str(tmp_path_factory.mktemp("jax_bench"))
    jb = _jax_bench()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "N_VARIANTS", N)
        mp.setattr(jb, "DEPTH", DEPTH)
        mp.setattr(jb, "CACHE", d)
        for k, v in SIZES.items():
            mp.setenv(k, v)
        jb.build_fixture()
        _, _, bnd_truth = jb.build_bnd_fixture()
        _, _, ms_truth = jb.build_ms_fixture()
    jb.tile_vcf(os.path.join(d, MAIN + ".vcf"), os.path.join(d, "tiled.vcf"),
                CLI, "cli")
    return d, bnd_truth, ms_truth


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name", FILES)
def test_fixture_bytes_match_bench_py(name, bench_run, jax_fixtures):
    assert _bytes(os.path.join(bench_run[0], name)) \
        == _bytes(os.path.join(jax_fixtures[0], name))


def test_truths_and_tiled_vcf_match_bench_py(bench_run, jax_fixtures):
    cache = bench_run[0]
    d, bnd_truth, ms_truth = jax_fixtures
    assert tbench.build_bnd_fixture(cache, BND, DEPTH)[2] == bnd_truth
    assert tbench.build_ms_fixture(cache, MS, DEPTH)[2] == ms_truth
    assert _bytes(os.path.join(cache, "%s_cli%d.vcf" % (MAIN, CLI))) \
        == _bytes(os.path.join(d, "tiled.vcf"))
    # every BAM's fine-index sidecar was written with its fixture
    for name in FILES:
        if name.endswith(".bam"):
            assert os.path.exists(os.path.join(cache, name + ".fidx.npz"))


def test_json_line_has_every_bench_py_key(bench_run, result):
    _, rc, lines = bench_run
    assert len(lines) == 1
    with open(os.path.join(ROOT, "BENCH_r05.json")) as fh:
        want = set(json.load(fh)["parsed"])
    assert want <= set(result), sorted(want - set(result))
    assert result["device"] == "cpu" and result["shards"] == 1
    assert result["n_measured"] == N and result["n_cold"] == N - 16
    assert result["bnd_n_records"] == BND + BND // 3  # each BND two records
    assert result["cli_n_variants"] == CLI and result["cli_runs"] == 1
    # no GL kernel on the CPU's float64 path; chunks as the sizes ask
    assert [p["chunks"] for p in result["engine_passes"]] \
        == [1, 1, 2, 3, 3, 3, 3, 2, 2, 2]
    assert not any(p["gl_launches"] for p in result["engine_passes"])


def _jax_samples(paths):
    return [JSample.from_bam(JBamFile(p), num_samp=tbench.NUM_SAMP)
            for p in paths]


def _jax_variants(path):
    v = JVcf()
    with open(path) as fh:
        header, body = jread_vcf_lines(fh)
        body = list(body)
    v.add_header(header)
    return [JVariant(line, v) for line in body], body


def _gt(r):
    return r.gt_string if not r.null else "./."


def test_concordances_equal_the_jax_oracle(bench_run, result, jax_fixtures):
    cache = bench_run[0]
    _, bnd_truth, ms_truth = jax_fixtures

    def at(name):
        return os.path.join(cache, name)

    with open(at(MAIN + ".vcf.truth.json")) as fh:
        truth = json.load(fh)
    oracle = JOracleEngine(_jax_samples([at(MAIN + ".bam")]))
    variants, _ = _jax_variants(at(MAIN + ".vcf"))
    hits = [_gt(oracle.genotype_variant(jresolve(v))[0]) == truth[v.var_id]
            for v in variants]
    assert result["gt_concordance"] == sum(hits) / len(hits)

    # a mate record resolves to its anchor's breakpoint, so genotyping
    # each record's breakpoint is the bench's anchor-and-copy
    oracle = JOracleEngine(_jax_samples([at(BND_TAG + ".bam")]))
    variants, body = _jax_variants(at(BND_TAG + ".vcf"))
    registry = JBndRegistry()
    registry.scan(body)
    hits = []
    for v in variants:
        bp = registry.resolve(v)
        if bp is not None and v.var_id in bnd_truth:
            hits.append(_gt(oracle.genotype_variant(bp)[0])
                        == bnd_truth[v.var_id])
    assert len(hits) == result["bnd_n_records"]
    assert result["bnd_concordance"] == sum(hits) / len(hits)

    oracle = JOracleEngine(_jax_samples(
        [at("%s_%s.bam" % (MS_TAG, x)) for x in "AB"]))
    variants, _ = _jax_variants(at(MS_TAG + ".vcf"))
    hits = []
    for v in variants:
        rows = oracle.genotype_variant(jresolve(v))
        hits += [_gt(rows[s]) == ms_truth[s][v.var_id] for s in (0, 1)]
    assert len(hits) == 2 * MS
    assert result["multisample_concordance"] == sum(hits) / len(hits)


def test_floors_above_one_exit_3_with_the_json(bench_run, result):
    assert bench_run[1] == 3
    assert [d.split()[0] for d in result["accuracy_degraded"]] \
        == ["main", "bnd", "multisample"]


def test_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_failed_cli_run_fails_the_bench(bench_run, monkeypatch):
    monkeypatch.setattr(tbench, "_CLI_CHILD", 'import sys; '
                        'sys.stderr.write("boom on " + %r); sys.exit(7)')
    rc, lines, err = _main(bench_run[0], {})
    assert rc == 1 and lines == []
    assert "CLI row: run 1 exited 7" in err and "boom on cpu" in err


def test_cli_run_timing_out_fails_the_row(bench_run, monkeypatch):
    cache = bench_run[0]
    monkeypatch.setattr(tbench, "_CLI_CHILD",
                        "import time; time.sleep(60)  # %r")
    with pytest.raises(common.ToolError, match="run 1 timed out after 1 s"):
        tbench.cli_row(os.path.join(cache, MAIN + ".bam"),
                       os.path.join(cache, MAIN + ".vcf"), CLI, 16, "cpu", 1,
                       cache)


def test_knobs_precedence(monkeypatch):
    for k in list(os.environ):
        if k.startswith("SVT_BENCH_"):
            monkeypatch.delenv(k)
    k = tbench.knobs()
    assert (k["n_variants"], k["depth"], k["oracle_n"], k["bnd_events"],
            k["ms_variants"], k["chunk"], k["cli_variants"], k["conc_floor"],
            k["bnd_conc_floor"], k["timeout"]) \
        == (9600, 30.0, 48, 1500, 2400, 1024, 96000, 0.97, 0.93, 900)
    assert k["cache"] == os.path.join(ROOT, "build", "bench")
    monkeypatch.setenv("SVT_BENCH_MIN_MEASURED", "500")
    assert tbench.knobs()["n_variants"] == 500
    monkeypatch.setenv("SVT_BENCH_VARIANTS", "700")
    assert tbench.knobs()["n_variants"] == 700
    assert tbench.knobs(n_variants=9)["n_variants"] == 9
    with pytest.raises(TypeError, match="unknown bench knobs"):
        tbench.knobs(variants=9)


@pytest.mark.parametrize("perf, ok", [
    ({"inflate_bytes": 1_376_311_713, "blocks": 21_000, "cache_hits": 76},
     True),
    ({"inflate_bytes": 0, "blocks": 0, "cache_hits": 68}, False),
    ({"inflate_bytes": 10_000_000, "blocks": 150, "cache_hits": 15}, False),
])
def test_cold_pass_check(perf, ok):
    if ok:
        tbench.check_cold(perf)
    else:
        with pytest.raises(common.ToolError, match="cold pass"):
            tbench.check_cold(perf)
