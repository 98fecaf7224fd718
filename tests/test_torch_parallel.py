"""The port's multi-device engine on the CPU: ``TorchEngine`` sharded
over repeated CPU devices against one device and against the JAX
``TpuEngine`` on conftest's 8 virtual devices, plus ``shard_slices``
against the JAX function and the dryrun.

float64: rendered VCF lines byte-identical (8 shards vs 1, and vs JAX);
float32 (the CUDA kernel's twin): the 14 integer fields identical
between 8 shards and 1.
"""

import io

import jax
import numpy as np
import pytest
import torch

from svtyper_tpu import bamio as jbamio
from svtyper_tpu import breakpoints as jbreakpoints
from svtyper_tpu import output as joutput
from svtyper_tpu import stats as jstats
from svtyper_tpu import vcfio as jvcfio
from svtyper_tpu.gt import TpuEngine
from svtyper_tpu.parallel import multihost as jmh
from svtyper_tpu_torch import bamio, breakpoints, output, stats, vcfio
from svtyper_tpu_torch.gt import engine as teng
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.parallel import multihost as tmh
from svtyper_tpu_torch.parallel.dryrun import dryrun_multichip
from svtyper_tpu_torch.simulate import (
    Event,
    SimConfig,
    events_to_vcf,
    simulate_events,
)

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_shard_slices_match_jax(n_shards):
    for n in list(range(0, 20)) + [1023, 1024, 20_500]:
        sl = tmh.shard_slices(n, n_shards)
        assert sl == jmh.shard_slices(n, n_shards)
        # contiguous, disjoint, covering [0, n): concatenating per-slice
        # rows in slice order restores input order
        assert [lo for lo, _ in sl] == [0] + [hi for _, hi in sl[:-1]]
        assert sl[-1][1] == n and len(sl) == n_shards


# a package's host half: (bamio, breakpoints, output, stats, vcfio)
PORT = (bamio, breakpoints, output, stats, vcfio)
JAX = (jbamio, jbreakpoints, joutput, jstats, jvcfio)


@pytest.fixture(scope="module")
def del13_files(tmp_path_factory):
    """tests/test_parallel.py's 13-DEL fixture (not a multiple of 8)."""
    d = tmp_path_factory.mktemp("torch_parallel")
    refs = [("chr1", 4_000_000)]
    events = [
        Event("DEL", "chr1", 300_000 + i * 250_000,
              300_000 + i * 250_000 + 1500 + 97 * i,
              ["0/0", "0/1", "1/1"][i % 3], var_id="v%d" % i)
        for i in range(13)
    ]
    bam_path = str(d / "md.bam")
    simulate_events(bam_path, refs, events, SimConfig(depth=30), seed=9,
                    extra_background=1000)
    return bam_path, events_to_vcf(events, refs)


def _load(files, pkg):
    bam_path, vcf_text = files
    bamio_, _, output_, stats_, vcfio_ = pkg
    sample = stats_.Sample.from_bam(bamio_.BamFile(bam_path), num_samp=50_000)
    vcf = vcfio_.Vcf()
    header, body = vcfio_.read_vcf_lines(io.StringIO(vcf_text))
    vcf.add_header(header)
    output_.add_format_headers(vcf)
    vcf.add_sample(sample.name)
    return sample, vcf, list(body)


@pytest.fixture(scope="module")
def del13(del13_files):
    return _load(del13_files, PORT)


@pytest.fixture(scope="module")
def jax_del13(del13_files):
    return _load(del13_files, JAX)


def _render(sample, vcf, body, rows, pkg=PORT):
    out = []
    for line, row in zip(body, rows):
        v = pkg[4].Variant(line, vcf)
        pkg[2].apply_variant(v, [sample.name], row)
        out.append(v.get_var_string())
    return "\n".join(out)


def _bps(vcf, body, pkg=PORT):
    return [pkg[1].resolve_breakpoint(pkg[4].Variant(line, vcf))
            for line in body]


def _raw(engine, bps):
    return np.concatenate(
        [a[0][:n] for n, a in engine.genotype_stream(bps, raw=True)]
    )


def test_engine_8_shards_byte_identical_f64(del13, jax_del13):
    sample, vcf, body = del13
    bps = _bps(vcf, body)
    multi = TorchEngine([sample], chunk_size=8, devices=CPU8)
    single = TorchEngine([sample], chunk_size=8, device="cpu")
    assert multi.n_dev == 8 and single.n_dev == 1
    rows_m = multi.genotype_all(bps)
    rows_s = single.genotype_all(bps)
    assert multi.stats["chunks"] == single.stats["chunks"] == 2
    got = _render(sample, vcf, body, rows_m)
    assert got == _render(sample, vcf, body, rows_s)
    assert sum(1 for r in rows_m if not r[0].null) == len(bps)

    assert len(jax.devices()) == 8  # conftest virtual mesh
    jsample, jvcf, jbody = jax_del13
    jeng = TpuEngine([jsample], chunk_size=8)
    assert jeng.n_dev == 8
    assert got == _render(jsample, jvcf, jbody,
                          jeng.genotype_all(_bps(jvcf, jbody, JAX)), JAX)


def test_engine_8_shards_f32_int_fields(del13):
    sample, vcf, body = del13
    bps = _bps(vcf, body)
    a = _raw(TorchEngine([sample], chunk_size=8, devices=CPU8,
                         dtype=torch.float32), bps)
    b = _raw(TorchEngine([sample], chunk_size=8, device="cpu",
                         dtype=torch.float32), bps)
    assert a.dtype == np.float32 and a.shape == (13, teng.ROW_WIDTH)
    np.testing.assert_array_equal(a[:, : teng._NI], b[:, : teng._NI])


def test_chunk_rounding_and_device_arguments(del13):
    sample, _vcf, _body = del13
    assert TorchEngine([sample], chunk_size=13, devices=CPU8).chunk_size == 16
    assert TorchEngine([sample], chunk_size=13, device="cpu").chunk_size == 13
    with pytest.raises(ValueError, match="not both"):
        TorchEngine([sample], device="cpu", devices=CPU8)
    with pytest.raises(ValueError, match="no devices"):
        TorchEngine([sample], devices=[])


def test_one_device_list_matches_device(del13):
    """``devices=[cpu]`` (the sharded path with one shard) is the
    ``device=cpu`` engine: same chunking, same rows."""
    sample, vcf, body = del13
    bps = _bps(vcf, body)
    listed = TorchEngine([sample], chunk_size=8, devices=["cpu"])
    one = TorchEngine([sample], chunk_size=8, device="cpu")
    assert listed.n_dev == one.n_dev == 1
    assert listed.chunk_size == one.chunk_size == 8
    np.testing.assert_array_equal(_raw(listed, bps), _raw(one, bps))
    assert listed.stats["chunks"] == one.stats["chunks"] == 2
    assert listed.stats["gl_launches"] == one.stats["gl_launches"] == 0


def test_two_samples_sharded_match_single_device(del13):
    """Two samples in a 4-shard engine (the prep pool fans the sharded
    prep out per sample) give each sample its one-device rows."""
    sample, vcf, body = del13
    bps = _bps(vcf, body)
    with TorchEngine([sample, sample], chunk_size=8,
                     devices=["cpu"] * 4) as both:
        chunks = list(both.genotype_stream(bps, raw=True))
    alone = _raw(TorchEngine([sample], chunk_size=8, device="cpu"), bps)
    for s in range(2):
        got = np.concatenate([a[s][:n] for n, a in chunks])
        np.testing.assert_array_equal(got, alone)


@pytest.mark.parametrize("n_devices", [8, 4])
def test_dryrun_multichip(n_devices, capsys):
    dryrun_multichip(n_devices, "cpu")
    assert "%d x cpu ok" % n_devices in capsys.readouterr().out
