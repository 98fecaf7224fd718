"""The port's multi-device paths on the CPU: ``TorchEngine`` sharded
over repeated CPU devices against one device and against the JAX
``TpuEngine`` on conftest's 8 virtual devices; the full-column
``make_sharded_step`` against the JAX one and against per-shard
recomputation; ``shard_slices`` and ``merge_ordered`` against the JAX
functions; ``make_mesh``'s refusal to fall back to the CPU; ``entry()``
against ``__graft_entry__.entry``; and the dryrun.

float64: rendered VCF lines byte-identical (8 shards vs 1, and vs JAX);
the sharded step's ``gt_idx`` exact and ``gl`` within rtol=1e-12 of
JAX's, as ``tests/test_parallel.py`` holds JAX's to its local result.
float32 (the CUDA kernel's twin): the 14 integer fields identical
between 8 shards and 1; ``entry()``'s counts exact against JAX's, its
GL/SQ/AB at output-format precision (the twin's lgamma against JAX's
log-choose table).
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
from svtyper_tpu.ops.gl import log_choose_table as jax_log_choose_table
from svtyper_tpu.parallel import make_mesh as jax_make_mesh
from svtyper_tpu.parallel import make_sharded_step as jax_make_sharded_step
from svtyper_tpu.parallel import multihost as jmh
from svtyper_tpu_torch import bamio, breakpoints, output, stats, vcfio
from svtyper_tpu_torch.gt import engine as teng
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.ops import gl_kernel
from svtyper_tpu_torch.parallel import mesh as tmesh
from svtyper_tpu_torch.parallel import multihost as tmh
from svtyper_tpu_torch.parallel import (
    make_mesh,
    make_sharded_step,
    merge_ordered,
    shard_slices,
    stack_shards,
)
from svtyper_tpu_torch.parallel.dryrun import dryrun_multichip, entry
from svtyper_tpu_torch.parallel.synth import make_synthetic_chunk
from svtyper_tpu_torch.utils.parity import assert_format_parity
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


def test_merge_ordered_matches_jax():
    sl = shard_slices(10, 3)
    rows = [np.arange(lo, hi) for lo, hi in sl]
    merged = merge_ordered(rows, sl)
    assert merged.tolist() == list(range(10))
    np.testing.assert_array_equal(merged, jmh.merge_ordered(rows, sl))
    wide = [np.stack([r, -r], axis=1) for r in rows]
    np.testing.assert_array_equal(merge_ordered(wide, sl),
                                  jmh.merge_ordered(wide, sl))
    assert merge_ordered([], []).shape == jmh.merge_ordered([], []).shape
    for bad_rows, bad_sl in (([rows[1], rows[0], rows[2]], sl),
                             ([rows[0][:-1]] + rows[1:], sl)):
        for fn in (merge_ordered, jmh.merge_ordered):
            with pytest.raises(AssertionError):
                fn(bad_rows, bad_sl)


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    assert make_mesh(devices=CPU8) == [torch.device("cpu")] * 8
    assert make_mesh(4, devices=CPU8) == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        make_mesh(9, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(2)
    # one card where two are asked for: an error, not a CPU mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh() == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2)


def _shards(n_dev, n_var=8):
    """tests/test_parallel.py's shards: equal pad sizes, 2-4 fragments
    per variant."""
    chunks = [make_synthetic_chunk(n_var=n_var, frags_per_var=2 + i % 3)
              for i in range(n_dev)]
    return [c for c, _ in chunks], chunks[0][1]


def _local(chunk, dens, dtype):
    """One shard recomputed alone, rows taken as unsorted."""
    return tmesh.genotype_step(
        {k: torch.as_tensor(v) for k, v in chunk.reads.items()},
        {k: torch.as_tensor(v) for k, v in chunk.pairs.items()},
        {k: torch.as_tensor(np.asarray(v)) for k, v in chunk.variants.items()},
        torch.as_tensor(dens, dtype=dtype), chunk.n_var,
    )


def test_sharded_step_matches_jax_and_local():
    n_dev, n_var = 8, 8
    shards, dens = _shards(n_dev, n_var)
    stacked = stack_shards(shards)
    dens_stack = np.stack([dens] * n_dev)
    step = make_sharded_step(make_mesh(devices=CPU8), n_var)
    out = step(stacked["reads"], stacked["pairs"], stacked["variants"],
               dens_stack)
    assert out["gt_idx"].shape == (n_dev, n_var)
    assert out["gl"].dtype == torch.float64

    assert len(jax.devices()) == 8  # conftest virtual mesh
    jstep = jax_make_sharded_step(jax_make_mesh(n_dev), n_var,
                                  dtype=jax.numpy.float64)
    want = jax.device_get(jstep(
        stacked["reads"], stacked["pairs"], stacked["variants"],
        jax.numpy.asarray(dens_stack),
        jax.numpy.asarray(jax_log_choose_table(1 << 12, use_f64=True)),
    ))
    assert set(out) == set(want)
    np.testing.assert_array_equal(out["gt_idx"].numpy(), want["gt_idx"])
    np.testing.assert_allclose(out["gl"].numpy(), want["gl"], rtol=1e-12)
    np.testing.assert_array_equal(out["counts"].numpy(), want["counts"])

    for d, chunk in enumerate(shards):
        local = _local(chunk, dens, torch.float64)
        for k in local:
            np.testing.assert_array_equal(out[k][d].numpy(),
                                          local[k].numpy(), err_msg=k)


def test_sharded_step_f32_int_fields_match_the_twin_per_shard():
    n_dev, n_var = 4, 8
    shards, dens = _shards(n_dev, n_var)
    stacked = stack_shards(shards)
    step = make_sharded_step(["cpu"] * n_dev, n_var, dtype=torch.float32)
    before = gl_kernel.LAUNCHES
    out = step(stacked["reads"], stacked["pairs"], stacked["variants"],
               np.stack([dens] * n_dev))
    assert gl_kernel.LAUNCHES == before  # the CPU runs the twin
    assert out["counts"].dtype == torch.float32
    for d, chunk in enumerate(shards):
        local = _local(chunk, dens, torch.float32)
        for k in teng.INT_FIELDS + ("counts",):
            np.testing.assert_array_equal(out[k][d].numpy(),
                                          local[k].numpy(), err_msg=k)


def test_sharded_step_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(ValueError, match="no devices"):
        make_sharded_step([], 8)
    shards, dens = _shards(2)
    stacked = stack_shards(shards)
    step = make_sharded_step(CPU8[:3], 8)
    with pytest.raises(ValueError, match="leading axis"):
        step(stacked["reads"], stacked["pairs"], stacked["variants"],
             np.stack([dens] * 2))
    with pytest.raises(RuntimeError, match="is_available"):
        make_sharded_step(["cuda:0"], 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="float32"):
        make_sharded_step(["cuda:0"], 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="one kind"):
        make_sharded_step(["cuda:0", "cpu"], 8, dtype=torch.float32)


def test_entry_matches_graft_entry():
    import __graft_entry__ as g

    fn, args = g.entry()
    want = jax.device_get(jax.jit(fn)(*args))
    step, targs = entry(device="cpu")
    assert all(t.device.type == "cpu" for d in targs[:3] for t in d.values())
    before = gl_kernel.LAUNCHES
    got = {k: v.numpy() for k, v in step(*targs).items()}
    assert gl_kernel.LAUNCHES == before
    assert set(got) == set(want)
    assert got["gt_idx"].shape == (64,) and not got["null"].any()
    np.testing.assert_array_equal(got["counts"], want["counts"])
    for k in ("gt_idx", "qr", "qa", "dp", "ro", "ao", "rs", "as_", "asc",
              "rp", "ap", "ab_valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ints = np.stack([got[k].astype(np.int64) for k in teng.INT_FIELDS])
    flts = np.concatenate([got["gl"].T, got["sq"][None], got["ab"][None],
                           got["counts"].T])
    assert_format_parity(want, ints, flts, 64, min_checked=64)


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        entry()


@pytest.mark.cuda
def test_entry_on_card():
    """entry() on the card: every variant called, counts and int fields
    equal to the twin's on the CPU, one GL kernel launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    step, args = entry()
    assert args[3].device.type == "cuda"
    before = gl_kernel.LAUNCHES
    got = {k: v.cpu().numpy() for k, v in step(*args).items()}
    assert gl_kernel.LAUNCHES == before + 1
    cstep, cargs = entry(device="cpu")
    want = {k: v.numpy() for k, v in cstep(*cargs).items()}
    assert not got["null"].any()
    np.testing.assert_array_equal(got["counts"], want["counts"])
    for k in teng.INT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
