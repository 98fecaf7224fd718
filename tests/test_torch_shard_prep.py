"""Concurrent shard prep in ``TorchEngine`` on the CPU.

With several devices (here ``devices=["cpu"] * n``) the shards of each
sample's chunk are prepped concurrently over the engine's prep pool,
shard 0 on the sample's BAM handle and shard d ≥ 1 on a second handle of
the same file that shares the parsed indexes. These tests hold:

- the rows, float64 and float32, byte-identical across 1, 3 and 4
  shards, concurrent against serial prep (same wires, same padding), two
  samples over 3 shards against each alone, and the float64 VCF lines
  of 4 shards against the JAX ``TpuEngine``;
- the shards' fetches really in flight together (a barrier that every
  shard's fetch must reach), each shard on its own handle with its own
  windows, the indexes shared and not rebuilt;
- ``close()`` and a dropped engine freeing the extra handles, the
  engine working again after ``close()``, and a one-device engine
  opening no handle and no pool (two samples on its one handle fetching
  in turn);
- ``_reopen``'s use of ``BamFile``'s private index fields, pinned;
- ``--cores N`` keeping handles × N decode threads within the usable
  cores, and the handles opened following the pool's width;
- ``-w`` evidence over 4 concurrent shards equal to one device's;
- a CRAM sample and a sample on the pure-Python decoder staying on
  their one handle, prepped serially, with the same rows.
"""

import gc
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from svtyper_tpu import bamio as jbamio
from svtyper_tpu import breakpoints as jbreakpoints
from svtyper_tpu import output as joutput
from svtyper_tpu import stats as jstats
from svtyper_tpu import vcfio as jvcfio
from svtyper_tpu.gt import TpuEngine
from svtyper_tpu_torch import bamio, breakpoints, output, stats, vcfio
from svtyper_tpu_torch.bamio import native
from svtyper_tpu_torch.bamio.bam import BamFile
from svtyper_tpu_torch.bamio.cram import CramFile
from svtyper_tpu_torch.bamio.cram_writer import bam_to_cram
from svtyper_tpu_torch.breakpoints import fetch_windows
from svtyper_tpu_torch.cli import classic as tclassic
from svtyper_tpu_torch.evidence.extract import prepare_compact_chunk
from svtyper_tpu_torch.gt import engine as teng
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.oracle.engine import Z_FLANK
from svtyper_tpu_torch.simulate import (
    Event,
    SimConfig,
    events_to_vcf,
    simulate_events,
)
from svtyper_tpu_torch.stats import Sample

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="the native BAM decoder did not build"
)

CHUNK = 12
N_EVENTS = 22
REFS = [("chr1", 6_000_000)]
PORT = (bamio, breakpoints, output, stats, vcfio)
JAX = (jbamio, jbreakpoints, joutput, jstats, jvcfio)


def _events(shift: int):
    return [
        Event("DEL", "chr1", 200_000 + i * 250_000 + shift,
              200_000 + i * 250_000 + shift + 900 + 113 * i,
              ["0/0", "0/1", "1/1"][(i + shift) % 3], var_id="d%d" % i)
        for i in range(N_EVENTS)
    ]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two samples' BAMs over the same 22 DELs (genotypes differ), the
    VCF, and the first BAM as CRAM."""
    d = tmp_path_factory.mktemp("shard_prep")
    bams = []
    for k in range(2):
        path = str(d / ("s%d.bam" % k))
        simulate_events(path, REFS, _events(k), SimConfig(depth=20),
                        seed=31 + k, extra_background=800)
        bams.append(path)
    vcf = str(d / "in.vcf")
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(_events(0), REFS))
    cram = str(d / "s0.cram")
    bam_to_cram(bams[0], cram)
    return d, bams, vcf, cram


def _sample(path, pkg=PORT, **kw):
    bamio_, stats_ = pkg[0], pkg[3]
    return stats_.Sample.from_bam(bamio_.open_bam(path, **kw),
                                  num_samp=50_000)


def _body(vcf_path, pkg=PORT):
    vcf = pkg[4].Vcf()
    with open(vcf_path) as fh:
        header, body = pkg[4].read_vcf_lines(fh)
        body = list(body)
    vcf.add_header(header)
    pkg[2].add_format_headers(vcf)
    return vcf, body


def _bps(vcf_path, pkg=PORT):
    vcf, body = _body(vcf_path, pkg)
    return [pkg[1].resolve_breakpoint(pkg[4].Variant(line, vcf))
            for line in body]


def _raw(engine, bps):
    """Every sample's packed rows, ``[n_samples, n_var, 24]``."""
    chunks = list(engine.genotype_stream(bps, raw=True))
    return np.stack([
        np.concatenate([a[s][:n] for n, a in chunks])
        for s in range(len(engine.samples))
    ])


def _engine(samples, shards, **kw):
    """``shards`` CPU devices; the prep pool has a worker per shard, so
    the shards can fetch together whatever the host's core count."""
    return TorchEngine(samples, chunk_size=CHUNK, devices=["cpu"] * shards,
                       prep_workers=len(samples) * shards, **kw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_rows_byte_identical_across_1_3_4_shards(files, dtype):
    _, bams, vcf, _ = files
    sample, bps = _sample(bams[0]), _bps(vcf)
    rows = {}
    for shards in (1, 3, 4):
        with _engine([sample], shards, dtype=dtype) as eng:
            rows[shards] = _raw(eng, bps)
            assert eng.stats["chunks"] == -(-N_EVENTS // eng.chunk_size)
    assert rows[1].dtype == (np.float64 if dtype == torch.float64
                             else np.float32)
    assert rows[1].shape == (1, N_EVENTS, teng.ROW_WIDTH)
    assert (rows[1][0, :, 0] == 0).sum() > N_EVENTS // 2  # most called
    for shards in (3, 4):
        assert rows[shards].tobytes() == rows[1].tobytes(), shards


def test_four_concurrent_shards_match_the_jax_engine(files):
    """The rendered float64 lines of 4 concurrent shards against the JAX
    ``TpuEngine`` on conftest's 8 virtual devices, as
    ``tests/test_torch_parallel.py`` holds 8 serial shards."""
    _, bams, vcf, _ = files
    sample = _sample(bams[0])
    vcf_t, body = _body(vcf)
    vcf_t.add_sample(sample.name)
    with _engine([sample], 4) as eng:
        rows = eng.genotype_all(_bps(vcf))
    jsample = _sample(bams[0], JAX)
    jvcf, jbody = _body(vcf, JAX)
    jvcf.add_sample(jsample.name)
    jrows = TpuEngine([jsample], chunk_size=8).genotype_all(_bps(vcf, JAX))

    def render(pkg, smp, v, b, rs):
        out = []
        for line, row in zip(b, rs):
            var = pkg[4].Variant(line, v)
            pkg[2].apply_variant(var, [smp.name], row)
            out.append(var.get_var_string())
        return "\n".join(out)

    assert render(PORT, sample, vcf_t, body, rows) == render(
        JAX, jsample, jvcf, jbody, jrows)


def test_concurrent_prep_gives_the_serial_wires(files):
    """Per chunk, the wires of 4 concurrent shards equal those of the
    same shards prepped one at a time (one pool worker): the same
    padding, since every shard reads the high-water buckets before the
    chunk updates them."""
    _, bams, vcf, _ = files
    bps = _bps(vcf)
    wires = {}
    for workers in (1, 4):
        eng = TorchEngine([_sample(bams[0])], chunk_size=CHUNK,
                          devices=["cpu"] * 4, prep_workers=workers)
        wires[workers] = [eng._prepare(bps[lo:lo + CHUNK])
                          for lo in range(0, N_EVENTS, CHUNK)]
        eng.close()
    for a, b in zip(wires[1], wires[4]):
        ((shards_a,), (shards_b,)) = a, b
        assert len(shards_a) == len(shards_b) == 4
        for ((_, ca), na), ((_, cb), nb) in zip(shards_a, shards_b):
            assert na == nb and ca.keys() == cb.keys()
            for k in ca:
                assert ca[k].dtype == cb[k].dtype
                np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)


def _wrap_fetches(handles, before=None):
    """Wraps each handle's ``fetch_chunk`` → a list of ``(handle index,
    regions, start, end)`` per call; ``before(k)`` runs inside the
    wrapper before the fetch."""
    calls, lock = [], threading.Lock()
    for k, h in enumerate(handles):
        def fetch(regions, *a, _k=k, _fn=h.fetch_chunk, **kw):
            t0 = time.perf_counter()
            if before is not None:
                before(_k)
            try:
                return _fn(regions, *a, **kw)
            finally:
                with lock:
                    calls.append((_k, list(regions), t0,
                                  time.perf_counter()))
        h.fetch_chunk = fetch
    return calls


def test_shard_fetches_are_in_flight_together(files):
    """Every shard's fetch must reach a barrier of 4 before any fetches:
    serial prep would time the barrier out."""
    _, bams, vcf, _ = files
    bps = _bps(vcf)
    with _engine([_sample(bams[0])], 4) as eng:
        (handles,) = eng.shard_bams()
        barrier = threading.Barrier(4, timeout=30)
        calls = _wrap_fetches(handles, lambda _k: barrier.wait())
        eng.genotype_all(bps)
    n_chunks = -(-N_EVENTS // CHUNK)
    assert len(calls) == 4 * n_chunks
    for c in range(n_chunks):
        spans = sorted(calls, key=lambda t: t[2])[4 * c:4 * c + 4]
        assert sorted(k for k, *_ in spans) == [0, 1, 2, 3]
        # all four were in flight at the latest start
        latest = max(t0 for *_, t0, _ in spans)
        assert all(t1 >= latest for *_, t1 in spans)


def test_each_shard_fetches_its_windows_on_its_own_handle(files):
    _, bams, vcf, _ = files
    sample, bps = _sample(bams[0]), _bps(vcf)
    with _engine([sample], 3) as eng:
        (handles,) = eng.shard_bams()
        assert handles[0] is sample.bam
        assert len({id(h) for h in handles}) == 3
        assert all(isinstance(h, BamFile) for h in handles)
        assert all(h.path == sample.bam.path for h in handles)
        assert all(h._threads == sample.bam._threads for h in handles)
        calls = _wrap_fetches(handles)
        eng.genotype_all(bps)
        assert eng.shard_bams() == [handles]  # opened once
    n = eng.chunk_size // 3
    flank = sample.get_fetch_flank(Z_FLANK)
    want = {}
    for lo in range(0, N_EVENTS, eng.chunk_size):
        for d in range(3):
            for bp in bps[lo + d * n:lo + (d + 1) * n]:
                want.setdefault(d, []).extend(fetch_windows(bp, flank))
    got = {}
    for k, regions, _, _ in sorted(calls, key=lambda t: t[2]):
        got.setdefault(k, []).extend(regions)
    assert got == want


def test_shard_handles_share_the_parsed_indexes(files, monkeypatch):
    """The extra handles take the sample handle's fine index and BAI
    objects; none builds a fine index, even with no sidecar on disk."""
    _, bams, vcf, _ = files
    sample = _sample(bams[0])
    fine = sample.bam._get_fineidx()
    bai = sample.bam.bai
    assert fine is not None
    os.unlink(bams[0] + ".fidx.npz")
    built = []
    real = native.NativeBam.build_fineidx
    monkeypatch.setattr(native.NativeBam, "build_fineidx",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    with _engine([sample], 4) as eng:
        eng.genotype_all(_bps(vcf))
        (handles,) = eng.shard_bams()
    assert built == []
    for h in handles:
        assert h._fineidx is fine and h._bai is bai


def test_close_frees_the_shard_handles_and_the_engine_reopens(files):
    _, bams, vcf, _ = files
    sample, bps = _sample(bams[0]), _bps(vcf)
    eng = _engine([sample], 4)
    first = _raw(eng, bps)
    (handles,) = eng.shard_bams()
    refs = [weakref.ref(h) for h in handles[1:]]
    arenas = [weakref.ref(h._native) for h in handles[1:]]
    del handles
    eng.close()
    assert eng._prep_pool is None and eng._views is None
    assert all(r() is None for r in refs + arenas)
    assert sample.bam._native is not None  # the sample's handle stays
    again = _raw(eng, bps)
    assert again.tobytes() == first.tobytes()
    (reopened,) = eng.shard_bams()
    assert reopened[0] is sample.bam and len({id(h) for h in reopened}) == 4
    eng.close()
    eng.close()  # idempotent


def test_a_dropped_engine_frees_its_shard_handles(files):
    _, bams, vcf, _ = files
    eng = _engine([_sample(bams[0])], 3)
    eng.genotype_all(_bps(vcf))
    refs = [weakref.ref(h) for h in eng.shard_bams()[0][1:]]
    del eng
    gc.collect()
    assert all(r() is None for r in refs)


def test_one_device_engine_opens_no_handle_and_no_pool(files, monkeypatch):
    _, bams, vcf, _ = files
    sample, bps = _sample(bams[0]), _bps(vcf)
    opened = []
    real = BamFile.__init__
    monkeypatch.setattr(BamFile, "__init__",
                        lambda self, *a, **k: opened.append(a)
                        or real(self, *a, **k))
    for kw in ({"device": "cpu"}, {"devices": ["cpu"]}):
        eng = TorchEngine([sample], chunk_size=CHUNK, **kw)
        eng.genotype_all(bps)
        assert eng._prep_pool is None
        assert eng.shard_bams() == [[sample.bam]]
    assert opened == []


def test_one_device_two_samples_on_one_handle_fetch_in_turn(files):
    """One device, ``[sample, sample]``: both samples fetch on the one
    handle, so they run one after the other in one job (no pool, even
    with two workers asked for), each with the rows of the sample
    alone."""
    _, bams, vcf, _ = files
    sample, bps = _sample(bams[0]), _bps(vcf)
    with TorchEngine([sample, sample], chunk_size=CHUNK, device="cpu",
                     prep_workers=2) as eng:
        calls = _wrap_fetches([sample.bam])
        both = _raw(eng, bps)
        assert eng._prep_pool is None
    spans = sorted((t0, t1) for _, _, t0, t1 in calls)
    assert len(spans) == 2 * -(-N_EVENTS // CHUNK)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    with TorchEngine([sample], chunk_size=CHUNK, device="cpu") as one:
        alone = _raw(one, bps)
    for s in range(2):
        assert both[s].tobytes() == alone[0].tobytes()


@pytest.mark.parametrize("fine", [True, False], ids=["fine", "bai_only"])
def test_reopen_pins_the_bamfile_internals(files, monkeypatch, fine):
    """``_reopen`` hands the sample handle's parsed indexes to the new
    handle through ``BamFile``'s private fields (its docstring names
    them). The new handle must read them back through the public
    surface: the same decode threads, the same fine index (or, where
    the sample's failed, none and no attempt to build one), the same
    BAI, its own native arena, and the sample handle's records."""
    _, bams, vcf, _ = files
    sidecar = bams[0] + ".fidx.npz"
    if not fine and os.path.exists(sidecar):
        os.unlink(sidecar)
    built, real = [], native.NativeBam.build_fineidx

    def build(*a, **k):
        built.append(1)
        if not fine:
            raise OSError("no fine index")
        return real(*a, **k)

    monkeypatch.setattr(native.NativeBam, "build_fineidx", build)
    sample = _sample(bams[0])
    assert (sample.bam._get_fineidx() is not None) == fine
    n_built = len(built)
    h = teng._reopen(sample.bam)
    assert type(h) is BamFile and h.path == sample.bam.path
    assert h._threads == sample.bam._threads
    assert h._get_native() is not None
    assert h._get_native() is not sample.bam._get_native()
    assert h._get_fineidx() is sample.bam._get_fineidx()
    assert h.bai is sample.bam.bai
    lo, hi = 200_000, 1_500_000
    got, want = h.fetch("chr1", lo, hi), sample.bam.fetch("chr1", lo, hi)
    assert got.n == want.n > 0
    for col in ("qname_hash", "pos", "flag", "tlen"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    assert len(built) == n_built


@pytest.mark.parametrize("cores", ["1", "2", "all"])
def test_cores_keeps_the_decode_threads_within_the_usable_cores(
        files, tmp_path, monkeypatch, cores):
    """``--cores N`` over four devices: each handle decodes on N
    threads, and the engine opens and runs at once as many handles as
    the usable cores hold at N (at least one), never N jobs of N
    threads."""
    _, bams, vcf, _ = files
    usable = len(os.sched_getaffinity(0))
    n = usable + 1 if cores == "all" else int(cores)
    seen = []
    real = TorchEngine._prepare_shards

    def prepare_shards(self, bps):
        out = real(self, bps)
        pool = self._prep_pool
        seen.append((self._prep_width(), self.shard_bams()[0],
                     pool._max_workers if pool is not None else 1))
        return out

    monkeypatch.setattr(TorchEngine, "_prepare_shards", prepare_shards)
    argv = ["-i", vcf, "-B", bams[0], "-n", "50000", "--batch_size",
            str(CHUNK), "--cores", str(n), "-o", str(tmp_path / "o.vcf")]
    assert tclassic.main(argv, devices=["cpu"] * 4) == 0
    assert seen
    want = max(1, min(4, usable // n))
    for width, handles, workers in seen:
        assert width == workers == want
        assert width * n <= max(n, usable)
        assert len({id(h) for h in handles}) == width
        assert [h._threads for h in handles] == [n] * 4


def test_handles_follow_the_pool_width(files):
    """Four shards on a pool of two: two handles, the sample's own for
    shards 0-1 and a second for shards 2-3, with the rows of one
    device."""
    _, bams, vcf, _ = files
    sample, bps = _sample(bams[0]), _bps(vcf)
    with TorchEngine([sample], chunk_size=CHUNK, devices=["cpu"] * 4,
                     prep_workers=2) as eng:
        rows = _raw(eng, bps)
        (handles,) = eng.shard_bams()
    assert handles[0] is handles[1] is sample.bam
    assert handles[2] is handles[3] and handles[2] is not sample.bam
    with TorchEngine([sample], chunk_size=CHUNK, device="cpu") as one:
        assert _raw(one, bps).tobytes() == rows.tobytes()


def test_two_samples_over_three_shards_match_each_alone(files):
    _, bams, vcf, _ = files
    bps = _bps(vcf)
    samples = [_sample(p) for p in bams]
    with _engine(samples, 3) as eng:
        both = _raw(eng, bps)
        views = eng.shard_bams()
    assert [v[0] for v in views] == [s.bam for s in samples]
    assert len({id(h) for v in views for h in v}) == 6
    for s, sample in enumerate(samples):
        with TorchEngine([sample], chunk_size=CHUNK, device="cpu") as one:
            alone = _raw(one, bps)
        assert both[s].tobytes() == alone[0].tobytes(), s
    assert both[0].tobytes() != both[1].tobytes()  # two real samples


def test_one_sample_given_twice_shares_no_handle_in_flight(files):
    """``[sample, sample]``: shard 0 of both is the one handle, so their
    fetches on it run one after the other in one job."""
    _, bams, vcf, _ = files
    sample, bps = _sample(bams[0]), _bps(vcf)
    with _engine([sample, sample], 2) as eng:
        views = eng.shard_bams()
        calls = _wrap_fetches([views[0][0], views[0][1], views[1][1]])
        both = _raw(eng, bps)
    on_sample = sorted((t0, t1) for k, _, t0, t1 in calls if k == 0)
    assert len(on_sample) == 2 * -(-N_EVENTS // eng.chunk_size)
    assert all(a[1] <= b[0] for a, b in zip(on_sample, on_sample[1:]))
    with TorchEngine([sample], chunk_size=CHUNK, device="cpu") as one:
        alone = _raw(one, bps)
    for s in range(2):
        assert both[s].tobytes() == alone[0].tobytes()


def test_evidence_output_over_four_shards_matches_one(files, tmp_path,
                                                      capsys):
    """``-w`` with the shards fetching concurrently (``--cores 4``: four
    decode threads per handle): the evidence BAM holds one device's
    records, and the shard handles' export follows the engine's
    sink."""
    _, bams, vcf, _ = files
    argv = ["-i", vcf, "-B", bams[0], "-n", "50000", "--batch_size",
            str(CHUNK), "--cores", "4"]
    ev, out = {}, {}
    for key, kw in (("one", {"device": "cpu"}),
                    ("four", {"devices": ["cpu"] * 4})):
        capsys.readouterr()
        path = str(tmp_path / ("ev_%s.bam" % key))
        out[key] = str(tmp_path / (key + ".vcf"))
        assert tclassic.main(argv + ["-o", out[key], "-w", path], **kw) == 0
        assert "re-fetch" not in capsys.readouterr().err
        ev[key] = BamFile(path).fetch("chr1", 0, REFS[0][1])
    with open(out["one"]) as a, open(out["four"]) as b:
        assert a.read() == b.read()
    a, b = ev["one"], ev["four"]
    assert a.n == b.n > 0
    for col in ("qname_hash", "pos", "flag", "tlen"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))


def test_shard_handles_follow_the_evidence_sink(files, monkeypatch):
    _, bams, vcf, _ = files
    sample, bps = _sample(bams[0]), _bps(vcf)
    toggled = []
    real = BamFile.set_evidence_export
    monkeypatch.setattr(BamFile, "set_evidence_export",
                        lambda self, on: toggled.append((id(self), on))
                        or real(self, on))
    got = []
    with _engine([sample], 4) as eng:
        eng.genotype_all(bps[:CHUNK])
        assert toggled == []
        sample.bam.set_evidence_export(True)  # as the CLI does
        eng.evidence_sink = lambda si, e: got.append((si, e))
        eng.genotype_all(bps[:CHUNK])
        (handles,) = eng.shard_bams()
        assert sorted(toggled[1:]) == sorted(
            (id(h), True) for h in handles[1:])
        eng.evidence_sink = None
        sample.bam.set_evidence_export(False)
        eng.genotype_all(bps[:CHUNK])
        assert sorted(toggled[-3:]) == sorted(
            (id(h), False) for h in handles[1:])
    # the shards' rows in shard order, each as the sample's own handle
    # records it for that shard's variants alone
    ((si, evidence),) = got
    n = eng.chunk_size // 4
    ref = _sample(bams[0])
    ref.bam.set_evidence_export(True)
    want = []
    for d in range(4):
        assert prepare_compact_chunk(ref, bps[d * n:(d + 1) * n]) is not None
        want.append(ref.bam.chunk_evidence())
    assert si == 0 and len(evidence[4]) > 0
    for col, cols in zip(evidence, zip(*want)):
        np.testing.assert_array_equal(col, np.concatenate(cols))


@pytest.mark.parametrize("kind", ["cram", "python"])
def test_a_handle_not_reopened_preps_its_shards_serially(files, kind):
    """A CRAM sample, and a BAM on the pure-Python decoder, keep their
    one handle for every shard (a second would not fetch concurrently),
    with the rows of one device."""
    _, bams, vcf, cram = files
    if kind == "cram":
        sample = _sample(cram)
        assert isinstance(sample.bam, CramFile)
    else:
        sample = Sample.from_bam(BamFile(bams[0], use_native=False),
                                 num_samp=50_000)
        assert sample.bam._get_native() is None
    bps = _bps(vcf)
    with _engine([sample], 3) as eng:
        assert eng.shard_bams() == [[sample.bam] * 3]
        rows = _raw(eng, bps)
    with TorchEngine([_sample(bams[0])], chunk_size=CHUNK,
                     device="cpu") as one:
        want = _raw(one, bps)
    assert rows.tobytes() == want.tobytes()
