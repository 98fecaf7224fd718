"""TorchEngine (CPU, float64) against TpuEngine and the float64 oracle,
on the tests/test_engine_parity.py fixture (DEL, DUP, INV, BND, small
DEL, low depth, no coverage), plus ``dens_state`` and the engine's
device refusals. The port's engine takes its inputs from the port's
host half, the JAX engines theirs from the JAX package's, both on the
same simulated BAM.

Rows: the 14 integer fields equal TpuEngine's exactly; the floats to
1e-12 relative (torch's CPU pow/log10 and XLA's differ by an ulp).
Formatted fields equal the oracle's exactly.
"""

import io

import numpy as np
import pytest
import torch

from svtyper_tpu.bamio.bam import BamFile as JBamFile
from svtyper_tpu.breakpoints import resolve_breakpoint as jresolve
from svtyper_tpu.gt import TpuEngine
from svtyper_tpu.oracle import OracleEngine as JOracleEngine
from svtyper_tpu.stats import Sample as JSample
from svtyper_tpu.vcfio.model import Variant as JVariant
from svtyper_tpu.vcfio.model import Vcf as JVcf
from svtyper_tpu.vcfio.reader import read_vcf_lines as jread_vcf_lines
from svtyper_tpu_torch.bamio.bam import BamFile
from svtyper_tpu_torch.breakpoints import resolve_breakpoint
from svtyper_tpu_torch.gt import engine as teng
from svtyper_tpu_torch.gt.engine import TorchEngine, dens_state
from svtyper_tpu_torch.oracle import OracleEngine
from svtyper_tpu_torch.simulate import (
    Event,
    SimConfig,
    events_to_vcf,
    simulate_events,
)
from svtyper_tpu_torch.stats import Sample
from svtyper_tpu_torch.utils.formatting import fmt_f2, fmt_g2, fmt_gl
from svtyper_tpu_torch.vcfio.model import Variant, Vcf
from svtyper_tpu_torch.vcfio.reader import read_vcf_lines

REFS = [("chr1", 10_000_000), ("chr2", 5_000_000)]

EVENTS = [
    Event("DEL", "chr1", 1_000_000, 1_003_000, "0/1"),
    Event("DEL", "chr1", 1_200_000, 1_202_500, "1/1"),
    Event("DEL", "chr1", 1_400_000, 1_402_000, "0/0"),
    Event("DUP", "chr1", 2_000_000, 2_004_000, "0/1"),
    Event("DUP", "chr1", 2_200_000, 2_203_000, "1/1"),
    Event("INV", "chr1", 3_000_000, 3_003_000, "0/1"),
    Event("INV", "chr1", 3_200_000, 3_202_000, "1/1"),
    Event("DEL", "chr1", 4_000_000, 4_000_180, "0/1", var_id="smalldel"),
    Event("BND", "chr1", 5_000_000, 1_000_000, "0/1", chrom2="chr2"),
    Event("DEL", "chr1", 6_000_000, 6_002_000, "0/1", var_id="lowdepth"),
]


NO_COV = "chr2\t4000000\tnocov\tN\t<DEL>\t.\t.\tSVTYPE=DEL;END=4002000"


@pytest.fixture(scope="module")
def sim_bam(tmp_path_factory):
    bam_path = str(tmp_path_factory.mktemp("torch_parity") / "sim.bam")
    simulate_events(
        bam_path, REFS, EVENTS, SimConfig(depth=40), seed=11,
        extra_background=3000,
    )
    return bam_path


def _load(bam_path, BamFile, Sample, Vcf, Variant, read_vcf_lines, resolve):
    """(sample, variants, breakpoints) through one package's host half."""
    sample = Sample.from_bam(BamFile(bam_path), num_samp=100_000)
    vcf = Vcf()
    header, body = read_vcf_lines(io.StringIO(events_to_vcf(EVENTS, REFS)))
    vcf.add_header(header)
    variants = [Variant(line, vcf) for line in list(body) + [NO_COV]]
    return sample, variants, [resolve(v) for v in variants]


@pytest.fixture(scope="module")
def setup(sim_bam):
    return _load(sim_bam, BamFile, Sample, Vcf, Variant, read_vcf_lines,
                 resolve_breakpoint)


@pytest.fixture(scope="module")
def jax_setup(sim_bam):
    return _load(sim_bam, JBamFile, JSample, JVcf, JVariant, jread_vcf_lines,
                 jresolve)


def _fmt_row(res):
    """The FORMAT-field strings that reach the VCF (SPEC.md §6)."""
    if res.null:
        return ("./.",)
    return (
        res.gt_string,
        str(res.gq),
        fmt_f2(res.sq),
        fmt_gl(res.gl),
        str(res.qr),
        str(res.qa),
        fmt_g2(res.ab) if res.ab is not None else ".",
    )


def _rows(engine, bps):
    return np.concatenate(
        [a[0][:n] for n, a in engine.genotype_stream(bps, raw=True)]
    )


def test_rows_match_tpu_engine(setup, jax_setup):
    sample, variants, bps = setup
    jsample, _, jbps = jax_setup
    got = _rows(TorchEngine([sample], device="cpu"), bps)
    want = _rows(TpuEngine([jsample]), jbps)
    assert got.shape == want.shape == (len(bps), teng.ROW_WIDTH)
    np.testing.assert_array_equal(got[:, : teng._NI], want[:, : teng._NI])
    np.testing.assert_allclose(
        got[:, teng._NI:], want[:, teng._NI:], rtol=1e-12, atol=1e-12
    )


def test_engine_matches_oracle(setup, jax_setup):
    sample, variants, bps = setup
    jsample, _, jbps = jax_setup
    oracle = JOracleEngine([jsample])
    engine = TorchEngine([sample], device="cpu")
    eng_results = engine.genotype_all(bps)
    for var, bp, eng_row in zip(variants, jbps, eng_results):
        orc = oracle.genotype_variant(bp)[0]
        eng = eng_row[0]
        assert eng.null == orc.null, var.var_id
        assert _fmt_row(eng) == _fmt_row(orc), var.var_id
        if not orc.null:
            assert eng.counts == pytest.approx(orc.counts, abs=1e-9)
            assert (eng.qr, eng.qa) == (orc.qr, orc.qa)
            assert eng.gl == pytest.approx(orc.gl, abs=1e-9)


def test_engine_f32_cpu_formats_like_f64(setup):
    """The float32 CPU engine (the CUDA kernel's twin) calls the same
    genotypes as the float64 one on this fixture."""
    sample, variants, bps = setup
    r32 = TorchEngine([sample], device="cpu", dtype=torch.float32)
    r64 = TorchEngine([sample], device="cpu")
    a = _rows(r32, bps)
    b = _rows(r64, bps)
    assert a.dtype == np.float32 and b.dtype == np.float64
    for key in ("null", "gt_idx", "qr", "qa", "dp", "ro", "ao"):
        np.testing.assert_array_equal(a[:, teng._I[key]], b[:, teng._I[key]])


def test_engine_max_reads_and_ci(setup):
    sample, variants, bps = setup
    res = TorchEngine([sample], max_reads=5, device="cpu").genotype_chunk(
        bps[:1]
    )[0][0]
    assert res.null
    import copy

    bp = copy.copy(bps[0])
    bp.ci_a = (-8, 8)
    engine = TorchEngine([sample], max_ci_dist=0.5, device="cpu")
    assert engine.genotype_chunk([bp])[0][0].null


def test_engine_none_breakpoint_and_chunking(setup):
    sample, variants, bps = setup
    rows = TorchEngine([sample], device="cpu").genotype_chunk([None, bps[0]])
    assert rows[0][0].null and not rows[1][0].null
    r1 = TorchEngine([sample], chunk_size=3, device="cpu").genotype_all(bps)
    r2 = TorchEngine([sample], device="cpu").genotype_all(bps)
    assert [_fmt_row(a[0]) for a in r1] == [_fmt_row(b[0]) for b in r2]


def test_genotype_stream_early_abort(setup):
    """Abandoning the stream mid-flight shuts the pipeline down and
    leaves the engine usable."""
    sample, variants, bps = setup
    engine = TorchEngine([sample], chunk_size=4, device="cpu")
    stream = engine.genotype_stream(iter(bps * 6))
    first = next(stream)
    assert len(first) == 4
    stream.close()
    assert len(engine.genotype_chunk(bps[:4])) == 4
    assert sum(len(c) for c in engine.genotype_stream(iter(bps))) == len(bps)
    assert engine.stats["variants"] > 0 and engine.stats["chunks"] > 0


def test_multisample_rows_equal_single(setup):
    """Two samples in one engine (the prep pool) give each sample the
    rows it gets alone."""
    sample, variants, bps = setup
    both = TorchEngine([sample, sample], device="cpu")
    n, per_sample = both._collect(len(bps), both._dispatch(bps), raw=True)
    both.close()
    alone = _rows(TorchEngine([sample], device="cpu"), bps)
    for rows in per_sample:
        np.testing.assert_array_equal(rows[:n], alone)


def test_row_layout_copies_match_jax(setup, jax_setup):
    """The jax-free copies of the JAX engine's row layout and wire
    helpers give what the originals give, each on its own package's
    oracle results."""
    from svtyper_tpu.evidence.extract import compact_chunk
    from svtyper_tpu.gt import engine as jeng
    from svtyper_tpu.parallel.synth import make_synthetic_chunk

    assert (teng.INT_FIELDS, teng._I, teng._NI, teng.ROW_WIDTH) == (
        jeng.INT_FIELDS, jeng._I, jeng._NI, jeng.ROW_WIDTH
    )
    sample, variants, bps = setup
    jsample, _, jbps = jax_setup
    oracle, joracle = OracleEngine([sample]), JOracleEngine([jsample])
    results = [(None, None)] + [
        (oracle.genotype_variant(bp)[0], joracle.genotype_variant(jbp)[0])
        for bp, jbp in zip(bps, jbps)
    ]
    for r, jr in results:
        row = teng.result_to_row(r)
        np.testing.assert_array_equal(row, jeng.result_to_row(jr))
        a, b = teng.row_to_result(row), jeng.row_to_result(row)
        assert [getattr(a, k) for k in a.__slots__] == [
            getattr(b, k) for k in b.__slots__
        ]

    chunk, _dens = make_synthetic_chunk(n_var=8, frags_per_var=6)
    c = compact_chunk(chunk, min_aligned=20)
    r_pad, f_pad = c["cr_u16"].shape[1] + 5, c["cp_u16"].shape[1] + 7
    got = teng._repad_compact(c, r_pad, f_pad, chunk.n_var)
    want = jeng._repad_compact(c, r_pad, f_pad, chunk.n_var)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    stacked = {k: np.stack([got[k], got[k]]) for k in got}
    for packed, multi in ((got, False), (stacked, True)):
        (w1, g1), (w2, g2) = (
            teng.pack_wire(packed, multi), jeng.pack_wire(packed, multi)
        )
        assert g1 == g2
        np.testing.assert_array_equal(w1, w2)


class _FakeSample:
    def __init__(self, m):
        self.m = m

    def dens_matrix(self):
        return self.m


@pytest.mark.parametrize("shape", [(2, 700), (1, 1024), (3, 1500), (0, 0)])
def test_dens_state_matches_tpu_engine(shape):
    m = np.random.default_rng(sum(shape)).random(shape)
    want = np.asarray(TpuEngine([_FakeSample(m)])._dens_for(0))
    got = dens_state(m, "cpu", torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    f32 = dens_state(m, "cpu", torch.float32)
    np.testing.assert_array_equal(f32.numpy(), want.astype(np.float32))


def test_cuda_refusal(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine([], device="cuda")
    with pytest.raises(ValueError):
        TorchEngine([], device="cpu", dtype=torch.float16)
    with pytest.raises(ValueError):
        TorchEngine([], device="meta")
