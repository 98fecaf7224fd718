"""The JAX suite's hard fixtures, run on the port against the JAX package.

- the noisy fixture of ``test_noise_robustness.py`` (spurious clips,
  low-MAPQ ambiguity, chimeric SA tags, discordant background pairs):
  the port's float64 CLI byte-identical to the JAX CLI's ``--engine
  oracle``; its float32 twin byte-identical to the JAX CLI with its
  Pallas GL kernel interpreted (``JAX_ENABLE_X64=0
  SVT_PALLAS=interpret``); three CPU shards at ``--batch_size 7``
  byte-identical to one device;
- the same fixture as CRAM, through the CLI and through ``TorchEngine``,
  equal to the BAM's output;
- the fixtures of ``test_edge_cases.py`` (flagged reads, a deletion
  CIGAR, mapq 0, a wide CI, a multi-library sample): the engine's
  float64, float32-twin and three-shard counts against the JAX oracle's
  (float64 and shards to 1e-9 as that file holds its engine; the
  float32 twin to float32 rounding, rtol 1e-6), QR/QA and GT exact;
- the BND cases of ``test_bnd.py`` (secondary-first, mate CIPOS,
  inter-chromosomal, ``--batch_size 1`` across chunks, batch 2 over
  three shards): the port's CLI byte-identical to the JAX oracle CLI's.

The JAX engines take their inputs from the JAX package and the port its
own, on the same files. Chunk boundaries and shard splits are what
these fixtures exercise, so a divergence here is a fault of the port.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svtyper_tpu.bamio.bam import BamFile as JBamFile
from svtyper_tpu.breakpoints import Breakpoint as JBreakpoint
from svtyper_tpu.cli.classic import main as jclassic_main
from svtyper_tpu.oracle import OracleEngine as JOracleEngine
from svtyper_tpu.stats import Sample as JSample
from svtyper_tpu_torch.bamio.bam import BamFile
from svtyper_tpu_torch.bamio.columns import (
    FDUP,
    FMREVERSE,
    FPAIRED,
    FQCFAIL,
    FREVERSE,
    FSECONDARY,
    FSUPPLEMENTARY,
)
from svtyper_tpu_torch.bamio.cram_writer import bam_to_cram
from svtyper_tpu_torch.bamio.writer import BamWriter, make_header_text
from svtyper_tpu_torch.breakpoints import Breakpoint
from svtyper_tpu_torch.cli import classic as tclassic
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.simulate import (
    Event,
    SimConfig,
    events_to_vcf,
    simulate_events,
)
from svtyper_tpu_torch.stats import Sample
from svtyper_tpu_torch.utils import fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600


def _read(p):
    with open(p) as fh:
        return fh.read()


# ------------------------------------------------------------ noisy / CRAM


@pytest.fixture(scope="module")
def noisy(tmp_path_factory):
    """``test_noise_robustness.py``'s fixture, and its CRAM transcode."""
    d = tmp_path_factory.mktemp("torch_noise")
    rng = np.random.default_rng(55)
    gts = ["0/0", "0/1", "0/1", "1/1"]
    types = ["DEL", "DEL", "DUP", "INV"]
    refs = [("chr1", 9_000_000)]
    events = []
    for i in range(40):
        pos = 150_000 + i * 200_000
        svlen = int(rng.integers(400, 5000))
        events.append(Event(types[i % 4], "chr1", pos, pos + svlen,
                            gts[int(rng.integers(0, 4))],
                            var_id="n%d" % i))
    bam = str(d / "noisy.bam")
    cfg = SimConfig(
        depth=30,
        noise_clip_rate=0.08,
        noise_lowmapq_rate=0.15,
        noise_chimera_rate=0.04,
        noise_discordant_rate=0.10,
    )
    simulate_events(bam, refs, events, cfg, seed=55, extra_background=3000)
    vcf = str(d / "in.vcf")
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(events, refs))
    cram = str(d / "noisy.cram")
    bam_to_cram(bam, cram)
    return d, bam, cram, vcf


def _noisy_args(vcf, bam):
    return ["-i", vcf, "-B", bam, "-n", "50000"]


@pytest.fixture(scope="module")
def noisy_oracle(noisy):
    """The JAX CLI's ``--engine oracle`` output on the noisy BAM."""
    d, bam, _, vcf = noisy
    out = str(d / "jax_oracle.vcf")
    assert jclassic_main(_noisy_args(vcf, bam)
                         + ["-o", out, "--engine", "oracle"]) == 0
    return _read(out)


def test_noisy_f64_cli_matches_jax_oracle(noisy, noisy_oracle):
    d, bam, _, vcf = noisy
    out = str(d / "torch_f64.vcf")
    assert tclassic.main(_noisy_args(vcf, bam) + ["-o", out],
                         device="cpu") == 0
    assert _read(out) == noisy_oracle


def test_noisy_shards_and_batch_match_one_device(noisy, noisy_oracle):
    d, bam, _, vcf = noisy
    out = str(d / "torch_3shards.vcf")
    assert tclassic.main(_noisy_args(vcf, bam)
                         + ["-o", out, "--batch_size", "7"],
                         devices=["cpu"] * 3) == 0
    assert _read(out) == noisy_oracle


def test_noisy_f32_twin_matches_jax_pallas_interpret(noisy):
    d, bam, _, vcf = noisy
    out_jax = str(d / "jax_pallas.vcf")
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        JAX_ENABLE_X64="0",
        XLA_FLAGS="--xla_force_host_platform_device_count=1",
        SVT_PALLAS="interpret",
        PYTHONPATH=ROOT,
    )
    res = subprocess.run(
        [sys.executable, "-m", "svtyper_tpu.cli.classic",
         *_noisy_args(vcf, bam), "-o", out_jax],
        env=env, capture_output=True, timeout=TIMEOUT,
    )
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    out_t = str(d / "torch_f32.vcf")
    with open(vcf) as fi, open(out_t, "w") as fo:
        tclassic.sv_genotype(bam, fi, fo, num_samp=50000, device="cpu",
                             dtype=torch.float32)
    assert _read(out_t) == _read(out_jax)


def test_noisy_cram_cli_matches_bam(noisy, noisy_oracle):
    d, _, cram, vcf = noisy
    out = str(d / "torch_cram.vcf")
    assert tclassic.main(_noisy_args(vcf, cram) + ["-o", out],
                         device="cpu") == 0
    assert _read(out) == noisy_oracle


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_noisy_cram_engine_matches_bam(noisy, dtype):
    _, bam, cram, vcf = noisy
    rows = {}
    for path in (bam, cram):
        sample, bps = fixture.load_sample_and_breakpoints(path, vcf,
                                                          num_samp=50_000)
        engine = TorchEngine([sample], chunk_size=16, device="cpu",
                             dtype=dtype)
        rows[path] = np.concatenate(
            [a[0][:n] for n, a in engine.genotype_stream(bps, raw=True)])
    assert rows[bam].shape == (40, 24)
    assert (rows[bam][:, 0] == 0).sum() > 30  # most variants are called
    np.testing.assert_array_equal(rows[cram], rows[bam])


# ------------------------------------------------------------- edge cases

M, I, D, N, S = 0, 1, 2, 3, 4
EDGE_REFS = [("chr1", 200_000)]
BP_A, BP_B = 50_000, 60_000  # 0-based breakpoints


def _bp(cls, ci=(0, 0)):
    bp = cls("DEL", "chr1", BP_A, (0, 0), "chr1", BP_B, (0, 0), False, True,
             BP_B - BP_A)
    bp.ci_a = bp.ci_b = ci
    return bp


def _write(path, records):
    hdr = make_header_text(
        EDGE_REFS, read_groups=[{"ID": "rg0", "SM": "S", "LB": "L"}]
    )
    w = BamWriter(path, EDGE_REFS, hdr)
    for r in sorted(records, key=lambda r: r[2]):
        qname, flag, pos, cigar, mapq, mate_pos, tlen = r
        qlen = sum(l for op, l in cigar if op in (M, I, S))
        w.write(qname, flag, 0, pos, mapq, cigar,
                mate_tid=0 if mate_pos >= 0 else -1, mate_pos=mate_pos,
                tlen=tlen, seq="A" * qlen, tags={"RG": ("Z", "rg0")})
    w.close()
    return path


def _pair(qname, pos1, pos2, mapq=60, flags=0):
    span = pos2 + 150 - pos1
    return [
        (qname, FPAIRED | FMREVERSE | flags, pos1, [(M, 150)], mapq, pos2,
         span),
        (qname, FPAIRED | FREVERSE | flags, pos2, [(M, 150)], mapq, pos1,
         -span),
    ]


def _background(n=40):
    out = []
    for i in range(n):
        p = 45_000 + i * 500
        out += _pair("bg%d" % i, p, p + 200)
    return out


def _flagged():
    recs = _background() + _pair("thru", BP_A - 75, BP_A - 60)
    for i, fl in enumerate((FDUP, FSECONDARY, FSUPPLEMENTARY, FQCFAIL)):
        recs += _pair("noise%d" % i, BP_A - 75, BP_A + 30, flags=fl)
    return recs


def _deletion_cigar():
    return _background() + [
        ("del_read", FPAIRED | FMREVERSE, BP_A - 75,
         [(M, 70), (D, 10), (M, 80)], 60, BP_A + 300, 525),
        ("del_read", FPAIRED | FREVERSE, BP_A + 300, [(M, 150)], 60,
         BP_A - 75, -525),
    ]


def _mapq_zero():
    return _background() + _pair("mq0", BP_A - 75, BP_A - 60, mapq=0)


def _write_multi_library(path):
    """``test_multi_library_sample``'s BAM: two libraries with inserts
    300 and 500, and one rare-library pair below the prevalence floor."""
    hdr = make_header_text(
        EDGE_REFS,
        read_groups=[
            {"ID": "rgA", "SM": "S", "LB": "libA"},
            {"ID": "rgB", "SM": "S", "LB": "libB"},
            {"ID": "rgR", "SM": "S", "LB": "libRare"},
        ],
    )
    w = BamWriter(path, EDGE_REFS, hdr)
    recs = []
    for i in range(1100):
        p = 40_000 + i * 80
        rg = "rgA" if i % 2 == 0 else "rgB"
        ins = 300 if rg == "rgA" else 500
        recs.append(("m%d" % i, FPAIRED | FMREVERSE, p, rg, p + ins - 150,
                     ins))
        recs.append(("m%d" % i, FPAIRED | FREVERSE, p + ins - 150, rg, p,
                     -ins))
    recs.append(("rare", FPAIRED | FMREVERSE, BP_A - 75, "rgR", BP_A + 100,
                 325))
    for q, fl, pos, rg, mpos, tl in sorted(recs, key=lambda r: r[2]):
        w.write(q, fl, 0, pos, 60, [(M, 150)], mate_tid=0, mate_pos=mpos,
                tlen=tl, seq="A" * 150, tags={"RG": ("Z", rg)})
    w.close()
    return path


EDGE_CASES = {
    "flagged_reads": (_flagged, (0, 0)),
    "deletion_cigar": (_deletion_cigar, (0, 0)),
    "mapq_zero": (_mapq_zero, (0, 0)),
    "wide_ci": (_background, (-40, 40)),
    "multi_library": (None, (0, 0)),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_case_counts_match_jax_oracle(case, tmp_path):
    records, ci = EDGE_CASES[case]
    path = str(tmp_path / ("%s.bam" % case))
    if records is None:
        _write_multi_library(path)
    else:
        _write(path, records())
    jsample = JSample.from_bam(JBamFile(path), num_samp=100_000)
    orc = JOracleEngine([jsample]).genotype_variant(_bp(JBreakpoint, ci))[0]
    assert not orc.null, "fixture produced no evidence (vacuous test)"
    sample = Sample.from_bam(BamFile(path), num_samp=100_000)
    if case == "multi_library":
        assert set(sample.lib_dict) == {"libA", "libB", "libRare"}
        assert "libRare" not in sample.active_libs
    bp = _bp(Breakpoint, ci)
    runs = {
        "f64": (dict(device="cpu"), 1e-9, 0.0),
        "f32_twin": (dict(device="cpu", dtype=torch.float32), 1e-5, 1e-6),
        "3_shards": (dict(devices=["cpu"] * 3), 1e-9, 0.0),
    }
    for name, (kw, atol, rtol) in runs.items():
        got = TorchEngine([sample], **kw).genotype_chunk([bp])[0][0]
        assert got.null == orc.null, name
        np.testing.assert_allclose(got.counts, orc.counts, atol=atol,
                                   rtol=rtol, err_msg=name)
        assert (got.qr, got.qa, got.gt_idx) == (orc.qr, orc.qa,
                                                orc.gt_idx), name


# -------------------------------------------------------------------- BND

BND_REFS = [("chr1", 3_000_000), ("chr2", 2_000_000)]
BND_EVENTS = [
    Event("DEL", "chr1", 1_000_000, 1_003_000, "0/1"),
    Event("BND", "chr1", 2_000_000, 1_000_000, "0/1", chrom2="chr2"),
]
INTRA_A = ("chr1", 1_000_000, "N[chr1:1003001[")
INTRA_B = ("chr1", 1_003_001, "]chr1:1000000]N")


def _rec(chrom, pos, vid, alt, info):
    return "%s\t%d\t%s\tN\t%s\t.\t.\t%s\tGT\t./." % (chrom, pos, vid, alt,
                                                     info)


PRI = _rec(*INTRA_A[:2], "p", INTRA_A[2], "SVTYPE=BND;MATEID=s;CIPOS=0,0")
SEC = _rec(*INTRA_B[:2], "s", INTRA_B[2],
           "SVTYPE=BND;MATEID=p;SECONDARY;CIPOS=0,0")
BND_CASES = {
    "primary_first": ([PRI, SEC], [], {}),
    "secondary_first": ([SEC, PRI], [], {}),
    "mate_cipos_pair": (
        [_rec(*INTRA_A[:2], "p", INTRA_A[2],
              "SVTYPE=BND;MATEID=s;CIPOS=0,0;CIEND=0,0"),
         _rec(*INTRA_B[:2], "s", INTRA_B[2],
              "SVTYPE=BND;MATEID=p;SECONDARY;CIPOS=-50,50")], [], {}),
    "mate_cipos_lone": (
        [_rec(*INTRA_A[:2], "p", INTRA_A[2],
              "SVTYPE=BND;CIPOS=0,0;CIEND=-50,50")], [], {}),
    "interchrom": (
        [_rec("chr1", 2_000_000, "t1", "N[chr2:1000001[",
              "SVTYPE=BND;MATEID=t2;CIPOS=0,0"),
         _rec("chr2", 1_000_001, "t2", "]chr1:2000000]N",
              "SVTYPE=BND;MATEID=t1;SECONDARY;CIPOS=0,0")], [], {}),
    "batch_1_across_chunks": ([PRI, SEC], ["--batch_size", "1"], {}),
    "batch_2_over_3_shards": ([PRI, SEC], ["--batch_size", "2"],
                              {"devices": ["cpu"] * 3}),
}


@pytest.fixture(scope="module")
def bnd_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bnd")
    bam = str(d / "sim.bam")
    simulate_events(bam, BND_REFS, BND_EVENTS, SimConfig(depth=36), seed=11,
                    extra_background=2000)
    header = "".join(
        l for l in events_to_vcf(BND_EVENTS, BND_REFS).splitlines(True)
        if l.startswith("#")
    )
    return d, bam, header


@pytest.mark.parametrize("case", list(BND_CASES))
def test_bnd_case_matches_jax_oracle(case, bnd_bam):
    d, bam, header = bnd_bam
    recs, extra, devices = BND_CASES[case]
    vcf = str(d / ("%s.vcf" % case))
    with open(vcf, "w") as fh:
        fh.write(header + "\n".join(recs) + "\n")
    argv = ["-i", vcf, "-B", bam, "-n", "50000"]
    want, got = str(d / ("%s.jax.vcf" % case)), str(d / ("%s.vcf.out" % case))
    assert jclassic_main(argv + ["-o", want, "--engine", "oracle"]) == 0
    assert tclassic.main(argv + extra + ["-o", got],
                         **(devices or {"device": "cpu"})) == 0
    body = [l.split("\t") for l in _read(got).splitlines()
            if not l.startswith("#")]
    assert len(body) == len(recs)
    assert all(row[9].split(":")[0] == "0/1" for row in body)
    assert _read(got) == _read(want)
