"""The port's ``classify_compact`` and wire unpack against the JAX
package.

float64 counts are exact: prob_mapq comes from the oracle's expression
(which equals XLA's f64 pow for every mapq) and the sorted segment sums
add each segment's rows in order from 0, as XLA's CPU scatter-add does.
float32 counts are exact too on fixtures whose mapq avoids 1-3: those
three entries of the f64-rounded table differ from XLA's f32 pow by one
ulp (checked below), and are the only stated source of f32 difference.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svtyper_tpu.evidence.device import classify_compact as jax_classify_compact
from svtyper_tpu.evidence.device import prob_mapq as jax_prob_mapq
from svtyper_tpu.oracle.engine import prob_mapq as oracle_prob_mapq
from svtyper_tpu.parallel.synth import make_synthetic_chunk
from svtyper_tpu_torch.evidence.extract import (
    COMPACT_KEYS,
    compact_chunk,
    prepare_chunk,
)
from svtyper_tpu_torch.evidence.device import (
    PROB_MAPQ,
    _sorted_segment_sum,
    classify_compact,
)
from svtyper_tpu_torch.gt.engine import pack_wire
from svtyper_tpu_torch.ops.classify_kernel import unwire

DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


def test_prob_mapq_table_is_the_oracle():
    for q in range(256):
        assert PROB_MAPQ[q] == oracle_prob_mapq(q)
    q = np.arange(256)
    f64 = np.asarray(jax_prob_mapq(jnp.asarray(q), jnp.float64))
    np.testing.assert_array_equal(PROB_MAPQ, f64)
    f32 = np.asarray(jax_prob_mapq(jnp.asarray(q), jnp.float32))
    differ = np.flatnonzero(PROB_MAPQ.astype(np.float32) != f32)
    assert set(differ.tolist()) <= {1, 2, 3}
    ulps = np.abs(
        PROB_MAPQ.astype(np.float32).view(np.int32) - f32.view(np.int32)
    )
    assert ulps.max() <= 1


@pytest.fixture(scope="module")
def real_chunk(tmp_path_factory):
    """Simulated BAM through the port's prepare_chunk: every SV type,
    padding rows, SA splits, soft clips (the tests/test_compact.py
    fixture)."""
    from svtyper_tpu_torch.bamio.bam import BamFile
    from svtyper_tpu_torch.breakpoints import resolve_breakpoint
    from svtyper_tpu_torch.simulate import (
        Event,
        SimConfig,
        events_to_vcf,
        simulate_events,
    )
    from svtyper_tpu_torch.stats import Sample
    from svtyper_tpu_torch.vcfio.model import Variant, Vcf
    from svtyper_tpu_torch.vcfio.reader import read_vcf_lines

    refs = [("chr1", 6_000_000)]
    events = [
        Event("DEL", "chr1", 1_000_000, 1_003_000, "0/1"),
        Event("DUP", "chr1", 2_000_000, 2_002_000, "0/1"),
        Event("INV", "chr1", 3_000_000, 3_002_000, "1/1"),
        Event("DEL", "chr1", 4_000_000, 4_000_900, "0/0"),
    ]
    bam = str(tmp_path_factory.mktemp("torch_ev") / "sim.bam")
    simulate_events(bam, refs, events, SimConfig(depth=30), seed=5,
                    extra_background=1000)
    sample = Sample.from_bam(BamFile(bam), num_samp=50_000)
    vcf = Vcf()
    header, body = read_vcf_lines(
        iter(events_to_vcf(events, refs).splitlines())
    )
    vcf.add_header(header)
    bps = [resolve_breakpoint(Variant(l, vcf)) for l in body]
    bps = bps + [None] * (16 - len(bps))  # force padding slots
    return prepare_chunk(sample, bps), sample.dens_matrix()


def _synthetic():
    return make_synthetic_chunk(n_var=8, frags_per_var=6)


def _compare(chunk, dens, dt):
    tdt, jdt = DTYPES[dt]
    c = compact_chunk(chunk, min_aligned=20)
    ref = np.asarray(
        jax_classify_compact(
            *(jnp.asarray(c[k]) for k in COMPACT_KEYS),
            jnp.asarray(dens, dtype=jdt),
            chunk.n_var,
            dtype=jdt,
        )
    )
    mats = [torch.from_numpy(np.ascontiguousarray(c[k])) for k in COMPACT_KEYS]
    got = classify_compact(
        *mats, torch.tensor(dens, dtype=tdt), chunk.n_var, dtype=tdt
    ).numpy()
    assert got.dtype == ref.dtype and got.shape == (chunk.n_var, 5)
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_classify_compact_matches_jax_synthetic(dt):
    chunk, dens = _synthetic()
    got = _compare(chunk, dens, dt)
    assert got.any()


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_classify_compact_matches_jax_real_chunk(real_chunk, dt):
    chunk, dens = real_chunk
    mapq = np.concatenate([chunk.reads["mapq"], chunk.reads["sa_mapq"]])
    assert not np.isin(mapq, [1, 2, 3]).any()  # see the module docstring
    got = _compare(chunk, dens, dt)
    assert got[:4].any()


def test_classify_compact_through_the_wire(real_chunk):
    """pack_wire → unwire → classify_compact gives the same counts as
    classify_compact on the matrices themselves."""
    chunk, dens = real_chunk
    c = compact_chunk(chunk, min_aligned=20)
    wire, geom = pack_wire(c)
    parts = unwire(torch.from_numpy(wire), geom)
    d = torch.tensor(dens, dtype=torch.float64)
    via_wire = classify_compact(*parts, d, chunk.n_var, dtype=torch.float64)
    direct = classify_compact(
        *(torch.from_numpy(np.ascontiguousarray(c[k])) for k in COMPACT_KEYS),
        d, chunk.n_var, dtype=torch.float64,
    )
    np.testing.assert_array_equal(via_wire.numpy(), direct.numpy())


def test_unwire_roundtrip_and_alignment():
    rng = np.random.default_rng(0)
    mats = {
        "cr_u16": rng.integers(0, 65535, (1, 384), dtype=np.uint16),
        "cr_u8": rng.integers(0, 255, (3, 384), dtype=np.uint8),
        "cp_u16": rng.integers(0, 65535, (1, 96), dtype=np.uint16),
        "cp_i32": rng.integers(-2**31, 2**31 - 1, (1, 96), dtype=np.int32),
        "cp_u8": rng.integers(0, 255, (4, 96), dtype=np.uint8),
        "v_i32": rng.integers(-2**31, 2**31 - 1, (9, 10), dtype=np.int32),
        "v_u8": rng.integers(0, 2, (6, 10), dtype=np.uint8),
    }
    wire, geom = pack_wire(mats)
    parts = unwire(torch.from_numpy(wire), geom)
    for k, p in zip(COMPACT_KEYS, parts):
        assert tuple(p.shape) == mats[k].shape
        np.testing.assert_array_equal(p.numpy().astype(np.int64),
                                      mats[k].astype(np.int64), err_msg=k)
    # an odd u8 width puts the next int32 matrix off its alignment
    bad = dict(mats, cr_u8=mats["cr_u8"][:, :383], cr_u16=mats["cr_u16"][:, :383])
    wire, geom = pack_wire(bad)
    with pytest.raises(ValueError):
        unwire(torch.from_numpy(wire), geom)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sorted_segment_sum_is_sequential(dtype):
    """Each segment is summed in row order from 0 (empty segments → 0),
    bit-for-bit like a Python loop in the same dtype."""
    rng = np.random.default_rng(1)
    nseg = 40
    seg = np.sort(rng.integers(0, nseg + 1, 3000))
    seg[seg == 7] = 8  # an empty segment
    npdt = np.float32 if dtype == torch.float32 else np.float64
    data = (rng.random((3000, 3)) * 10).astype(npdt)
    want = np.zeros((nseg + 1, 3), dtype=npdt)
    for row, s in zip(data, seg):
        want[s] += row
    got = _sorted_segment_sum(
        torch.from_numpy(data), torch.from_numpy(seg), nseg + 1
    ).numpy()
    np.testing.assert_array_equal(got, want)
