"""The port's full-column ``classify`` against the JAX package's and
against the port's own ``classify_compact``, and the property tests of
``tests/test_properties.py`` on the port.

Counts are compared exactly in float64 and float32: both of the port's
classifiers take prob_mapq from its 256-entry table, and the fixtures'
mapq avoid 1-3, the only entries where that table's float32 values are
one ulp from XLA's pow (``tests/test_torch_evidence.py``). A row
permutation changes the order of each per-variant sum, so the
invariance test allows atol=1e-9, as the JAX property test does.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svtyper_tpu.evidence.device import SPLIT_SLOP as JAX_SPLIT_SLOP
from svtyper_tpu.evidence.device import classify as jax_classify
from svtyper_tpu.parallel.synth import make_synthetic_chunk as jax_synthetic
from svtyper_tpu_torch.evidence import extract
from svtyper_tpu_torch.evidence.device import (
    SPLIT_SLOP,
    classify,
    classify_compact,
)
from svtyper_tpu_torch.models.bayes import bayes_gt, genotype_from_counts
from svtyper_tpu_torch.ops.gl import genotype_batch, log_choose_table
from svtyper_tpu_torch.parallel.synth import make_synthetic_chunk
from test_torch_evidence import real_chunk  # noqa: F401 (module fixture)

DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


def _tensors(cols):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in cols.items()}


def _port(chunk, dens, dtype, reads=None, pairs=None, rows_sorted=False):
    return classify(
        _tensors(chunk.reads if reads is None else reads),
        _tensors(chunk.pairs if pairs is None else pairs),
        _tensors(chunk.variants),
        torch.tensor(dens, dtype=dtype),
        chunk.n_var, 20, dtype=dtype, rows_sorted=rows_sorted,
    ).numpy()


def _jax(chunk, dens, dtype):
    def cols(d):
        return {k: jnp.asarray(np.asarray(v)) for k, v in d.items()}

    return np.asarray(jax_classify(
        cols(chunk.reads), cols(chunk.pairs), cols(chunk.variants),
        jnp.asarray(dens, dtype=dtype), chunk.n_var, 20, dtype=dtype,
    ))


def _compact(chunk, dens, dtype):
    c = extract.compact_chunk(chunk, min_aligned=20)
    return classify_compact(
        *(torch.from_numpy(np.ascontiguousarray(c[k]))
          for k in extract.COMPACT_KEYS),
        torch.tensor(dens, dtype=dtype), chunk.n_var, dtype=dtype,
    ).numpy()


@pytest.fixture(params=["synthetic", "real"])
def chunk_dens(request):
    if request.param == "synthetic":
        return make_synthetic_chunk(n_var=8, frags_per_var=6)
    chunk, dens = request.getfixturevalue("real_chunk")
    mapq = np.concatenate([chunk.reads["mapq"], chunk.reads["sa_mapq"],
                           chunk.pairs["a_mapq"], chunk.pairs["b_mapq"]])
    assert not np.isin(mapq, [1, 2, 3]).any()  # see the module docstring
    return chunk, dens


def test_split_slop_matches_extractor_and_jax():
    assert SPLIT_SLOP == extract._SPLIT_SLOP == JAX_SPLIT_SLOP


def test_synthetic_chunk_matches_jax():
    mine, dens = make_synthetic_chunk(n_var=8, frags_per_var=6)
    theirs, jdens = jax_synthetic(n_var=8, frags_per_var=6)
    np.testing.assert_array_equal(dens, jdens)
    for a, b in ((mine.reads, theirs.reads), (mine.pairs, theirs.pairs),
                 (mine.variants, theirs.variants)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_classify_matches_jax(chunk_dens, dt):
    chunk, dens = chunk_dens
    tdt, jdt = DTYPES[dt]
    got = _port(chunk, dens, tdt)
    want = _jax(chunk, dens, jdt)
    assert got.dtype == want.dtype and got.shape == (chunk.n_var, 5)
    np.testing.assert_array_equal(got, want)
    assert got[:4].any()


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_classify_equals_classify_compact(chunk_dens, dt):
    """The counterpart of tests/test_compact.py's full-vs-compact
    tests, within the port."""
    chunk, dens = chunk_dens
    tdt = DTYPES[dt][0]
    np.testing.assert_array_equal(
        _compact(chunk, dens, tdt), _port(chunk, dens, tdt)
    )


def test_rows_sorted_takes_the_same_sums(real_chunk):  # noqa: F811
    """On rows that ascend by variant (prepare_chunk's layout) the
    sorted path adds the same rows in the same order."""
    chunk, dens = real_chunk
    for dt in (torch.float64, torch.float32):
        np.testing.assert_array_equal(
            _port(chunk, dens, dt, rows_sorted=True), _port(chunk, dens, dt)
        )


def test_padding_rows_are_dropped():
    """Rows at var == n_var land in the trash segment, whatever else
    they hold."""
    chunk, dens = make_synthetic_chunk(n_var=6, frags_per_var=4)
    base = _port(chunk, dens, torch.float64)
    reads = {k: np.array(v) for k, v in chunk.reads.items()}
    pairs = {k: np.array(v) for k, v in chunk.pairs.items()}
    pad_r = reads["var"] == chunk.n_var
    pad_p = pairs["var"] == chunk.n_var
    assert pad_r.any() and pad_p.any()
    # copy a real read and pair (variant 0's) into every padding row
    for cols, pad in ((reads, pad_r), (pairs, pad_p)):
        for k, v in cols.items():
            if k != "var":
                v[pad] = v[0]
    got = _port(chunk, dens, torch.float64, reads=reads, pairs=pairs)
    np.testing.assert_array_equal(got, base)


def test_counts_invariant_under_read_order():
    chunk, dens = make_synthetic_chunk(n_var=6, frags_per_var=5)
    base = _port(chunk, dens, torch.float64)
    rng = np.random.default_rng(0)
    n = len(chunk.reads["var"])
    n_pair = len(chunk.pairs["var"])
    for _ in range(3):
        perm = rng.permutation(n)
        pair_perm = rng.permutation(n_pair)
        # pairs are self-contained rows — permutable independently
        shuffled = _port(
            chunk, dens, torch.float64,
            reads={k: np.asarray(v)[perm] for k, v in chunk.reads.items()},
            pairs={k: np.asarray(v)[pair_perm] for k, v in chunk.pairs.items()},
        )
        np.testing.assert_allclose(shuffled, base, rtol=0, atol=1e-9)


def _gl(counts, is_dup, lcf):
    n = len(counts)
    return genotype_batch(
        torch.as_tensor(counts, dtype=torch.float64),
        torch.as_tensor(is_dup), torch.zeros(n, dtype=torch.bool), lcf,
    )


def test_gl_argmax_stable_under_count_scaling():
    lcf = torch.as_tensor(log_choose_table(1 << 12, use_f64=True))
    counts = np.array([[30.0, 10.0, 2.0, 20.0, 8.0]])
    no_dup = np.zeros(1, bool)
    base = _gl(counts, no_dup, lcf)
    for s in (2.0, 5.0, 10.0):
        out = _gl(counts * s, no_dup, lcf)
        assert int(out["gt_idx"][0]) == int(base["gt_idx"][0])


def test_scalar_vs_batch_gl_agreement():
    rng = np.random.default_rng(1)
    counts = rng.gamma(2.0, 8.0, size=(64, 5))
    is_dup = rng.random(64) < 0.5
    lcf = torch.as_tensor(log_choose_table(1 << 12, use_f64=True))
    out = _gl(counts, is_dup, lcf)
    for i in range(64):
        r = genotype_from_counts(*counts[i], is_dup=bool(is_dup[i]))
        if r.null:
            assert bool(out["null"][i])
            continue
        assert int(out["gt_idx"][i]) == r.gt_idx, i
        np.testing.assert_allclose(out["gl"][i].numpy(), r.gl, atol=1e-9)
        assert int(out["gq"][i]) == r.gq
        np.testing.assert_allclose(float(out["sq"][i]), r.sq, atol=1e-9)


def test_bayes_gt_likelihood_normalization():
    # sum over k of 10**GL_g = 1 for each genotype column (binomial pmf)
    for is_dup in (False, True):
        for g in range(3):
            n = 40
            total = sum(
                10 ** bayes_gt(n - k, k, is_dup)[g] for k in range(n + 1)
            )
            assert total == pytest.approx(1.0, rel=1e-9)
