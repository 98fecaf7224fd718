"""The port's GL stage (svtyper_tpu_torch.ops) against the JAX package.

- the tables: equal to jax's exactly;
- ``ops.gl.genotype_batch``: the f64 branch matches jax's on the random
  and adversarial grids (ints exact, floats to 1e-12 relative: the port
  takes log10(p) from the math.log10 table and torch's pow/log10 differ
  from XLA's by an ulp); the f32 branch's int fields are bit-exact;
- ``ops.gl_kernel.genotype_rows_plain`` (the CUDA kernel's twin) against
  ``genotype_batch_pallas(interpret=True)``: ints bit-exact, floats at
  output-format precision (torch.lgamma vs the kernel's Stirling form).

Inputs are made with numpy from fixed seeds and handed to both sides.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svtyper_tpu.ops import gl as jgl
from svtyper_tpu.ops.pallas_gl import genotype_batch_pallas
from svtyper_tpu_torch.gt.engine import INT_FIELDS
from svtyper_tpu_torch.ops import gl as tgl
from svtyper_tpu_torch.ops import gl_kernel
from svtyper_tpu_torch.utils.parity import (
    adversarial_counts,
    assert_format_parity,
    random_counts,
    rows_split,
)

GRIDS = {"random": random_counts, "adversarial": adversarial_counts}
INT_KEYS = [k for k in INT_FIELDS if k != "ab_valid"]


def test_tables_equal_jax():
    np.testing.assert_array_equal(tgl.LOG_P_TABLE, jgl.LOG_P_TABLE)
    np.testing.assert_array_equal(tgl.LOG_Q_TABLE, jgl.LOG_Q_TABLE)
    for use_f64 in (True, False):
        a = tgl.log_choose_table(4096, use_f64)
        b = jgl.log_choose_table(4096, use_f64)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _both(counts, is_dup, force_null, f64, sw=1.0, dw=1.0, maxn=1 << 12):
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    ref = jgl.genotype_batch(
        jnp.asarray(counts, dtype=jdt),
        jnp.asarray(is_dup),
        jnp.asarray(force_null),
        jnp.asarray(jgl.log_choose_table(maxn, use_f64=f64)),
        split_weight=sw,
        disc_weight=dw,
    )
    got = tgl.genotype_batch(
        torch.tensor(counts, dtype=tdt),
        torch.tensor(is_dup),
        torch.tensor(force_null),
        torch.tensor(tgl.log_choose_table(maxn, use_f64=f64)),
        split_weight=sw,
        disc_weight=dw,
    )
    return ref, got


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("weights", [(1.0, 1.0), (0.5, 2.0)])
def test_genotype_batch_f64_matches_jax(grid, weights):
    counts, is_dup, force_null = GRIDS[grid](2048)
    ref, got = _both(counts, is_dup, force_null, True, *weights)
    for key in INT_KEYS + ["null", "ab_valid"]:
        np.testing.assert_array_equal(
            got[key].numpy(), np.asarray(ref[key]), err_msg=key
        )
    for key in ("gl", "sq", "ab"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(ref[key]), rtol=1e-12, atol=1e-12,
            err_msg=key,
        )


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_genotype_batch_f32_ints_bit_exact(grid):
    counts, is_dup, force_null = GRIDS[grid](2048)
    ref, got = _both(counts, is_dup, force_null, False)
    for key in INT_KEYS + ["null", "ab_valid"]:
        np.testing.assert_array_equal(
            got[key].numpy(), np.asarray(ref[key]), err_msg=key
        )
    # AB shares the f32 summation order exactly
    np.testing.assert_array_equal(got["ab"].numpy(), np.asarray(ref["ab"]))


def _pallas(counts, is_dup, force_null):
    ints, flts = genotype_batch_pallas(
        jnp.asarray(counts.T, dtype=jnp.float32),
        jnp.asarray(is_dup),
        jnp.asarray(force_null),
        interpret=True,
    )
    return np.asarray(ints), np.asarray(flts)


def _twin(counts, is_dup, force_null):
    return gl_kernel.genotype_rows_plain(
        torch.tensor(counts, dtype=torch.float32),
        torch.tensor(is_dup, dtype=torch.uint8),
        torch.tensor(force_null, dtype=torch.uint8),
    ).numpy()


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_plain_twin_matches_pallas_interpret(grid):
    n = 1024
    counts, is_dup, force_null = GRIDS[grid](n)
    p_ints, p_flts = _pallas(counts, is_dup, force_null)
    rows = _twin(counts, is_dup, force_null)
    assert rows.shape == (n, 24) and rows.dtype == np.float32
    _, t_ints, t_flts = rows_split(rows)
    np.testing.assert_array_equal(t_ints, p_ints)
    ref = {
        "null": p_ints[0] != 0,
        "gl": p_flts[:3].T,
        "sq": p_flts[3],
        "ab": p_flts[4],
        "ab_valid": p_ints[13] != 0,
    }
    assert_format_parity(ref, t_ints, t_flts, n)
    # the five counts pass through untouched
    np.testing.assert_array_equal(t_flts[5:], p_flts[5:])


def test_plain_twin_matches_f32_genotype_batch():
    """The twin and the f32 branch of ops.gl build GT/GQ from the same
    lc-free scores: int fields equal, GL/SQ at format precision."""
    counts, is_dup, force_null = random_counts(1024, seed=3)
    _, got = _both(counts, is_dup, force_null, False)
    rows = _twin(counts, is_dup, force_null)
    ref, ints, flts = rows_split(rows)
    for i, key in enumerate(INT_FIELDS):
        np.testing.assert_array_equal(
            ints[i], got[key].numpy().astype(np.int64), err_msg=key
        )
    want = {k: got[k].numpy() for k in ("null", "gl", "sq", "ab", "ab_valid")}
    assert_format_parity(want, ints, flts, 1024)


def test_genotype_rows_dispatch():
    """CPU tensors take the plain twin and launch nothing; the CUDA
    entry refuses CPU tensors instead of falling back."""
    counts, is_dup, force_null = random_counts(64)
    args = (
        torch.tensor(counts, dtype=torch.float32),
        torch.tensor(is_dup, dtype=torch.uint8),
        torch.tensor(force_null, dtype=torch.uint8),
    )
    before = gl_kernel.LAUNCHES
    np.testing.assert_array_equal(
        gl_kernel.genotype_rows(*args).numpy(),
        gl_kernel.genotype_rows_plain(*args).numpy(),
    )
    assert gl_kernel.LAUNCHES == before
    with pytest.raises(ValueError):
        gl_kernel.genotype_rows_cuda(*args)
    with pytest.raises(ValueError):
        gl_kernel.genotype_rows(*(a.to("meta") for a in args))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 31, 33, 1000, 4096, 4097])
def test_kernel_matches_twin_on_card(n):
    """The CUDA kernel against its twin on the card (the same check as
    chip_smoke.py phase 3), at N below, at and off a multiple of its
    32-variant tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for grid in GRIDS.values():
        counts, is_dup, force_null = grid(n)
        args = (
            torch.tensor(counts, dtype=torch.float32, device="cuda"),
            torch.tensor(is_dup, dtype=torch.uint8, device="cuda"),
            torch.tensor(force_null, dtype=torch.uint8, device="cuda"),
        )
        got = gl_kernel.genotype_rows_cuda(*args).cpu().numpy()
        want = gl_kernel.genotype_rows_plain(*args).cpu().numpy()
        np.testing.assert_array_equal(got[:, :14], want[:, :14])
        ref, _, _ = rows_split(want)
        _, ints, flts = rows_split(got)
        assert_format_parity(ref, ints, flts, n,
                             min_checked=101 if n >= 1000 else 0)
