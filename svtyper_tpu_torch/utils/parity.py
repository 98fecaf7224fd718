"""Format-precision parity checks, free of jax.

Shared by the port's tests and ``chip_smoke.py`` (which runs where jax
is not installed):

- ``random_counts`` / ``adversarial_counts``: the GL test grids of
  ``tests/test_pallas_gl.py``, rebuilt from the same numpy seeds;
- ``adversarial_compact`` / ``edge_compacts``: compact chunks that reach
  every branch and every segment edge of the classify kernel
  (``csrc/classify_kernel.cu``);
- ``assert_format_parity``: a copy of that file's check that two GL
  stages agree at the output contract's precision (SPEC.md §6);
- ``rows_split``: the engine's ``[N,24]`` rows as the (ref dict, ints,
  flts) triple ``assert_format_parity`` takes;
- ``golden_diff``: a record-by-record comparison of a VCF with a golden
  one, integer fields exact and GL/SQ/AB/QUAL within one unit of their
  last printed digit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from svtyper_tpu_torch.evidence.extract import (
    LIB_INVALID,
    VARS_BOOL,
    VARS_I32,
)
from svtyper_tpu_torch.utils.formatting import fmt_g2

N_INT = 14


def random_counts(n, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.gamma(2.0, 10.0, size=(n, 5))
    counts[rng.random(n) < 0.1] = 0.0  # some zero-evidence rows
    counts[:, 3] -= rng.random(n) * 2  # ref_span can dip negative
    is_dup = rng.random(n) < 0.3
    force_null = rng.random(n) < 0.05
    return counts, is_dup, force_null


def adversarial_counts(n, seed=42):
    """Half the rows are small-integer counts, so AB lands on exact
    small rationals (1/16, 3/40, ...) that sit ON or NEAR `%.2g`
    rounding boundaries — the cases where a last-ulp summation-order
    difference between the two stages would flip a printed digit."""
    rng = np.random.default_rng(seed)
    counts = rng.gamma(2.0, 10.0, size=(n, 5))
    m = n // 2
    counts[:m] = rng.integers(0, 40, size=(m, 5)).astype(np.float64)
    counts[rng.random(n) < 0.1] = 0.0
    is_dup = rng.random(n) < 0.3
    force_null = rng.random(n) < 0.05
    return counts, is_dup, force_null


def _compact_around(rng, r_var, p_var, v_cols: int, n_lib: int,
                    width: int):
    """Compact matrices around the variant columns ``r_var`` [1,R] and
    ``p_var`` [1,F] (uint16) → (compact, dens [n_lib, width] float32),
    every other column drawn from ``rng`` to reach every branch of the
    classify kernel: mapq 0 and 255, LIB_INVALID and a library past the
    table, spans below 0, at and past W, int32 wrap (ospan and vlen at
    the int32 limits), zero densities."""
    n_reads, n_pairs = r_var.shape[1], p_var.shape[1]
    big = np.iinfo(np.int32)

    def mapq(n):
        return rng.choice(np.asarray([0, 4, 20, 27, 40, 60, 254, 255],
                                     dtype=np.uint8), n)

    ospan = rng.integers(-8, width + 8, n_pairs).astype(np.int32)
    ospan[::17] = big.min
    ospan[::19] = big.max
    vlen = rng.integers(-width, width, v_cols).astype(np.int32)
    vlen[::5] = big.max
    vlen[2::5] = big.min
    v_i32 = rng.integers(-1000, 1000, (len(VARS_I32), v_cols)).astype(np.int32)
    v_i32[VARS_I32.index("vlen")] = vlen
    dens = rng.random((n_lib, width)).astype(np.float32) * np.float32(0.01)
    dens[:, ::3] = 0  # zero denominators where both lookups land here
    libs = np.asarray([*range(n_lib), n_lib, LIB_INVALID], dtype=np.uint8)
    compact = {
        "cr_u16": r_var,
        "cr_u8": np.stack([mapq(n_reads), mapq(n_reads),
                           rng.integers(0, 32, n_reads).astype(np.uint8)]),
        "cp_u16": p_var,
        "cp_i32": ospan[None],
        "cp_u8": np.stack([
            mapq(n_pairs), mapq(n_pairs), rng.choice(libs, n_pairs),
            rng.integers(0, 16, n_pairs).astype(np.uint8),
        ]),
        "v_i32": v_i32,
        "v_u8": rng.integers(0, 2, (len(VARS_BOOL), v_cols)).astype(np.uint8),
    }
    return compact, dens


def adversarial_compact(seed: int = 3, n_var: int = 40, n_reads: int = 704,
                        n_pairs: int = 500, n_lib: int = 3, width: int = 64):
    """Compact matrices and dens [n_lib, width] float32 that reach every
    branch of the classify kernel → (compact, dens, n_var): empty
    segments (5, 6 and the last), padding rows at n_var, a library whose
    densities are all zero, and the rows of ``_compact_around``."""
    rng = np.random.default_rng(seed)

    def var_column(n):
        var = rng.integers(0, n_var + 1, n)
        var[(var == 5) | (var == 6) | (var == n_var - 1)] = 7
        var[-n // 10:] = n_var
        return np.sort(var).astype(np.uint16)[None]

    compact, dens = _compact_around(rng, var_column(n_reads),
                                    var_column(n_pairs), n_var, n_lib, width)
    dens[1] = 0
    return compact, dens, n_var


# segment lengths of the edge chunks, (reads, pairs) per variant: around
# the classify kernel's 32-row tile (0, 1, 31-33, 63-65) and one of more
# than 2,000 rows; every segment that starts past row 0 starts off a
# multiple of 32
EDGE_SEGMENTS = {
    "nine segments": ([1, 33, 0, 31, 65, 32, 63, 64, 2049],
                      [33, 2049, 1, 63, 0, 31, 65, 32, 64]),
    "one variant": ([33], [2049]),
    "three variants": ([31, 0, 64], [63, 32, 1]),
    "five variants": ([65, 1, 32, 0, 63], [0, 33, 65, 31, 64]),
    "padding only": ([0, 0, 0], [0, 0, 0]),
}


def edge_compacts(seed: int = 5, n_lib: int = 2, width: int = 64):
    """The edge chunks of ``EDGE_SEGMENTS`` → [(name, compact, dens,
    n_var)]: each table's segments in order, then the padding rows at
    n_var (5-8 reads, 5-6 pairs; the only rows of "padding only"), two
    variant columns past n_var, and the rows of ``_compact_around``. R
    is a multiple of 4 and F even, so the wire's matrices stay
    aligned."""
    rng = np.random.default_rng(seed)
    out = []
    for name, (read_len, pair_len) in EDGE_SEGMENTS.items():
        n_var = len(read_len)

        def var_column(lengths, mult):
            var = np.repeat(np.arange(n_var), lengths)
            pad = 5 + (-(len(var) + 5) % mult)
            return np.concatenate([var, np.full(pad, n_var)]).astype(
                np.uint16)[None]

        compact, dens = _compact_around(
            rng, var_column(read_len, 4), var_column(pair_len, 2),
            n_var + 2, n_lib, width)
        out.append((name, compact, dens, n_var))
    return out


def _away_from_boundary(v, step, eps):
    r = math.fmod(abs(v), step)
    return abs(r - step / 2.0) > eps


def assert_format_parity(ref, ints, flts, n, min_checked=101):
    """Formatted-field agreement between a reference GL stage (dict with
    null/gl/sq/ab/ab_valid) and packed matrices ``ints`` [14,N] /
    ``flts`` [10,N], at the output contract's precision.

    AB (`%.2g`) must agree on EVERY non-null row: both stages accumulate
    ((rs+rp)+alt_split)+ap in f32. GL (`%.0f`) and SQ (`%.2f`) come from
    different lgamma/exp/log10 implementations, so rows whose value sits
    within eps of a printf rounding boundary fall back to a numeric
    assert.
    """
    null_ref = np.asarray(ref["null"]).astype(bool)
    gl_ref = np.asarray(ref["gl"])
    sq_ref = np.asarray(ref["sq"])
    ab_ref = np.asarray(ref["ab"])
    abv = np.asarray(ref["ab_valid"])
    checked_gl = checked_sq = checked_ab = 0
    for i in range(n):
        if null_ref[i]:
            continue
        if abv[i]:
            assert ints[13, i] == 1
            assert fmt_g2(float(flts[4, i])) == fmt_g2(float(ab_ref[i])), (
                i, float(flts[4, i]), float(ab_ref[i])
            )
            checked_ab += 1
        for g in range(3):
            a, b = float(flts[g, i]), float(gl_ref[i, g])
            if _away_from_boundary(b, 1.0, 5e-3):
                assert "%.0f" % a == "%.0f" % b, (i, g, a, b)
                checked_gl += 1
            else:
                assert abs(a - b) < 0.5, (i, g, a, b)
        a, b = float(flts[3, i]), float(sq_ref[i])
        eps = min(2e-3, max(2e-4, 1e-6 * abs(b)))
        if _away_from_boundary(b, 0.01, eps):
            assert "%.2f" % a == "%.2f" % b, (i, a, b)
            checked_sq += 1
        else:
            assert abs(a - b) < 0.01, (i, a, b)
    assert min(checked_gl, checked_sq, checked_ab) >= min_checked, (
        checked_gl, checked_sq, checked_ab
    )


def rows_split(rows: np.ndarray):
    """[N,24] engine rows → (ref dict, ints [14,N], flts [10,N])."""
    rows = np.asarray(rows)
    ints = rows[:, :N_INT].T.astype(np.int64)
    flts = rows[:, N_INT:].T
    ref = {
        "null": ints[0] != 0,
        "gl": rows[:, N_INT: N_INT + 3],
        "sq": rows[:, N_INT + 3],
        "ab": rows[:, N_INT + 4],
        "ab_valid": ints[13] != 0,
    }
    return ref, ints, flts


# FORMAT fields printed as floats, with the unit of their last digit
def _unit_f0(_s):
    return 1.0


def _unit_f2(_s):
    return 0.01


def _unit_g2(s):
    v = abs(float(s))
    return 10.0 ** (math.floor(math.log10(v)) - 1) if v > 0 else 0.01


_FLOAT_FIELDS = {"GL": _unit_f0, "SQ": _unit_f2, "AB": _unit_g2}


def _close(a: str, b: str, unit) -> bool:
    if a == b:
        return True
    if "." in (a, b):
        return False
    return abs(float(a) - float(b)) <= max(unit(a), unit(b)) * (1 + 1e-9)


def golden_diff(got: str, want: str) -> Tuple[int, List[str]]:
    """→ (byte-identical record lines, differences beyond tolerance).

    Headers must be identical. Per record: every column but QUAL and the
    sample columns identical; QUAL within 0.01; GT and every integer
    FORMAT field identical; GL within 1, SQ within 0.01, AB within one
    unit of its second significant digit."""
    g_lines = got.splitlines()
    w_lines = want.splitlines()
    errors: List[str] = []
    g_head = [l for l in g_lines if l.startswith("#")]
    w_head = [l for l in w_lines if l.startswith("#")]
    if g_head != w_head:
        errors.append("header differs")
    g_body = [l for l in g_lines if not l.startswith("#")]
    w_body = [l for l in w_lines if not l.startswith("#")]
    if len(g_body) != len(w_body):
        errors.append("record count %d != %d" % (len(g_body), len(w_body)))
    identical = 0
    for g, w in zip(g_body, w_body):
        if g == w:
            identical += 1
            continue
        gc, wc = g.split("\t"), w.split("\t")
        rid = wc[2] if len(wc) > 2 else "?"
        if len(gc) != len(wc) or gc[:5] + gc[6:9] != wc[:5] + wc[6:9]:
            errors.append("%s: fixed columns differ" % rid)
            continue
        if not _close(gc[5], wc[5], _unit_f2):
            errors.append("%s: QUAL %s vs %s" % (rid, gc[5], wc[5]))
        keys = wc[8].split(":")
        for gs, ws in zip(gc[9:], wc[9:]):
            gv: Dict[str, str] = dict(zip(keys, gs.split(":")))
            wv: Dict[str, str] = dict(zip(keys, ws.split(":")))
            for key in keys:
                a, b = gv.get(key), wv.get(key)
                if key in _FLOAT_FIELDS and a is not None and b is not None:
                    pa, pb = a.split(","), b.split(",")
                    ok = len(pa) == len(pb) and all(
                        _close(x, y, _FLOAT_FIELDS[key])
                        for x, y in zip(pa, pb)
                    )
                else:
                    ok = a == b
                if not ok:
                    errors.append("%s: %s %s vs %s" % (rid, key, a, b))
    return identical, errors
