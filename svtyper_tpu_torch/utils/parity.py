"""Format-precision parity checks, free of jax.

Shared by the port's tests and ``chip_smoke.py`` (which runs where jax
is not installed):

- ``random_counts`` / ``adversarial_counts``: the GL test grids of
  ``tests/test_pallas_gl.py``, rebuilt from the same numpy seeds;
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

from svtyper_tpu.utils.formatting import fmt_g2

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
