"""Deterministic synthetic ChunkInputs — no BAM I/O.

Used by ``__graft_entry__`` (compile checks), ``dryrun_multichip``, and
kernel microbenchmarks. The pattern per variant: concordant pairs
bracketing both breakpoints, reads sequencing through them, one SA
split and one soft-clip at the junction — so every predicate branch of
``evidence.device.classify`` is exercised with nonzero counts.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from svtyper_tpu_torch.evidence.extract import (
    PAIR_FIELDS,
    READ_FIELDS_D,
    VAR_FIELDS,
    ChunkInputs,
)

PAIR_FIELDS_D = {name: dt for name, dt in PAIR_FIELDS}


def _pad(d, dtypes, size, fill):
    out = {}
    for k, arr in d.items():
        padded = np.full(size, fill.get(k, 0), dtype=dtypes[k])
        padded[: len(arr)] = arr
        out[k] = padded
    return out


def make_synthetic_chunk(
    n_var: int = 8,
    frags_per_var: int = 8,
    read_len: int = 150,
    insert: int = 350,
    svlen: int = 3000,
) -> Tuple[ChunkInputs, np.ndarray]:
    """→ (ChunkInputs, dens[1, W]) for DEL-type variants."""
    R = n_var * (frags_per_var * 2 + 2)
    reads = {k: np.zeros(R, dtype=dt) for k, dt in READ_FIELDS_D.items()}
    p_var, p_a, p_b = [], [], []
    v = {name: np.zeros(n_var, dtype=dt) for name, dt in VAR_FIELDS}

    row = 0
    for vi in range(n_var):
        pos_a = 10_000 + vi * (svlen + 10_000)
        pos_b = pos_a + svlen
        v["tid_a"][vi] = 0
        v["pos_a"][vi] = pos_a
        v["tid_b"][vi] = 0
        v["pos_b"][vi] = pos_b
        v["o2"][vi] = True  # DEL orientation (+,-)
        v["is_del"][vi] = True
        v["vlen"][vi] = svlen

        def add_read(pos, is_rev, lsoft=False, rsoft=False, sa=None,
                     cov_a=False, cov_b=False):
            nonlocal row
            reads["var"][row] = vi
            reads["is_rev"][row] = is_rev
            reads["pos"][row] = pos
            reads["end"][row] = pos + read_len
            reads["mapq"][row] = 60
            reads["has_lsoft"][row] = lsoft
            reads["has_rsoft"][row] = rsoft
            reads["cov_a"][row] = cov_a
            reads["cov_b"][row] = cov_b
            if sa is not None:
                reads["has_sa"][row] = True
                reads["sa_pos"][row] = sa
                reads["sa_end"][row] = sa + read_len
                reads["sa_mapq"][row] = 60
                reads["sa_lead"][row] = read_len // 2
            row += 1
            return row - 1

        for fi in range(frags_per_var):
            # concordant pair bracketing A (ref evidence)
            a = add_read(pos_a - insert + fi, False, cov_a=(fi % 2 == 0))
            b = add_read(pos_a + fi, True, cov_b=(fi % 3 == 0))
            p_var.append(vi)
            p_a.append(a)
            p_b.append(b)
        # one SA split (junction A→B) and one soft-clip at A
        add_read(pos_a - read_len + 1, False, sa=pos_b)
        add_read(pos_a - read_len + 1, False, rsoft=True)

    # materialize both mates' fields (extract.prepare_chunk contract)
    ai = np.asarray(p_a, dtype=np.int64)
    bi = np.asarray(p_b, dtype=np.int64)
    pairs = {
        "var": np.asarray(p_var, dtype=np.int32),
        "a_pos": reads["pos"][ai], "a_end": reads["end"][ai],
        "b_pos": reads["pos"][bi], "b_end": reads["end"][bi],
        "a_tid": reads["tid"][ai], "b_tid": reads["tid"][bi],
        "a_aln": np.full(len(ai), read_len, np.int16),
        "b_aln": np.full(len(bi), read_len, np.int16),
        "a_lib": np.zeros(len(ai), np.int16),
        "a_rev": reads["is_rev"][ai], "b_rev": reads["is_rev"][bi],
        "a_mapq": reads["mapq"][ai], "b_mapq": reads["mapq"][bi],
    }
    r_pad, f_pad = _next_pow2(R), _next_pow2(len(p_var), 64)
    reads = _pad(reads, READ_FIELDS_D, r_pad, {"var": n_var})
    pairs = _pad(
        pairs,
        PAIR_FIELDS_D,
        f_pad,
        {"var": n_var, "a_tid": -1, "b_tid": -1},
    )
    dens = np.zeros((1, 1024), dtype=np.float64)
    dens[0, insert - 25 : insert + 25] = 1.0 / 50
    return ChunkInputs(reads, pairs, {k: np.asarray(a) for k, a in v.items()}, n_var), dens


def _next_pow2(n: int, floor: int = 256) -> int:
    b = floor
    while b < n:
        b *= 2
    return b
