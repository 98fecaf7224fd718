"""Columnar read batches (structure-of-arrays).

The unit of data flowing out of ``bamio`` and into ``evidence``: all reads
of one BAM region fetch, decoded into dense numpy columns. This replaces
the reference's per-read ``pysam.AlignedSegment`` objects (SURVEY.md §3.1
inner hot loop) so classification is vectorized and, downstream, feedable
to the TPU as fixed-shape tensors.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# flag bits (SAM spec)
FPAIRED = 0x1
FPROPER = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

_FIELDS = [
    ("tid", np.int32),
    ("pos", np.int32),
    ("ref_end", np.int32),
    ("flag", np.uint16),
    ("mapq", np.uint8),
    ("tlen", np.int32),
    ("mate_tid", np.int32),
    ("mate_pos", np.int32),
    ("qname_hash", np.uint64),
    ("left_soft", np.int32),
    ("right_soft", np.int32),
    ("ref_aln_len", np.int32),
    ("query_len", np.int32),
    ("lead_clip_q", np.int32),
    ("lib_id", np.int32),
    ("has_sa", np.bool_),
    ("sa_tid", np.int32),
    ("sa_pos", np.int32),
    ("sa_end", np.int32),
    ("sa_is_reverse", np.bool_),
    ("sa_mapq", np.uint8),
    ("sa_lead_clip_q", np.int32),
    ("voffset", np.uint64),
    # §4.1 aligned-coverage predicates, filled by bamcore fetch_many when
    # a FetchFilter supplies breakpoint coords (zeros otherwise)
    ("cov_a", np.bool_),
    ("cov_b", np.bool_),
]

FIELD_NAMES = [name for name, _ in _FIELDS]


class ReadBatch:
    """Dense columns for a batch of primary alignments.

    Aligned-reference blocks (CIGAR M/=/X runs, SPEC.md §4.1) are ragged:
    ``blk_start/blk_end[blk_off[i]:blk_off[i+1]]`` are read *i*'s blocks.
    """

    __slots__ = FIELD_NAMES + ["blk_off", "blk_start", "blk_end", "n"]

    def __init__(self, n: int = 0) -> None:
        self.n = n
        for name, dt in _FIELDS:
            setattr(self, name, np.zeros(n, dtype=dt))
        self.blk_off = np.zeros(n + 1, dtype=np.int64)
        self.blk_start = np.zeros(0, dtype=np.int32)
        self.blk_end = np.zeros(0, dtype=np.int32)

    @classmethod
    def from_columns(cls, cols: Dict[str, np.ndarray]) -> "ReadBatch":
        b = cls.__new__(cls)
        n = len(cols["pos"])
        b.n = n
        for name, dt in _FIELDS:
            if name in cols:
                arr = np.asarray(cols[name], dtype=dt)
                assert len(arr) == n
            else:  # decoders without this column (e.g. cov_* pre-filter)
                arr = np.zeros(n, dtype=dt)
            setattr(b, name, arr)
        if "blk_off" in cols:
            b.blk_off = np.asarray(cols["blk_off"], dtype=np.int64)
            b.blk_start = np.asarray(cols["blk_start"], dtype=np.int32)
            b.blk_end = np.asarray(cols["blk_end"], dtype=np.int32)
        else:  # blocks skipped (FetchFilter.want_blocks=False)
            b.blk_off = np.zeros(n + 1, dtype=np.int64)
            b.blk_start = np.zeros(0, dtype=np.int32)
            b.blk_end = np.zeros(0, dtype=np.int32)
        return b

    @property
    def is_reverse(self) -> np.ndarray:
        return (self.flag & FREVERSE) != 0

    def take(self, idx: np.ndarray) -> "ReadBatch":
        """Row subset (rebuilds the ragged block arrays)."""
        out = ReadBatch.__new__(ReadBatch)
        out.n = int(len(idx))
        for name in FIELD_NAMES:
            setattr(out, name, getattr(self, name)[idx])
        counts = (self.blk_off[1:] - self.blk_off[:-1])[idx]
        out.blk_off = np.zeros(out.n + 1, dtype=np.int64)
        np.cumsum(counts, out=out.blk_off[1:])
        sel = _ragged_gather_indices(self.blk_off, idx)
        out.blk_start = self.blk_start[sel]
        out.blk_end = self.blk_end[sel]
        return out

    @staticmethod
    def concat(batches: List["ReadBatch"]) -> "ReadBatch":
        batches = [b for b in batches if b.n]
        if not batches:
            return ReadBatch(0)
        if len(batches) == 1:
            return batches[0]
        out = ReadBatch.__new__(ReadBatch)
        out.n = sum(b.n for b in batches)
        for name in FIELD_NAMES:
            setattr(
                out, name, np.concatenate([getattr(b, name) for b in batches])
            )
        offs = [b.blk_off for b in batches]
        shift = np.cumsum([0] + [o[-1] for o in offs[:-1]])
        out.blk_off = np.concatenate(
            [offs[0]] + [o[1:] + s for o, s in zip(offs[1:], shift[1:])]
        )
        out.blk_start = np.concatenate([b.blk_start for b in batches])
        out.blk_end = np.concatenate([b.blk_end for b in batches])
        return out


def _ragged_gather_indices(off: np.ndarray, idx: np.ndarray) -> np.ndarray:
    starts = off[idx]
    counts = off[np.asarray(idx) + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.repeat(starts - np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    return out + np.arange(total, dtype=np.int64)


def coverage_from_blocks(
    batch: "ReadBatch", p0: np.ndarray, tid: np.ndarray, min_aligned: int
) -> np.ndarray:
    """SPEC.md §4.1 aligned-coverage predicate from the ragged block
    arrays: M/=/X overlap with [p0-min_aligned+1, p0+min_aligned+1) must
    equal 2*min_aligned. Python-fallback twin of the bamcore inline
    computation (FetchFilter cov_*)."""
    n = batch.n
    if n == 0:
        return np.zeros(0, dtype=bool)
    counts = np.diff(batch.blk_off)
    row = np.repeat(np.arange(n), counts)
    lo = (p0 - min_aligned + 1)[row]
    hi = (p0 + min_aligned + 1)[row]
    ov = np.clip(
        np.minimum(batch.blk_end, hi) - np.maximum(batch.blk_start, lo),
        0,
        None,
    )
    cov = np.zeros(n, dtype=np.int64)
    np.add.at(cov, row, ov)
    return (cov == 2 * min_aligned) & (batch.tid == tid)


def qname_hash_bytes(qname: bytes) -> int:
    """FNV-1a 64-bit hash used to group fragments by query name."""
    h = 0xCBF29CE484222325
    for byte in qname:
        h ^= byte
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h
