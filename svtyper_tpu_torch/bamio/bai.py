"""BAI index: reader, region query, and builder.

Replaces htslib's BAI machinery behind ``pysam.AlignmentFile.fetch``
(reference L0, SURVEY.md §1). Standard UCSC 5-level binning over [0,2^29)
plus a 16 KiB-window linear index; per-reference pseudo-bin 37450 carries
(off_beg, off_end, n_mapped, n_unmapped) with htslib ``idxstats``
semantics (SPEC.md §7).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

PSEUDO_BIN = 37450
_LIN_SHIFT = 14
_LEVELS = ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681))


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


def levels_for(min_shift: int, depth: int) -> Tuple[Tuple[int, int], ...]:
    """(shift, first-bin-id) per level 1..depth, shallow→deep — the
    generic form of the fixed BAI table (CSI §5.1.1 binning scheme)."""
    return tuple(
        (min_shift + 3 * (depth - l), ((1 << (3 * l)) - 1) // 7)
        for l in range(1, depth + 1)
    )


class RefIndex:
    __slots__ = ("bins", "ioffsets", "loffsets", "mapped", "unmapped")

    def __init__(self) -> None:
        self.bins: Dict[int, List[Tuple[int, int]]] = {}
        self.ioffsets: List[int] = []          # BAI linear index
        self.loffsets: Dict[int, int] = {}     # CSI per-bin loffset
        self.mapped = 0
        self.unmapped = 0


class _RefNp:
    """Numpy form of one reference's bins for vectorized queries:
    sorted bin ids, flat chunk arrays indexed by per-bin offsets, and
    the dense linear index (BAI) / per-bin loffsets (CSI)."""

    __slots__ = ("keys", "chunk_off", "cb", "ce", "ioff", "loff")

    def __init__(self, ri: RefIndex) -> None:
        items = sorted(ri.bins.items())
        self.keys = np.asarray([b for b, _ in items], dtype=np.int64)
        counts = [len(cs) for _, cs in items]
        self.chunk_off = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.chunk_off[1:])
        flat = [c for _, cs in items for c in cs]
        self.cb = np.asarray([c[0] for c in flat], dtype=np.uint64)
        self.ce = np.asarray([c[1] for c in flat], dtype=np.uint64)
        self.ioff = np.asarray(ri.ioffsets or [0], dtype=np.uint64)
        self.loff = np.asarray(
            [ri.loffsets.get(b, 0) for b, _ in items], dtype=np.uint64
        )


def _expand_ranges(lo: np.ndarray, count: np.ndarray):
    """(flat values, source-row index) for ``concat(arange(lo_i,
    lo_i+count_i))`` — the standard repeat/arange ragged expansion."""
    total = int(count.sum())
    row = np.repeat(np.arange(len(lo)), count)
    cum0 = np.concatenate(([0], np.cumsum(count)[:-1]))
    vals = np.arange(total, dtype=np.int64) - cum0[row] + lo[row]
    return vals, row


class BaiIndex:
    min_shift = _LIN_SHIFT
    depth = 5

    def __init__(self, refs: List[RefIndex], n_no_coor: int = 0) -> None:
        self.refs = refs
        self.n_no_coor = n_no_coor
        self._np: List[Optional[_RefNp]] = [None] * len(refs)

    def _np_ref(self, tid: int) -> _RefNp:
        r = self._np[tid]
        if r is None:
            r = self._np[tid] = _RefNp(self.refs[tid])
        return r

    def _levels(self) -> Tuple[Tuple[int, int], ...]:
        return levels_for(self.min_shift, self.depth)

    def _min_offsets(self, rn: _RefNp, b: np.ndarray) -> np.ndarray:
        """Per-region virtual-offset lower bound for region starts
        ``b`` — BAI: the 16 KiB-window linear index."""
        w = np.minimum(b >> _LIN_SHIFT, len(rn.ioff) - 1)
        return rn.ioff[w]

    def _min_offset_scalar(self, ri: RefIndex, beg: int) -> int:
        if not ri.ioffsets:
            return 0
        w = min(beg >> _LIN_SHIFT, len(ri.ioffsets) - 1)
        return ri.ioffsets[w]

    def _reg2bins(self, beg: int, end: int) -> List[int]:
        end -= 1
        bins = [0]
        for shift, off in self._levels():
            bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
        return bins

    def query_many(
        self, tids: np.ndarray, begs: np.ndarray, ends: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized :meth:`query` over many regions.

        Returns ``(row_off, cb, ce)``: region *i*'s merged chunks are
        ``cb/ce[row_off[i]:row_off[i+1]]`` — identical to per-region
        ``query`` output. Regions with invalid tids get zero chunks.
        """
        nq = len(tids)
        tids = np.asarray(tids, dtype=np.int64)
        begs = np.asarray(begs, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        out_cb: List[np.ndarray] = []
        out_ce: List[np.ndarray] = []
        out_rid: List[np.ndarray] = []
        for tid in np.unique(tids):
            if tid < 0 or tid >= len(self.refs):
                continue
            rn = self._np_ref(int(tid))
            if not len(rn.keys):
                continue
            qi = np.flatnonzero(tids == tid)
            # clamp degenerate regions (end <= beg) to a single-position
            # query so output matches per-region ``query`` behavior
            b, e = begs[qi], np.maximum(ends[qi] - 1, begs[qi])
            # candidate bins: bin 0 + one contiguous id range per level
            cand_parts = [np.zeros(len(qi), dtype=np.int64)]
            rid_parts = [np.arange(len(qi))]
            for shift, off in self._levels():
                lo = off + (b >> shift)
                cnt = (e >> shift) - (b >> shift) + 1
                vals, row = _expand_ranges(lo, cnt)
                cand_parts.append(vals)
                rid_parts.append(row)
            cand = np.concatenate(cand_parts)
            rid = np.concatenate(rid_parts)
            # bin lookup → chunk spans → flat chunk rows
            pos = np.searchsorted(rn.keys, cand)
            ok = (pos < len(rn.keys)) & (rn.keys[np.minimum(pos, len(rn.keys) - 1)] == cand)
            pos, rid = pos[ok], rid[ok]
            ci, crow = _expand_ranges(
                rn.chunk_off[pos], rn.chunk_off[pos + 1] - rn.chunk_off[pos]
            )
            rid = rid[crow]
            cb, ce = rn.cb[ci], rn.ce[ci]
            # per-region virtual-offset lower bound
            mo = self._min_offsets(rn, b)[rid]
            keep = ce > mo
            cb, ce, rid, mo = cb[keep], ce[keep], rid[keep], mo[keep]
            cb = np.maximum(cb, mo)
            out_cb.append(cb)
            out_ce.append(ce)
            out_rid.append(qi[rid])
        row_off = np.zeros(nq + 1, dtype=np.int64)
        if not out_cb:
            return row_off, np.zeros(0, np.uint64), np.zeros(0, np.uint64)
        cb = np.concatenate(out_cb)
        ce = np.concatenate(out_ce)
        rid = np.concatenate(out_rid)
        order = np.lexsort((cb, rid))
        cb, ce, rid = cb[order], ce[order], rid[order]
        # sorted (region, cb) interval merge; few chunks per region, so a
        # tight scalar pass beats fighting segment-cummax in numpy
        m_cb: List[int] = []
        m_ce: List[int] = []
        m_rid: List[int] = []
        last_r = -1
        for r, s, t in zip(rid.tolist(), cb.tolist(), ce.tolist()):
            if r == last_r and s <= m_ce[-1]:
                if t > m_ce[-1]:
                    m_ce[-1] = t
            else:
                m_cb.append(s)
                m_ce.append(t)
                m_rid.append(r)
                last_r = r
        np.add.at(row_off, np.asarray(m_rid, dtype=np.int64) + 1, 1)
        np.cumsum(row_off, out=row_off)
        return (
            row_off,
            np.asarray(m_cb, dtype=np.uint64),
            np.asarray(m_ce, dtype=np.uint64),
        )

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as fh:
            buf = fh.read()
        if buf[:4] != b"BAI\x01":
            raise ValueError("not a BAI file: %s" % path)
        off = 4
        (n_ref,) = struct.unpack_from("<i", buf, off)
        off += 4
        refs: List[RefIndex] = []
        for _ in range(n_ref):
            ri = RefIndex()
            (n_bin,) = struct.unpack_from("<i", buf, off)
            off += 4
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", buf, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", buf, off)
                    off += 16
                    chunks.append((cb, ce))
                if bin_id == PSEUDO_BIN and len(chunks) == 2:
                    ri.mapped, ri.unmapped = chunks[1]
                else:
                    ri.bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", buf, off)
            off += 4
            ri.ioffsets = list(
                struct.unpack_from("<%dQ" % n_intv, buf, off)
            )
            off += 8 * n_intv
            refs.append(ri)
        n_no_coor = 0
        if off + 8 <= len(buf):
            (n_no_coor,) = struct.unpack_from("<Q", buf, off)
        return cls(refs, n_no_coor)

    def query(self, tid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged, sorted virtual-offset chunks that may contain reads
        overlapping [beg, end) on tid."""
        if tid < 0 or tid >= len(self.refs):
            return []
        ri = self.refs[tid]
        min_off = self._min_offset_scalar(ri, beg)
        chunks: List[Tuple[int, int]] = []
        for b in self._reg2bins(beg, end):
            for cb, ce in ri.bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                if ce > merged[-1][1]:
                    merged[-1] = (merged[-1][0], ce)
            else:
                merged.append((cb, ce))
        return merged

    def idxstats(self) -> List[Tuple[int, int]]:
        """(mapped, unmapped) per reference (SPEC.md §7 mapped counts)."""
        return [(r.mapped, r.unmapped) for r in self.refs]

    def save(self, path: str) -> None:
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", len(self.refs))
        for ri in self.refs:
            bins = dict(ri.bins)
            n_bin = len(bins) + (1 if (ri.mapped or ri.unmapped or bins) else 0)
            out += struct.pack("<i", n_bin)
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            if n_bin > len(bins):
                off_beg = min((c[0] for cs in bins.values() for c in cs), default=0)
                off_end = max((c[1] for cs in bins.values() for c in cs), default=0)
                out += struct.pack("<Ii", PSEUDO_BIN, 2)
                out += struct.pack("<QQ", off_beg, off_end)
                out += struct.pack("<QQ", ri.mapped, ri.unmapped)
            out += struct.pack("<i", len(ri.ioffsets))
            out += struct.pack("<%dQ" % len(ri.ioffsets), *ri.ioffsets)
        out += struct.pack("<Q", self.n_no_coor)
        with open(path, "wb") as fh:
            fh.write(out)


class BaiBuilder:
    """Accumulates (tid, pos, ref_end, voff_start, voff_end) per record in
    file order and emits a :class:`BaiIndex`."""

    def __init__(self, n_ref: int) -> None:
        self.refs = [RefIndex() for _ in range(n_ref)]
        self._lin: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
        self.n_no_coor = 0
        self._last: Tuple[int, int] = (-1, -1)

    def add(
        self,
        tid: int,
        pos: int,
        ref_end: int,
        vo_beg: int,
        vo_end: int,
        is_mapped: bool,
    ) -> None:
        if tid < 0:
            self.n_no_coor += 1
            return
        # readers early-stop on sorted order; an unsorted index would
        # silently drop reads, so fail loudly here
        if (tid, pos) < self._last:
            raise ValueError(
                "records not in coordinate order: (%d,%d) after (%d,%d)"
                % (tid, pos, *self._last)
            )
        self._last = (tid, pos)
        ri = self.refs[tid]
        if is_mapped:
            ri.mapped += 1
        else:
            ri.unmapped += 1
            ref_end = max(ref_end, pos + 1)
        b = reg2bin(pos, max(ref_end, pos + 1))
        chunks = ri.bins.setdefault(b, [])
        if chunks and vo_beg <= chunks[-1][1]:
            chunks[-1] = (chunks[-1][0], max(chunks[-1][1], vo_end))
        else:
            chunks.append((vo_beg, vo_end))
        lin = self._lin[tid]
        for w in range(pos >> _LIN_SHIFT, (max(ref_end, pos + 1) - 1 >> _LIN_SHIFT) + 1):
            if w not in lin or vo_beg < lin[w]:
                lin[w] = vo_beg

    def add_bulk(
        self,
        tid: np.ndarray,
        pos: np.ndarray,
        ref_end: np.ndarray,
        vo_beg: np.ndarray,
        vo_end: np.ndarray,
        is_mapped: np.ndarray,
    ) -> None:
        """Vectorized :meth:`add` over coordinate-ordered record arrays
        (the bulk ``-w`` writer's path; identical index to the scalar
        loop). vo arrays must be nondecreasing (file order)."""
        tid = np.asarray(tid, np.int64)
        pos = np.asarray(pos, np.int64)
        keep = tid >= 0
        self.n_no_coor += int((~keep).sum())
        if not keep.all():
            tid, pos = tid[keep], pos[keep]
            ref_end = np.asarray(ref_end, np.int64)[keep]
            vo_beg = np.asarray(vo_beg, np.int64)[keep]
            vo_end = np.asarray(vo_end, np.int64)[keep]
            is_mapped = np.asarray(is_mapped, bool)[keep]
        else:
            ref_end = np.asarray(ref_end, np.int64)
            vo_beg = np.asarray(vo_beg, np.int64)
            vo_end = np.asarray(vo_end, np.int64)
            is_mapped = np.asarray(is_mapped, bool)
        n = len(tid)
        if not n:
            return
        if (np.diff(tid) < 0).any() or (
            (np.diff(tid) == 0) & (np.diff(pos) < 0)
        ).any() or (int(tid[0]), int(pos[0])) < self._last:
            raise ValueError("records not in coordinate order (bulk)")
        self._last = (int(tid[-1]), int(pos[-1]))
        # both the bin and the linear window use max(ref_end, pos+1)
        # (the scalar path's unmapped ref_end bump collapses into this)
        end2 = np.maximum(ref_end, pos + 1)
        for t in np.unique(tid):
            rows = tid == t
            ri = self.refs[int(t)]
            ri.mapped += int(is_mapped[rows].sum())
            ri.unmapped += int((~is_mapped[rows]).sum())
        # vectorized reg2bin (same 5-level cascade as the scalar form)
        e = end2 - 1
        bins = np.zeros(n, dtype=np.int64)
        for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585),
                           (14, 4681)):
            m = (pos >> shift) == (e >> shift)
            bins = np.where(m, off + (pos >> shift), bins)
        # chunk runs: group rows by (tid, bin) keeping file order; a new
        # chunk starts where this row's vo_beg exceeds the group's
        # previous vo_end (matches the scalar merge rule; vo_end is
        # nondecreasing so the run's last row carries its max)
        order = np.lexsort((np.arange(n), bins, tid))
        st, sb = tid[order], bins[order]
        svb, sve = vo_beg[order], vo_end[order]
        newgrp = np.concatenate(
            ([True], (st[1:] != st[:-1]) | (sb[1:] != sb[:-1]))
        )
        prev_end = np.concatenate(([0], sve[:-1]))
        newchunk = newgrp | (svb > prev_end)
        starts = np.flatnonzero(newchunk)
        ends = np.concatenate((starts[1:], [n])) - 1
        for k in range(len(starts)):
            s0 = starts[k]
            ri = self.refs[int(st[s0])]
            chunks = ri.bins.setdefault(int(sb[s0]), [])
            cb, ce = int(svb[s0]), int(sve[ends[k]])
            if newgrp[s0] and chunks and cb <= chunks[-1][1]:
                # first run of this (tid,bin) may merge with a chunk
                # left by an earlier add()/add_bulk() call
                chunks[-1] = (chunks[-1][0], max(chunks[-1][1], ce))
            else:
                chunks.append((cb, ce))
        # linear index: min vo_beg per 16 KiB window; w1 > w0 + 1 only
        # for multi-window spans (long D/N cigars) — scalar fallback
        w0 = pos >> _LIN_SHIFT
        w1 = (end2 - 1) >> _LIN_SHIFT
        for t in np.unique(tid):
            rows = np.flatnonzero(tid == t)
            lin = self._lin[int(t)]
            hi = int(w1[rows].max())
            arr = np.full(hi + 1, np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(arr, w0[rows], vo_beg[rows])
            np.minimum.at(arr, w1[rows], vo_beg[rows])
            wide = rows[(w1[rows] - w0[rows]) > 1]
            for i in wide:
                arr[int(w0[i]) + 1 : int(w1[i])] = np.minimum(
                    arr[int(w0[i]) + 1 : int(w1[i])], vo_beg[i]
                )
            for w in np.flatnonzero(arr != np.iinfo(np.int64).max):
                v = int(arr[w])
                wi = int(w)
                if wi not in lin or v < lin[wi]:
                    lin[wi] = v

    def finish(self) -> BaiIndex:
        for tid, ri in enumerate(self.refs):
            lin = self._lin[tid]
            if lin:
                n = max(lin) + 1
                ioff = []
                prev = 0
                for w in range(n):
                    prev = lin.get(w, prev)
                    ioff.append(prev)
                ri.ioffsets = ioff
        return BaiIndex(self.refs, self.n_no_coor)
