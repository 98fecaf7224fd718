"""CSI index: reader, region query, and builder.

The CSI format generalizes BAI binning (configurable ``min_shift`` /
``depth``, per-bin ``loffset`` instead of a linear index) and is what
htslib produces for references longer than 2^29-1 bp — the reference
gets it transparently via ``pysam.AlignmentFile.fetch`` (L0, SURVEY.md
§1). The file body is BGZF-compressed.

``CsiIndex`` shares the vectorized query machinery of
:class:`svtyper_tpu.bamio.bai.BaiIndex`; only the virtual-offset lower
bound differs (per-bin loffset walk-up vs the 16 KiB linear index).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from svtyper_tpu_torch.bamio.bai import (
    BaiIndex,
    RefIndex,
    _RefNp,
    levels_for,
)
from svtyper_tpu_torch.bamio.bgzf import BgzfWriter, decompress_block

CSI_MAGIC = b"CSI\x01"


def max_bins(depth: int) -> int:
    """Total bins across levels 0..depth (= first invalid bin id)."""
    return ((1 << (3 * (depth + 1))) - 1) // 7


def reg2bin_g(beg: int, end: int, min_shift: int, depth: int) -> int:
    """Smallest bin containing [beg, end) in a (min_shift, depth)
    scheme — the generic form of ``bai.reg2bin``."""
    end -= 1
    s, l = min_shift, depth
    while l > 0:
        if beg >> s == end >> s:
            return ((1 << (3 * l)) - 1) // 7 + (beg >> s)
        s += 3
        l -= 1
    return 0


def depth_for(max_ref_len: int, min_shift: int = 14) -> int:
    """Smallest depth whose level-1 window covers ``max_ref_len``
    (htslib: BAI's fixed depth 5 spans 2^29; longer needs CSI)."""
    depth = 1
    while (1 << (min_shift + 3 * depth)) < max_ref_len:
        depth += 1
    return max(depth, 5)


class CsiIndex(BaiIndex):
    def __init__(
        self,
        refs: List[RefIndex],
        n_no_coor: int = 0,
        min_shift: int = 14,
        depth: int = 5,
        aux: bytes = b"",
    ) -> None:
        super().__init__(refs, n_no_coor)
        self.min_shift = min_shift
        self.depth = depth
        self.aux = aux

    # -- virtual-offset lower bound: deepest existing bin containing the
    # region start supplies its loffset (htslib csi walk-up) ----------
    def _min_offsets(self, rn: _RefNp, b: np.ndarray) -> np.ndarray:
        mo = np.zeros(len(b), dtype=np.uint64)
        if not len(rn.keys):
            return mo
        unresolved = np.ones(len(b), dtype=bool)
        for shift, off in reversed(self._levels()):
            if not unresolved.any():
                return mo
            cand = off + (b >> shift)
            pos = np.searchsorted(rn.keys, cand)
            ok = (pos < len(rn.keys)) & (
                rn.keys[np.minimum(pos, len(rn.keys) - 1)] == cand
            )
            take = unresolved & ok
            mo[take] = rn.loff[pos[take]]
            unresolved &= ~ok
        if unresolved.any() and rn.keys[0] == 0:
            mo[unresolved] = rn.loff[0]
        return mo

    def _min_offset_scalar(self, ri: RefIndex, beg: int) -> int:
        for shift, off in reversed(self._levels()):
            b = off + (beg >> shift)
            if b in ri.loffsets:
                return ri.loffsets[b]
        return ri.loffsets.get(0, 0)

    # -- file format ---------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "CsiIndex":
        with open(path, "rb") as fh:
            raw = fh.read()
        parts = []
        off = 0
        while off < len(raw):
            data, off = decompress_block(raw, off)
            parts.append(data)
        buf = b"".join(parts)
        if buf[:4] != CSI_MAGIC:
            raise ValueError("not a CSI file: %s" % path)
        min_shift, depth, l_aux = struct.unpack_from("<iii", buf, 4)
        off = 16
        aux = buf[off : off + l_aux]
        off += l_aux
        (n_ref,) = struct.unpack_from("<i", buf, off)
        off += 4
        pseudo = max_bins(depth) + 1
        refs: List[RefIndex] = []
        for _ in range(n_ref):
            ri = RefIndex()
            (n_bin,) = struct.unpack_from("<i", buf, off)
            off += 4
            for _ in range(n_bin):
                bin_id, loff, n_chunk = struct.unpack_from("<IQi", buf, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", buf, off)
                    off += 16
                    chunks.append((cb, ce))
                if bin_id == pseudo and len(chunks) == 2:
                    ri.mapped, ri.unmapped = chunks[1]
                else:
                    ri.bins[bin_id] = chunks
                    ri.loffsets[bin_id] = loff
            refs.append(ri)
        n_no_coor = 0
        if off + 8 <= len(buf):
            (n_no_coor,) = struct.unpack_from("<Q", buf, off)
        return cls(refs, n_no_coor, min_shift, depth, aux)

    def save(self, path: str) -> None:
        out = bytearray(CSI_MAGIC)
        out += struct.pack("<iii", self.min_shift, self.depth, len(self.aux))
        out += self.aux
        out += struct.pack("<i", len(self.refs))
        pseudo = max_bins(self.depth) + 1
        for ri in self.refs:
            bins = dict(ri.bins)
            n_bin = len(bins) + (1 if (ri.mapped or ri.unmapped or bins) else 0)
            out += struct.pack("<i", n_bin)
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out += struct.pack(
                    "<IQi", bin_id, ri.loffsets.get(bin_id, 0), len(chunks)
                )
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            if n_bin > len(bins):
                off_beg = min(
                    (c[0] for cs in bins.values() for c in cs), default=0
                )
                off_end = max(
                    (c[1] for cs in bins.values() for c in cs), default=0
                )
                out += struct.pack("<IQi", pseudo, 0, 2)
                out += struct.pack("<QQ", off_beg, off_end)
                out += struct.pack("<QQ", ri.mapped, ri.unmapped)
        out += struct.pack("<Q", self.n_no_coor)
        with open(path, "wb") as fh:
            w = BgzfWriter(fh)
            w.write(bytes(out))
            w.close()


class CsiBuilder:
    """Accumulates records in file order and emits a :class:`CsiIndex`
    (the CSI twin of ``bai.BaiBuilder``; same add() contract)."""

    def __init__(self, n_ref: int, min_shift: int = 14, depth: int = 5) -> None:
        self.min_shift = min_shift
        self.depth = depth
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
        b = reg2bin_g(pos, max(ref_end, pos + 1), self.min_shift, self.depth)
        chunks = ri.bins.setdefault(b, [])
        if chunks and vo_beg <= chunks[-1][1]:
            chunks[-1] = (chunks[-1][0], max(chunks[-1][1], vo_end))
        else:
            chunks.append((vo_beg, vo_end))
        lin = self._lin[tid]
        for w in range(
            pos >> self.min_shift,
            ((max(ref_end, pos + 1) - 1) >> self.min_shift) + 1,
        ):
            if w not in lin or vo_beg < lin[w]:
                lin[w] = vo_beg

    def finish(self) -> CsiIndex:
        levels = levels_for(self.min_shift, self.depth)
        for tid, ri in enumerate(self.refs):
            lin = self._lin[tid]
            if not lin:
                continue
            n = max(lin) + 1
            filled = []
            prev = 0
            for w in range(n):
                prev = lin.get(w, prev)
                filled.append(prev)
            # loffset of a bin = linear lower bound at its window start
            # (htslib's choice; any offset <= the first overlapping
            # record is valid)
            for b in ri.bins:
                if b == 0:
                    ri.loffsets[b] = filled[0]
                    continue
                # bin level = deepest (shift, off) with off <= b
                start = 0
                for s, off in reversed(levels):
                    if b >= off:
                        start = (b - off) << s
                        break
                w = min(start >> self.min_shift, n - 1)
                ri.loffsets[b] = filled[w]
        return CsiIndex(
            self.refs, self.n_no_coor, self.min_shift, self.depth
        )
