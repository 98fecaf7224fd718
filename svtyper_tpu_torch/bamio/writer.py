"""BAM writer + on-the-fly BAI builder.

Used to synthesize test/bench fixtures (SURVEY.md §4 test plan: "synthesize
BAMs: known BGZF blocks, CIGARs, SA tags, BAI") and to implement the
``-w/--write_alignment`` evidence dump (``classic.py::write_alignment``
parity, SURVEY.md §2.2).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Sequence, Tuple

from svtyper_tpu_torch.bamio.bai import BaiBuilder
from svtyper_tpu_torch.bamio.bgzf import BgzfWriter
from svtyper_tpu_torch.bamio.cigar import CigarFeatures
from svtyper_tpu_torch.bamio.columns import FUNMAP

_SEQ_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def encode_record(
    qname: str,
    flag: int,
    tid: int,
    pos: int,
    mapq: int,
    cigar: Sequence[Tuple[int, int]],
    mate_tid: int,
    mate_pos: int,
    tlen: int,
    seq: str = "",
    qual: Optional[bytes] = None,
    tags: Optional[Dict[str, Tuple[str, object]]] = None,
) -> bytes:
    """Encode one alignment record (without the leading block_size)."""
    name = qname.encode() + b"\x00"
    n_cig = len(cigar)
    l_seq = len(seq)
    feats = CigarFeatures(pos, cigar)
    bin_ = _reg2bin_for(pos, feats.ref_end) if pos >= 0 else 4680
    cg_ops = None
    if n_cig > 0xFFFF:
        # SAM spec §4.2.2 long-CIGAR form: n_cigar_op is u16, so the
        # record carries a kSmN placeholder and the true ops move to a
        # CG:B,I aux tag (appended after any user tags below)
        if l_seq == 0:
            raise ValueError(
                ">65535-op CIGAR requires SEQ (the kS placeholder "
                "encodes l_seq)"
            )
        cg_ops = cigar
        cigar = [(4, l_seq), (3, feats.ref_end - pos)]
        n_cig = 2
    body = bytearray()
    body += struct.pack(
        "<iiBBHHHIiii",
        tid, pos, len(name), mapq, bin_, n_cig, flag, l_seq,
        mate_tid, mate_pos, tlen,
    )
    body += name
    for op, ln in cigar:
        body += struct.pack("<I", (ln << 4) | op)
    packed = bytearray((l_seq + 1) // 2)
    for i, c in enumerate(seq):
        code = _SEQ_CODE.get(c.upper(), 15)
        if i % 2 == 0:
            packed[i // 2] = code << 4
        else:
            packed[i // 2] |= code
    body += packed
    body += qual if qual is not None else b"\xff" * l_seq
    _SCALAR = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
               "I": "<I", "f": "<f"}
    for tag, (typ, val) in (tags or {}).items():
        body += tag.encode() + typ.encode()
        if typ in ("Z", "H"):  # H = hex string, same wire form as Z
            body += str(val).encode() + b"\x00"
        elif typ == "A":
            body += str(val).encode()[:1]
        elif typ in _SCALAR:
            body += struct.pack(_SCALAR[typ], val)
        elif typ == "B":
            sub, items = val  # (subtype char, sequence)
            body += sub.encode()
            body += struct.pack("<I", len(items))
            body += struct.pack(
                "<%d%s" % (len(items), _SCALAR[sub][1]), *items
            )
        else:
            raise ValueError("unsupported tag type %r" % typ)
    if cg_ops is not None:
        body += b"CGBI" + struct.pack("<I", len(cg_ops))
        for op, ln in cg_ops:
            body += struct.pack("<I", (ln << 4) | op)
    return bytes(body)


def _reg2bin_for(pos: int, ref_end: int) -> int:
    from svtyper_tpu_torch.bamio.bai import reg2bin

    # the record's 16-bit bin field only encodes the fixed BAI scheme;
    # past 2^29 (CSI territory) the true bin doesn't fit — write 0
    # (readers, including this package's, use the .bai/.csi instead)
    if max(ref_end, pos + 1) > (1 << 29):
        return 0
    return reg2bin(pos, max(ref_end, pos + 1))


class BamWriter:
    """Coordinate-order BAM writer producing ``.bam`` + ``.bam.bai``."""

    def __init__(
        self,
        path: str,
        refs: Sequence[Tuple[str, int]],
        header_text: str = "",
    ) -> None:
        self.path = path
        self.refs = list(refs)
        self._fh = open(path, "wb")
        self._w = BgzfWriter(self._fh)
        # BAI tops out at 2^29-1 bp; longer contigs get a CSI with a
        # deep-enough binning scheme (htslib does the same switch)
        max_len = max((l for _, l in self.refs), default=0)
        if max_len >= (1 << 29):
            from svtyper_tpu_torch.bamio.csi import CsiBuilder, depth_for

            self._bai = CsiBuilder(
                len(self.refs), depth=depth_for(max_len)
            )
            self._idx_ext = ".csi"
        else:
            self._bai = BaiBuilder(len(self.refs))
            self._idx_ext = ".bai"
        hdr = bytearray(b"BAM\x01")
        text = header_text.encode()
        hdr += struct.pack("<i", len(text)) + text
        hdr += struct.pack("<i", len(self.refs))
        for name, length in self.refs:
            nb = name.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._w.write(bytes(hdr))
        # index chunks must not straddle the header block
        self._w.flush()

    def write_record(self, record: bytes, tid: int, pos: int, ref_end: int, flag: int) -> None:
        vo_beg = self._w.tell_voffset()
        self._w.write(struct.pack("<i", len(record)) + record)
        vo_end = self._w.tell_voffset()
        self._bai.add(tid, pos, ref_end, vo_beg, vo_end, not (flag & FUNMAP))

    def write_records_bulk(self, raws, tids, poss, ends, flags) -> None:
        """Bulk form of write_record for pre-framed record bytes (the
        ``-w`` evidence dump): one BGZF write_bulk per call with record
        voffsets recovered arithmetically from the block table, instead
        of two tell_voffset() calls per record. Record content and
        index are identical to the per-record loop; only the BGZF block
        framing may differ at bulk-call boundaries (the leading flush
        can cut a short block), which no reader observes."""
        import numpy as np

        n = len(raws)
        if not n:
            return
        self._w.flush()  # write_bulk needs a block-aligned start
        frames = [len(r).to_bytes(4, "little") + r for r in raws]
        lens = np.fromiter(map(len, frames), np.int64, n)
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        offs = np.asarray(self._w.write_bulk(b"".join(frames)),
                          dtype=np.int64)
        B = BgzfWriter.MAX_BLOCK
        vo = (offs[starts // B] << 16) | (starts % B)
        mapped = (np.asarray(flags, dtype=np.int64) & FUNMAP) == 0
        bulk = getattr(self._bai, "add_bulk", None)
        if bulk is not None:
            bulk(tids, poss, ends, vo[:-1], vo[1:], mapped)
        else:  # CSI builder: scalar adds
            for k in range(n):
                self._bai.add(int(tids[k]), int(poss[k]), int(ends[k]),
                              int(vo[k]), int(vo[k + 1]), bool(mapped[k]))

    def write(
        self,
        qname: str,
        flag: int,
        tid: int,
        pos: int,
        mapq: int,
        cigar: Sequence[Tuple[int, int]],
        mate_tid: int = -1,
        mate_pos: int = -1,
        tlen: int = 0,
        seq: str = "",
        qual: Optional[bytes] = None,
        tags: Optional[Dict[str, Tuple[str, object]]] = None,
    ) -> None:
        rec = encode_record(
            qname, flag, tid, pos, mapq, cigar,
            mate_tid, mate_pos, tlen, seq, qual, tags,
        )
        feats = CigarFeatures(pos, cigar)
        self.write_record(rec, tid, pos, feats.ref_end, flag)

    def close(self, write_index: bool = True) -> None:
        self._w.close()
        self._fh.close()
        if write_index:
            self._bai.finish().save(self.path + self._idx_ext)


def make_header_text(
    refs: Sequence[Tuple[str, int]],
    read_groups: Sequence[Dict[str, str]] = (),
    sort_order: str = "coordinate",
) -> str:
    lines = ["@HD\tVN:1.6\tSO:%s" % sort_order]
    for name, length in refs:
        lines.append("@SQ\tSN:%s\tLN:%d" % (name, length))
    for rg in read_groups:
        parts = ["@RG"] + ["%s:%s" % (k, v) for k, v in rg.items()]
        lines.append("\t".join(parts))
    return "\n".join(lines) + "\n"
