"""CRAM 3.0 reader — compatibility surface for ``-B sample.cram``.

The reference (``classic.py``/``parsers.py``) gets CRAM for free through
``pysam → htslib``; this module is the from-scratch equivalent for the
subset svtyper actually consumes: flags, positions, MAPQ, CIGAR
(reconstructed from read features — no reference FASTA needed, so
``-T`` is optional here), mate fields, TLEN, RG and SA tags. Sequence
bases and qualities are parsed (their streams must be consumed to stay
in sync) but not retained — the evidence model never reads them
(SURVEY.md §3.1).

Scope and honesty notes:
- Pure Python + numpy. CRAM is a compatibility path, not the hot path:
  the benchmark data is BAM, as is the reference's own test data
  (SURVEY.md §2.1 documents CRAM as "FASTA only needed to open CRAM").
- Round-tripped against this package's own ``CramWriter`` and
  cross-checked read-for-read against the BAM decoder on identical
  records (tests/test_cram.py). No external CRAM exists in this offline
  environment; structural details that could drift from htslib are
  marked [MUST-VERIFY].
- Codecs: raw, gzip, bzip2, lzma, rANS4x8 (bamio/rans.py).
  Encodings: EXTERNAL, HUFFMAN (canonical, incl. the 0-bit constant
  form), BETA, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP.
"""

from __future__ import annotations

import bz2
import lzma
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.bamio import rans
from svtyper_tpu_torch.bamio.columns import FMREVERSE, FMUNMAP, FUNMAP, ReadBatch
from svtyper_tpu_torch.bamio.records import _Cols, append_read

CRAM_MAGIC = b"CRAM"

# block compression methods
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS = 0, 1, 2, 3, 4
# block content types
CT_FILE_HEADER, CT_COMP_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5

# CIGAR op codes (BAM numbering)
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P = 0, 1, 2, 3, 4, 5, 6


# ------------------------------------------------------------ itf8/ltf8

def read_itf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    if b0 < 0x80:
        v, n = b0, 1
    elif b0 < 0xC0:
        v = ((b0 & 0x3F) << 8) | buf[off + 1]
        n = 2
    elif b0 < 0xE0:
        v = ((b0 & 0x1F) << 16) | (buf[off + 1] << 8) | buf[off + 2]
        n = 3
    elif b0 < 0xF0:
        v = ((b0 & 0x0F) << 24) | (buf[off + 1] << 16) \
            | (buf[off + 2] << 8) | buf[off + 3]
        n = 4
    else:
        # 4 low bits + 4 full bytes (low 4 bits of the last byte per
        # spec; htslib keeps all 8 — [MUST-VERIFY]; we keep all 8,
        # masked to 32 bits, which round-trips both forms)
        v = ((b0 & 0x0F) << 28) | (buf[off + 1] << 20) \
            | (buf[off + 2] << 12) | (buf[off + 3] << 4) \
            | (buf[off + 4] & 0x0F)
        n = 5
    if v & 0x80000000:
        v -= 1 << 32  # itf8 is a signed 32-bit value
    return v, off + n


def write_itf8(out: bytearray, v: int) -> None:
    v &= 0xFFFFFFFF
    if v < 0x80:
        out.append(v)
    elif v < 0x4000:
        out.extend(((v >> 8) | 0x80, v & 0xFF))
    elif v < 0x200000:
        out.extend(((v >> 16) | 0xC0, (v >> 8) & 0xFF, v & 0xFF))
    elif v < 0x10000000:
        out.extend(((v >> 24) | 0xE0, (v >> 16) & 0xFF,
                    (v >> 8) & 0xFF, v & 0xFF))
    else:
        out.extend((0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                    (v >> 4) & 0xFF, v & 0x0F))


def read_ltf8(buf: bytes, off: int) -> Tuple[int, int]:
    b0 = buf[off]
    extra = 0
    while extra < 8 and (b0 << extra) & 0x80:
        extra += 1
    v = b0 & (0xFF >> extra) if extra < 8 else 0
    for i in range(extra):
        v = (v << 8) | buf[off + 1 + i]
    if v & (1 << 63):
        v -= 1 << 64
    return v, off + 1 + extra


def write_ltf8(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    if v < 0x80:
        out.append(v)
        return
    for extra in range(1, 9):
        prefix_bits = 7 - extra if extra < 8 else 0
        if v < (1 << (prefix_bits + 8 * extra)):
            lead = (0xFF << (8 - extra)) & 0xFF
            if extra < 8:
                lead |= v >> (8 * extra)
            out.append(lead)
            for i in range(extra - 1, -1, -1):
                out.append((v >> (8 * i)) & 0xFF)
            return
    raise ValueError("ltf8 overflow")


def read_array_itf8(buf: bytes, off: int) -> Tuple[List[int], int]:
    n, off = read_itf8(buf, off)
    vals = []
    for _ in range(n):
        v, off = read_itf8(buf, off)
        vals.append(v)
    return vals, off


def write_array_itf8(out: bytearray, vals: List[int]) -> None:
    write_itf8(out, len(vals))
    for v in vals:
        write_itf8(out, v)


# ------------------------------------------------------------ blocks

def uncompress_block(method: int, data: bytes, raw_size: int) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        return zlib.decompress(data, 15 + 32)  # gzip or zlib wrapper
    if method == M_BZIP2:
        return bz2.decompress(data)
    if method == M_LZMA:
        return lzma.decompress(data)
    if method == M_RANS:
        return rans.uncompress(data)
    raise ValueError("unsupported CRAM block method %d" % method)


def read_block(buf: bytes, off: int) -> Tuple[dict, int]:
    method = buf[off]
    ctype = buf[off + 1]
    off += 2
    content_id, off = read_itf8(buf, off)
    comp_size, off = read_itf8(buf, off)
    raw_size, off = read_itf8(buf, off)
    data = buf[off : off + comp_size]
    off += comp_size
    off += 4  # CRC32 (not verified on read)
    return {
        "method": method,
        "ctype": ctype,
        "content_id": content_id,
        "raw_size": raw_size,
        "data": uncompress_block(method, data, raw_size),
    }, off


def write_block(out: bytearray, method: int, ctype: int, content_id: int,
                raw: bytes) -> None:
    if method == M_GZIP:
        data = zlib.compress(raw, 6)
    elif method == M_RANS:
        data = rans.compress(raw, order=0)
    elif method == M_RAW:
        data = raw
    else:
        raise ValueError("writer supports raw/gzip/rans only")
    blk = bytearray()
    blk.append(method)
    blk.append(ctype)
    write_itf8(blk, content_id)
    write_itf8(blk, len(data))
    write_itf8(blk, len(raw))
    blk.extend(data)
    blk.extend(struct.pack("<I", zlib.crc32(bytes(blk)) & 0xFFFFFFFF))
    out.extend(blk)


# ------------------------------------------------------------ container

class ContainerHeader:
    __slots__ = ("length", "ref_id", "start", "span", "n_records",
                 "counter", "bases", "n_blocks", "landmarks", "hdr_size")

    @classmethod
    def parse(cls, buf: bytes, off: int) -> "ContainerHeader":
        h = cls()
        base = off
        (h.length,) = struct.unpack_from("<i", buf, off)
        off += 4
        h.ref_id, off = read_itf8(buf, off)
        h.start, off = read_itf8(buf, off)
        h.span, off = read_itf8(buf, off)
        h.n_records, off = read_itf8(buf, off)
        h.counter, off = read_ltf8(buf, off)
        h.bases, off = read_ltf8(buf, off)
        h.n_blocks, off = read_itf8(buf, off)
        h.landmarks, off = read_array_itf8(buf, off)
        off += 4  # CRC32
        h.hdr_size = off - base
        return h

    @staticmethod
    def emit(ref_id: int, start: int, span: int, n_records: int,
             counter: int, bases: int, n_blocks: int,
             landmarks: List[int], body_len: int) -> bytes:
        out = bytearray(struct.pack("<i", body_len))
        write_itf8(out, ref_id)
        write_itf8(out, start)
        write_itf8(out, span)
        write_itf8(out, n_records)
        write_ltf8(out, counter)
        write_ltf8(out, bases)
        write_itf8(out, n_blocks)
        write_array_itf8(out, landmarks)
        out.extend(struct.pack("<I", zlib.crc32(bytes(out)) & 0xFFFFFFFF))
        return bytes(out)


# ------------------------------------------------------------ encodings

class BitReader:
    """MSB-first bit reader over the slice's core block."""

    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v


class ExternalStream:
    __slots__ = ("data", "off")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def read_itf8(self) -> int:
        v, self.off = read_itf8(self.data, self.off)
        return v

    def read_byte(self) -> int:
        b = self.data[self.off]
        self.off += 1
        return b

    def read_bytes(self, n: int) -> bytes:
        b = self.data[self.off : self.off + n]
        self.off += n
        return b

    def read_until(self, stop: int) -> bytes:
        i = self.data.index(stop, self.off)
        b = self.data[self.off : i]
        self.off = i + 1
        return b


class Encoding:
    """One decoded <encoding> map value: codec id + parsed params."""

    __slots__ = ("eid", "params")

    def __init__(self, eid: int, params: bytes) -> None:
        self.eid = eid
        self.params = params

    @classmethod
    def parse(cls, buf: bytes, off: int) -> Tuple["Encoding", int]:
        eid, off = read_itf8(buf, off)
        plen, off = read_itf8(buf, off)
        params = buf[off : off + plen]
        return cls(eid, params), off + plen

    # -- parameter views ---------------------------------------------
    def external_id(self) -> int:
        v, _ = read_itf8(self.params, 0)
        return v

    def huffman_tables(self):
        alphabet, off = read_array_itf8(self.params, 0)
        lengths, _ = read_array_itf8(self.params, off)
        # canonical codes: sort by (bit length, order of appearance)
        order = sorted(range(len(alphabet)), key=lambda i: (lengths[i], i))
        codes = {}
        code = 0
        prev_len = 0
        for i in order:
            code <<= lengths[i] - prev_len
            prev_len = lengths[i]
            codes[(lengths[i], code)] = alphabet[i]
            code += 1
        return alphabet, lengths, codes

    def beta_params(self) -> Tuple[int, int]:
        offset, off = read_itf8(self.params, 0)
        nbits, _ = read_itf8(self.params, off)
        return offset, nbits

    def byte_array_stop(self) -> Tuple[int, int]:
        stop = self.params[0]
        ext, _ = read_itf8(self.params, 1)
        return stop, ext

    def byte_array_len(self) -> Tuple["Encoding", "Encoding"]:
        len_enc, off = Encoding.parse(self.params, 0)
        val_enc, _ = Encoding.parse(self.params, off)
        return len_enc, val_enc


E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN = 0, 1, 2, 3
E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA = 4, 5, 6


class Decoder:
    """Bound decoder for one data series within one slice."""

    def __init__(self, enc: Encoding, core: BitReader,
                 ext: Dict[int, ExternalStream]) -> None:
        self.enc = enc
        self.core = core
        self.ext = ext
        if enc.eid == E_EXTERNAL:
            self.stream = ext[enc.external_id()]
        elif enc.eid == E_HUFFMAN:
            self.alphabet, self.lengths, self.codes = enc.huffman_tables()
            self.const = (
                self.alphabet[0] if len(self.alphabet) == 1
                and self.lengths[0] == 0 else None
            )
        elif enc.eid == E_BETA:
            self.offset, self.nbits = enc.beta_params()
        elif enc.eid == E_BYTE_ARRAY_STOP:
            self.stop, ext_id = enc.byte_array_stop()
            self.stream = ext[ext_id]
        elif enc.eid == E_BYTE_ARRAY_LEN:
            len_enc, val_enc = enc.byte_array_len()
            self.len_dec = Decoder(len_enc, core, ext)
            self.val_enc = val_enc
            if val_enc.eid == E_EXTERNAL:
                self.val_stream = ext[val_enc.external_id()]
            else:
                self.val_dec = Decoder(val_enc, core, ext)

    def read_int(self) -> int:
        eid = self.enc.eid
        if eid == E_EXTERNAL:
            return self.stream.read_itf8()
        if eid == E_HUFFMAN:
            if self.const is not None:
                return self.const
            ln = 0
            code = 0
            while True:
                code = (code << 1) | self.core.read_bits(1)
                ln += 1
                if (ln, code) in self.codes:
                    return self.codes[(ln, code)]
                if ln > 31:
                    raise ValueError("bad huffman stream")
        if eid == E_BETA:
            return self.core.read_bits(self.nbits) - self.offset
        raise ValueError("encoding %d cannot decode ints" % eid)

    def read_byte(self) -> int:
        if self.enc.eid == E_EXTERNAL:
            return self.stream.read_byte()
        return self.read_int()

    def read_bytes(self, length: Optional[int] = None) -> bytes:
        eid = self.enc.eid
        if eid == E_BYTE_ARRAY_STOP:
            return self.stream.read_until(self.stop)
        if eid == E_BYTE_ARRAY_LEN:
            n = self.len_dec.read_int()
            if self.val_enc.eid == E_EXTERNAL:
                return self.val_stream.read_bytes(n)
            return bytes(self.val_dec.read_byte() for _ in range(n))
        if eid == E_EXTERNAL:
            assert length is not None
            return self.stream.read_bytes(length)
        raise ValueError("encoding %d cannot decode byte arrays" % eid)


# ------------------------------------------------------------ comp header

class CompressionHeader:
    def __init__(self) -> None:
        self.ap_delta = True
        self.rn_included = True
        self.ref_required = True
        self.sub_matrix = b"\x00" * 5
        self.td: List[List[Tuple[bytes, int]]] = [[]]
        self.ds: Dict[bytes, Encoding] = {}
        self.tags: Dict[int, Encoding] = {}

    @classmethod
    def parse(cls, data: bytes) -> "CompressionHeader":
        h = cls()
        off = 0
        # preservation map
        _size, off = read_itf8(data, off)
        n, off = read_itf8(data, off)
        for _ in range(n):
            key = data[off : off + 2]
            off += 2
            if key in (b"AP", b"RN", b"RR"):
                flag = data[off] != 0
                off += 1
                if key == b"AP":
                    h.ap_delta = flag
                elif key == b"RN":
                    h.rn_included = flag
                else:
                    h.ref_required = flag
            elif key == b"SM":
                h.sub_matrix = data[off : off + 5]
                off += 5
            elif key == b"TD":
                ln, off = read_itf8(data, off)
                blob = data[off : off + ln]
                off += ln
                h.td = []
                for line in blob.split(b"\x00"):
                    entries = []
                    for i in range(0, len(line) - 2, 3):
                        entries.append((line[i : i + 2], line[i + 2]))
                    h.td.append(entries)
            else:
                raise ValueError("unknown preservation key %r" % key)
        # data series encodings
        _size, off = read_itf8(data, off)
        n, off = read_itf8(data, off)
        for _ in range(n):
            key = data[off : off + 2]
            off += 2
            enc, off = Encoding.parse(data, off)
            h.ds[key] = enc
        # tag encodings
        _size, off = read_itf8(data, off)
        n, off = read_itf8(data, off)
        for _ in range(n):
            key, off = read_itf8(data, off)
            enc, off = Encoding.parse(data, off)
            h.tags[key] = enc
        return h


class SliceHeader:
    __slots__ = ("ref_id", "start", "span", "n_records", "counter",
                 "n_blocks", "content_ids", "embedded_ref", "md5")

    @classmethod
    def parse(cls, data: bytes) -> "SliceHeader":
        s = cls()
        off = 0
        s.ref_id, off = read_itf8(data, off)
        s.start, off = read_itf8(data, off)
        s.span, off = read_itf8(data, off)
        s.n_records, off = read_itf8(data, off)
        s.counter, off = read_ltf8(data, off)
        s.n_blocks, off = read_itf8(data, off)
        s.content_ids, off = read_array_itf8(data, off)
        s.embedded_ref, off = read_itf8(data, off)
        s.md5 = data[off : off + 16]
        return s


# ------------------------------------------------------------ records

# feature codes whose payload is (int) / (byte) / (byte array)
_FEAT_INT = frozenset(b"DHNPR")  # R unused; D del, H hard, N skip, P pad
_FEAT_BYTE = frozenset(b"XiQ")  # X sub code, i single base, Q single qual
_FEAT_ARRAY = frozenset(b"ISbq")  # soft clip, insertion, bases, quals

_SERIES_FEAT = {
    ord("D"): b"DL", ord("H"): b"HC", ord("N"): b"RS", ord("P"): b"PD",
    ord("X"): b"BS", ord("i"): b"BA", ord("Q"): b"QS",
    ord("I"): b"IN", ord("S"): b"SC", ord("b"): b"BB", ord("q"): b"QQ",
}


def _features_to_cigar(feats, read_len: int):
    """Reconstruct CIGAR ops from (code, read_pos_1based, value)
    features. M runs fill the gaps; adjacent same-op runs merge. X/B
    features stay inside their M run (alignment-match semantics)."""
    ops: List[Tuple[int, int]] = []

    def push(op, ln):
        if ln <= 0:
            return
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + ln)
        else:
            ops.append((op, ln))

    rpos = 1
    for code, p, val in feats:
        if p > rpos:
            push(OP_M, p - rpos)
            rpos = p
        if code == ord("S"):
            push(OP_S, len(val))
            rpos += len(val)
        elif code in (ord("I"), ord("b")):
            push(OP_I if code == ord("I") else OP_M, len(val))
            rpos += len(val)
        elif code == ord("i"):
            push(OP_I, 1)
            rpos += 1
        elif code == ord("D"):
            push(OP_D, val)
        elif code == ord("N"):
            push(OP_N, val)
        elif code == ord("H"):
            push(OP_H, val)
        elif code == ord("P"):
            push(OP_P, val)
        elif code in (ord("X"), ord("B")):
            push(OP_M, 1)
            rpos += 1
        elif code in (ord("Q"), ord("q")):
            pass  # quality-only features consume no read bases
    if read_len >= rpos:
        push(OP_M, read_len - rpos + 1)
    return ops


class _SliceDecoder:
    """Decodes every record of one slice into plain python tuples."""

    def __init__(self, comp: CompressionHeader, sh: SliceHeader,
                 blocks: List[dict]) -> None:
        self.comp = comp
        self.sh = sh
        core = b""
        ext: Dict[int, ExternalStream] = {}
        for b in blocks:
            if b["ctype"] == CT_CORE:
                core = b["data"]
            elif b["ctype"] == CT_EXTERNAL:
                ext[b["content_id"]] = ExternalStream(b["data"])
        self.core = BitReader(core)
        self.ext = ext
        self._dec: Dict[bytes, Decoder] = {}
        self._tag_dec: Dict[int, Decoder] = {}

    def dec(self, key: bytes) -> Decoder:
        d = self._dec.get(key)
        if d is None:
            enc = self.comp.ds.get(key)
            if enc is None:
                raise ValueError("missing data series %r" % key)
            d = Decoder(enc, self.core, self.ext)
            self._dec[key] = d
        return d

    def tag_dec(self, key: int) -> Decoder:
        d = self._tag_dec.get(key)
        if d is None:
            d = Decoder(self.comp.tags[key], self.core, self.ext)
            self._tag_dec[key] = d
        return d

    def decode_records(self):
        comp, sh = self.comp, self.sh
        recs = []
        prev_ap = sh.start
        for _ in range(sh.n_records):
            bf = self.dec(b"BF").read_int()
            cf = self.dec(b"CF").read_int()
            ref_id = sh.ref_id
            if ref_id == -2:  # multi-reference slice
                ref_id = self.dec(b"RI").read_int()
            rl = self.dec(b"RL").read_int()
            ap = self.dec(b"AP").read_int()
            if comp.ap_delta:
                ap += prev_ap
                prev_ap = ap
            rg = self.dec(b"RG").read_int()
            qname = b""
            if comp.rn_included:
                qname = self.dec(b"RN").read_bytes()
            mate_ref = -1
            mate_pos = -1
            tlen = 0
            nf = -1
            mf = 0
            if cf & 0x2:  # detached mate
                mf = self.dec(b"MF").read_int()
                if not comp.rn_included:
                    qname = self.dec(b"RN").read_bytes()
                mate_ref = self.dec(b"NS").read_int()
                mate_pos = self.dec(b"NP").read_int() - 1
                tlen = self.dec(b"TS").read_int()
            elif cf & 0x4:  # mate is NF records downstream
                nf = self.dec(b"NF").read_int()
            tl = self.dec(b"TL").read_int()
            tags: Dict[bytes, bytes] = {}
            for tag, typ in comp.td[tl]:
                key = (tag[0] << 16) | (tag[1] << 8) | typ
                val = self.tag_dec(key).read_bytes()
                if typ in (ord("Z"), ord("H")) and val.endswith(b"\x00"):
                    val = val[:-1]  # stored in BAM form (NUL-terminated)
                tags[tag + bytes([typ])] = val
            cig_ops: List[Tuple[int, int]] = [(OP_M, rl)] if rl else []
            mapq = 0
            if not (bf & FUNMAP):
                fn = self.dec(b"FN").read_int()
                feats = []
                p = 0
                for _f in range(fn):
                    code = self.dec(b"FC").read_byte()
                    p += self.dec(b"FP").read_int()
                    series = _SERIES_FEAT.get(code)
                    if code in _FEAT_INT:
                        val = self.dec(series).read_int()
                    elif code in _FEAT_BYTE:
                        val = self.dec(series).read_byte()
                    elif code in _FEAT_ARRAY:
                        val = self.dec(series).read_bytes()
                    elif code == ord("B"):
                        val = (self.dec(b"BA").read_byte(),
                               self.dec(b"QS").read_byte())
                    else:
                        raise ValueError("unknown feature %r" % chr(code))
                    feats.append((code, p, val))
                cig_ops = _features_to_cigar(feats, rl)
                mapq = self.dec(b"MQ").read_int()
                qual = (self.dec(b"QS").read_bytes(rl)
                        if cf & 0x1 else None)
                bases = None
            else:
                feats = []
                bases = None
                if not (cf & 0x8):
                    ba = self.dec(b"BA")
                    bases = bytes(ba.read_byte() for _b in range(rl))
                qual = (self.dec(b"QS").read_bytes(rl)
                        if cf & 0x1 else None)
            recs.append({
                "bf": bf, "cf": cf, "ref_id": ref_id, "pos": ap - 1,
                "rl": rl, "rg": rg, "qname": qname, "mf": mf,
                "mate_ref": mate_ref, "mate_pos": mate_pos, "tlen": tlen,
                "nf": nf, "tags": tags, "cigar": cig_ops, "mapq": mapq,
                # SEQ reconstruction inputs (raw_records with a -T
                # FASTA): the feature list, stored qualities, and
                # literal unmapped bases
                "feats": feats, "qual": qual, "bases": bases,
                "sm": comp.sub_matrix,
            })
        _link_mates(recs)
        return recs


def _link_mates(recs: List[dict]) -> None:
    """Resolve NF (mate downstream) chains: fill mate coordinates and
    template size from the paired record, and mate flag bits from its
    BF (spec §10.2 mate records)."""
    for i, r in enumerate(recs):
        if r["nf"] < 0:
            if r["cf"] & 0x2:  # detached: mate bits from MF
                if r["mf"] & 0x1:
                    r["bf"] |= FMREVERSE
                if r["mf"] & 0x2:
                    r["bf"] |= FMUNMAP
            continue
        j = i + r["nf"] + 1
        m = recs[j]
        r["mate_ref"], r["mate_pos"] = m["ref_id"], m["pos"]
        m["mate_ref"], m["mate_pos"] = r["ref_id"], r["pos"]
        for a, b in ((r, m), (m, r)):
            if b["bf"] & 0x10:
                a["bf"] |= FMREVERSE
            if b["bf"] & FUNMAP:
                a["bf"] |= FMUNMAP
        # template span: leftmost start to rightmost end, sign by side
        r_end = r["pos"] + sum(
            ln for op, ln in r["cigar"] if op in (OP_M, OP_D, OP_N)
        )
        m_end = m["pos"] + sum(
            ln for op, ln in m["cigar"] if op in (OP_M, OP_D, OP_N)
        )
        span = max(r_end, m_end) - min(r["pos"], m["pos"])
        if r["pos"] <= m["pos"]:
            r["tlen"], m["tlen"] = span, -span
        else:
            r["tlen"], m["tlen"] = -span, span


# ------------------------------------------------------------ file reader

class CraiIndex:
    """.crai: gzip text, one row per slice."""

    def __init__(self, rows: np.ndarray) -> None:
        self.rows = rows  # [n, 6] int64: seq,start,span,c_off,s_off,s_len

    @classmethod
    def load(cls, path: str) -> "CraiIndex":
        import gzip

        with gzip.open(path, "rb") as fh:
            txt = fh.read()
        rows = []
        for line in txt.splitlines():
            if line.strip():
                rows.append([int(x) for x in line.split(b"\t")])
        return cls(np.asarray(rows, dtype=np.int64).reshape(-1, 6))

    def containers_for(self, tid: int, beg: int, end: int) -> List[int]:
        r = self.rows
        if not len(r):
            return []
        hit = (r[:, 0] == tid) & (r[:, 1] < end) & (r[:, 1] + r[:, 2] > beg)
        # multi-ref rows (seq = -2, from the header-scan fallback) can't
        # be range-filtered without decoding — match any query
        hit |= r[:, 0] == -2
        return sorted(set(int(x) for x in r[hit, 3]))


class CramFile:
    """Read-only CRAM 3.x with the BamFile fetch/scan surface.

    Exposes the members the pipeline touches (see BamFile):
    ``header``, ``rg_index``, ``fetch``, ``fetch_many``, ``fetch_chunk``
    (returns None → callers use the generic layout path), ``scan``,
    ``mapped_unmapped``.
    """

    def __init__(self, path: str, use_native: Optional[bool] = None,
                 threads: Optional[int] = None,
                 ref_fasta: Optional[str] = None) -> None:
        from svtyper_tpu_torch.bamio.bam import BamHeader

        import mmap

        self.path = path
        # reference FASTA (-T): enables full SEQ/QUAL in raw_records
        # (-w) via feature + substitution-matrix reconstruction;
        # genotyping itself never reads bases so this stays optional
        self._fasta = None
        if ref_fasta:
            from svtyper_tpu_torch.bamio.fasta import FastaFile

            self._fasta = FastaFile(ref_fasta)
        # mmap, not read(): real CRAMs are multi-GB and fetch() touches
        # only the indexed containers; the OS pages in what's used
        self._fh = open(path, "rb")
        try:  # any constructor failure must release the fd + mmap
            try:
                self._buf = mmap.mmap(
                    self._fh.fileno(), 0, access=mmap.ACCESS_READ
                )
            except (ValueError, OSError):  # 0-byte or unmappable file
                self._buf = self._fh.read()
            if self._buf[:4] != CRAM_MAGIC:
                raise ValueError("not a CRAM file: %s" % path)
            self.version = (self._buf[4], self._buf[5])
            off = 26  # magic + version + 20-byte file id
            # first container: SAM header text
            ch = ContainerHeader.parse(self._buf, off)
            body = off + ch.hdr_size
            blk, _ = read_block(self._buf, body)
            text = blk["data"]
            if len(text) >= 4:
                (ln,) = struct.unpack_from("<i", text, 0)
                if 0 <= ln <= len(text) - 4:
                    text = text[4 : 4 + ln]
            text = text.split(b"\x00", 1)[0].decode(errors="replace")
            self._containers_off = off + ch.hdr_size + ch.length
            refs = _refs_from_text(text)
            self.header = BamHeader(text, refs)
        except Exception:
            self.close()
            raise
        self.rg_index: Dict[bytes, int] = {
            rg.get("ID", "").encode(): i
            for i, rg in enumerate(self.header.read_groups)
        }
        self._crai: Optional[CraiIndex] = None
        self._container_cache: Dict[int, ReadBatch] = {}
        self._raw_cache: Optional[Tuple[int, list]] = None
        self._mapped_unmapped: Optional[Tuple[int, int]] = None

    def close(self) -> None:
        """Release the mmap and file descriptor (safe to call twice;
        long-lived processes opening many CRAMs must not leak fds)."""
        fasta = getattr(self, "_fasta", None)
        if fasta is not None:
            try:
                fasta.close()
            except Exception:
                pass
            self._fasta = None
        buf = getattr(self, "_buf", None)
        if buf is not None and hasattr(buf, "close"):
            try:
                buf.close()
            except Exception:
                pass
        self._buf = None
        fh = getattr(self, "_fh", None)
        if fh is not None:
            try:
                fh.close()
            except Exception:
                pass
        self._fh = None

    def __enter__(self) -> "CramFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- container iteration ------------------------------------------
    def _container_offsets(self) -> List[int]:
        offs = []
        off = self._containers_off
        n = len(self._buf)
        while off < n:
            ch = ContainerHeader.parse(self._buf, off)
            if ch.n_records == 0:  # EOF (or empty) container
                off += ch.hdr_size + ch.length
                continue
            offs.append(off)
            off += ch.hdr_size + ch.length
        return offs

    def _iter_container_records(self, off: int):
        """Yield the decoded record dicts of one container in ordinal
        order (shared by :meth:`_decode_container` / :meth:`raw_records`)."""
        buf = self._buf
        ch = ContainerHeader.parse(buf, off)
        body = off + ch.hdr_size
        pos = body
        comp_blk, pos = read_block(buf, pos)
        if comp_blk["ctype"] != CT_COMP_HEADER:
            raise ValueError("expected compression header block")
        comp = CompressionHeader.parse(comp_blk["data"])
        # remaining blocks: slices (header + its n_blocks data blocks)
        end = body + ch.length
        while pos < end:
            sh_blk, pos = read_block(buf, pos)
            if sh_blk["ctype"] != CT_SLICE_HEADER:
                raise ValueError("expected slice header block")
            sh = SliceHeader.parse(sh_blk["data"])
            blocks = []
            for _ in range(sh.n_blocks):
                b, pos = read_block(buf, pos)
                blocks.append(b)
            yield from _SliceDecoder(comp, sh, blocks).decode_records()

    def _decode_container(self, off: int) -> ReadBatch:
        cached = self._container_cache.get(off)
        if cached is not None:
            return cached
        cols = _Cols()
        name_to_tid = self.header.name_to_tid
        rec_ordinal = 0  # per-container, spans slices
        for r in self._iter_container_records(off):
            rg_id = b""
            if 0 <= r["rg"] < len(self.header.read_groups):
                rg_id = self.header.read_groups[r["rg"]].get(
                    "ID", ""
                ).encode()
            sa = r["tags"].get(b"SAZ")
            # synthetic per-read voffset: container offset + ordinal
            # (dedup/identity key downstream; CRAM has no per-record
            # virtual offset). 24 ordinal bits cover any realistic
            # container; collisions would need > 16M records in one.
            append_read(
                cols, name_to_tid, self.rg_index,
                r["ref_id"], r["pos"], r["bf"], r["mapq"], r["tlen"],
                r["mate_ref"], r["mate_pos"], r["qname"], r["cigar"],
                r["rl"], rg_id if rg_id else None,
                sa if sa else None, (off << 24) | rec_ordinal,
            )
            rec_ordinal += 1
        batch = cols.to_batch()
        if len(self._container_cache) >= 4:  # small LRU-ish cache
            self._container_cache.pop(next(iter(self._container_cache)))
        self._container_cache[off] = batch
        return batch

    # -- BamFile surface -----------------------------------------------
    @property
    def crai(self) -> CraiIndex:
        if self._crai is None:
            import os
            import sys

            crai_path = self.path + ".crai"
            if os.path.exists(crai_path):
                self._crai = CraiIndex.load(crai_path)
            else:
                # no index: fall back to an in-memory one built from the
                # container headers (a cheap header-only scan; no record
                # decode). Multi-ref containers (ref_id=-2) are kept as
                # match-any rows.
                sys.stderr.write(
                    "warning: %s not found; building an in-memory index "
                    "from container headers (run samtools index, or ship "
                    "the .crai, to skip this scan)\n" % crai_path
                )
                rows = []
                for off in self._container_offsets():
                    ch = ContainerHeader.parse(self._buf, off)
                    rows.append(
                        [ch.ref_id, ch.start, ch.span, off, 0, 0]
                    )
                self._crai = CraiIndex(
                    np.asarray(rows, dtype=np.int64).reshape(-1, 6)
                )
        return self._crai

    def fetch(self, chrom: str, start: int, end: int) -> ReadBatch:
        tid = self.header.name_to_tid.get(chrom, -1)
        if tid < 0:
            return ReadBatch(0)
        start = max(0, start)
        parts = []
        # .crai container offsets are absolute file offsets (spec §12)
        for c_off in self.crai.containers_for(tid, start, end):
            b = self._decode_container(int(c_off))
            keep = np.flatnonzero(
                (b.tid == tid) & (b.pos < end) & (b.ref_end > start)
                & ((b.flag & FUNMAP) == 0)
            )
            if len(keep):
                parts.append(b.take(keep))
        return ReadBatch.concat(parts) if parts else ReadBatch(0)

    def fetch_many(self, regions, filt=None, transient: bool = False):
        """Batched fetch: (concatenated batch, region id per row) —
        same contract as BamFile.fetch_many (rows grouped by region in
        input order, coordinate order within each region)."""
        from svtyper_tpu_torch.bamio.bam import _apply_filter_py

        ref_len = {n: l for n, l in self.header.refs}
        batches = []
        ids = []
        for qi, (chrom, start, end) in enumerate(regions):
            end = min(end, ref_len.get(chrom, 0))
            if end <= max(start, 0):
                continue
            b = self.fetch(chrom, start, end)
            if b.n:
                batches.append(b)
                ids.append(np.full(b.n, qi, dtype=np.int32))
        if not batches:
            return ReadBatch(0), np.zeros(0, dtype=np.int32)
        batch = ReadBatch.concat(batches)
        rid = np.concatenate(ids)
        if filt is not None:
            batch, rid = _apply_filter_py(batch, rid, filt)
        return batch, rid

    def fetch_chunk(self, *a, **k):
        return None  # no native fast path for CRAM

    def scan(self, cursor=None, max_records: Optional[int] = None,
             keep_unmapped: bool = True):
        """Sequential container scan; ``cursor`` is an opaque container
        ordinal (None = start). Mirrors BamFile.scan's contract."""
        offs = self._container_offsets()
        i = cursor or 0
        parts = []
        seen = 0
        while i < len(offs) and (max_records is None or seen < max_records):
            b = self._decode_container(offs[i])
            i += 1
            seen += b.n
            if not keep_unmapped:
                b = b.take(np.flatnonzero((b.flag & FUNMAP) == 0))
            parts.append(b)
        batch = ReadBatch.concat(parts) if parts else ReadBatch(0)
        return batch, seen, i

    def head(self, max_records: int, keep_unmapped: bool = True) -> ReadBatch:
        batch, _, _ = self.scan(None, max_records, keep_unmapped)
        return batch

    def mapped_unmapped(self) -> Tuple[int, int]:
        if self._mapped_unmapped is None:
            mapped = unmapped = 0
            cursor = 0
            offs = self._container_offsets()
            while cursor < len(offs):
                b = self._decode_container(offs[cursor])
                cursor += 1
                un = int(np.count_nonzero(b.flag & FUNMAP))
                unmapped += un
                mapped += b.n - un
            self._mapped_unmapped = (mapped, unmapped)
        return self._mapped_unmapped

    def raw_records(self, voffsets):
        """BAM record bytes for ``-w/--write_alignment`` (reference
        ``classic.py::write_alignment`` gets this free from htslib).

        With a reference FASTA (``-T``), mapped records carry full
        SEQ/QUAL reconstructed from their features + the substitution
        matrix, and unmapped records their stored literal bases.
        Without one — or for legacy CF-0x8 files whose mismatches were
        never recorded — records are seq-less (``l_seq=0``, the BAM
        '*' form). Name, FLAG, position, MAPQ, CIGAR, mate, TLEN, and
        all aux tags are exact either way.
        """
        from collections import defaultdict

        by_cont = defaultdict(list)
        for slot, vo in enumerate(voffsets):
            by_cont[int(vo) >> 24].append((int(vo) & 0xFFFFFF, slot))
        out: List[bytes] = [b""] * len(voffsets)
        for off, wants in by_cont.items():
            # one-container memo: callers issuing per-row calls in
            # coordinate order (EvidenceWriter.close) cluster within a
            # container, so this keeps them O(containers) total
            if self._raw_cache is not None and self._raw_cache[0] == off:
                recs = self._raw_cache[1]
            else:
                recs = list(self._iter_container_records(off))
                self._raw_cache = (off, recs)
            ref_names = [name for name, _l in self.header.refs]
            for ordi, slot in wants:
                out[slot] = _rec_to_bam_bytes(
                    recs[ordi], self._fasta, ref_names
                )
        return out


_MISSING_CONTIGS_WARNED: set = set()


def _warn_missing_contig(fasta, name: str) -> None:
    """A -T FASTA missing a header contig (chr-prefix mismatch, partial
    reference) degrades that contig's records to seq-less instead of
    crashing -w mid-run — announced once per contig (review, r5)."""
    key = (id(fasta), name)
    if key not in _MISSING_CONTIGS_WARNED:
        _MISSING_CONTIGS_WARNED.add(key)
        import sys

        sys.stderr.write(
            "warning: contig %r not in reference FASTA %r — emitting "
            "seq-less records for it\n" % (name, fasta.path)
        )


_SUB_BASES = b"ACGTN"
_NIB = b"=ACMGRSVTWYHKDBN"
_NIB_OF = {b: i for i, b in enumerate(_NIB)}


def _decode_sub(ref_base: int, code: int, sm: bytes) -> int:
    """CRAM 3.0 substitution matrix: for reference base r (ACGTN row),
    the matrix byte packs 2-bit codes for the four alternative bases in
    ACGTN order; the stored feature value is the code (spec §10.5)."""
    ri = _SUB_BASES.find(ref_base)
    if ri < 0:
        ri = 4  # non-ACGTN reference bases use the N row
    byte = sm[ri]
    alts = [b for j, b in enumerate(_SUB_BASES) if j != ri]
    for j, alt in enumerate(alts):
        if (byte >> (6 - 2 * j)) & 3 == code:
            return alt
    return ord("N")


def _reconstruct_seq(r: dict, fasta, ref_name: str) -> Optional[bytes]:
    """Rebuild a mapped record's SEQ from its features + the reference
    (the delta encoding htslib applies; our reader only needs it for
    ``raw_records``/-w). Returns None when the file says no sequence
    was stored in reconstructable form (CF 0x8: legacy non-reference
    writes — M-run mismatches were never recorded)."""
    if r["cf"] & 0x8:
        return None
    rl = r["rl"]
    ref_span = rl + sum(
        ln for op, ln in r["cigar"] if op in (OP_D, OP_N)
    )
    ref = fasta.fetch(ref_name, r["pos"], r["pos"] + ref_span)
    seq = bytearray(rl)
    rp = 0  # read cursor (0-based)
    rf = 0  # reference cursor (relative)
    for code, p, val in r["feats"]:
        gap = (p - 1) - rp
        if gap > 0:  # implicit match run
            seq[rp : rp + gap] = ref[rf : rf + gap]
            rp += gap
            rf += gap
        if code in (ord("S"), ord("I")):
            seq[rp : rp + len(val)] = val
            rp += len(val)
        elif code == ord("b"):  # verbatim bases, consume reference too
            seq[rp : rp + len(val)] = val
            rp += len(val)
            rf += len(val)
        elif code == ord("i"):
            seq[rp] = val
            rp += 1
        elif code == ord("X"):
            seq[rp] = _decode_sub(ref[rf], val, r["sm"])
            rp += 1
            rf += 1
        elif code == ord("B"):
            seq[rp] = val[0]
            rp += 1
            rf += 1
        elif code in (ord("D"), ord("N")):
            rf += val
        # H/P/Q/q: no read bases, no reference bases
    if rp < rl:  # trailing match run
        seq[rp:] = ref[rf : rf + (rl - rp)]
    return bytes(seq)


def _rec_to_bam_bytes(r: dict, fasta=None, ref_names=None) -> bytes:
    """Encode one decoded CRAM record as a BAM record body (no leading
    block_size; see :meth:`CramFile.raw_records`). With a reference
    FASTA, mapped records regain full SEQ (features + substitution
    matrix) and stored QUAL; without one (or for legacy CF-0x8 files)
    the record is seq-less (BAM '*' form)."""
    from svtyper_tpu_torch.bamio.writer import _reg2bin_for

    seq = None
    if not (r["bf"] & FUNMAP):
        if fasta is not None and ref_names and 0 <= r["ref_id"] < len(
            ref_names
        ):
            name = ref_names[r["ref_id"]]
            if name in fasta:
                seq = _reconstruct_seq(r, fasta, name)
            else:
                _warn_missing_contig(fasta, name)
    elif r.get("bases"):
        seq = r["bases"]

    name = (r["qname"] or b"*") + b"\x00"
    if len(name) > 255:
        # l_read_name is one byte; a conforming file never exceeds 254
        raise ValueError(
            "CRAM QNAME longer than 254 bytes cannot be encoded as BAM: "
            "%r..." % name[:32]
        )
    cigar = r["cigar"] if not (r["bf"] & FUNMAP) else []
    span = sum(ln for op, ln in cigar if op in (OP_M, OP_D, OP_N))
    pos = r["pos"]
    bin_ = _reg2bin_for(pos, pos + max(span, 1)) if pos >= 0 else 4680
    body = bytearray()
    body += struct.pack(
        "<iiBBHHHIiii",
        r["ref_id"], pos, len(name), r["mapq"], bin_, len(cigar),
        r["bf"] & 0xFFFF, len(seq) if seq is not None else 0,
        r["mate_ref"], r["mate_pos"], r["tlen"],
    )
    body += name
    for op, ln in cigar:
        body += struct.pack("<I", (ln << 4) | op)
    if seq is not None:
        nib = bytearray((len(seq) + 1) // 2)
        for i, b in enumerate(seq):
            c = _NIB_OF.get(b, 15)
            nib[i >> 1] |= c << (4 if i % 2 == 0 else 0)
        body += bytes(nib)
        body += r["qual"] if r.get("qual") else b"\xff" * len(seq)
    for key, val in r["tags"].items():
        body += key  # 2-byte tag + 1-byte type, BAM form
        body += val
        if key[2:3] in (b"Z", b"H"):
            body += b"\x00"  # re-append the NUL decode_records strips
    return bytes(body)


def _refs_from_text(text: str) -> List[Tuple[str, int]]:
    refs = []
    for line in text.splitlines():
        if line.startswith("@SQ"):
            name = ln = None
            for f in line.split("\t")[1:]:
                if f.startswith("SN:"):
                    name = f[3:]
                elif f.startswith("LN:"):
                    ln = int(f[3:])
            if name is not None:
                refs.append((name, ln or 0))
    return refs
