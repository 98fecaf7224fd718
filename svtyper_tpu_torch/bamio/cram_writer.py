"""CRAM 3.0 writer + BAM→CRAM transcoder (test fixtures).

Same role as ``bamio/writer.py``'s BamWriter: the package synthesizes
its own alignment fixtures because no external data exists in this
offline environment (SURVEY.md §0). The writer emits spec-conforming
single-slice containers: all-EXTERNAL integer series (each in its own
content-id stream, gzip or rANS compressed), read names via
BYTE_ARRAY_STOP, soft-clip/insertion bases and tag values via
BYTE_ARRAY_LEN, detached mate records, AP-delta coordinates, and a
``.crai`` index. ``bamio/cram.py`` reads this (and the htslib feature
set beyond it).
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from svtyper_tpu_torch.bamio.bgzf import BgzfReader, VirtualStream
from svtyper_tpu_torch.bamio.cigar import CigarFeatures
from svtyper_tpu_torch.bamio.cram import (
    CRAM_MAGIC,
    CT_COMP_HEADER,
    CT_CORE,
    CT_EXTERNAL,
    CT_FILE_HEADER,
    CT_SLICE_HEADER,
    ContainerHeader,
    E_BYTE_ARRAY_LEN,
    E_BYTE_ARRAY_STOP,
    E_EXTERNAL,
    M_GZIP,
    M_RANS,
    M_RAW,
    OP_D,
    OP_H,
    OP_I,
    OP_M,
    OP_N,
    OP_P,
    OP_S,
    write_block,
    write_itf8,
)
from svtyper_tpu_torch.bamio.columns import FUNMAP

# fixed content ids for the integer series (writer-chosen; readers use
# whatever the compression header declares)
_IDS = {
    b"BF": 1, b"CF": 2, b"RL": 3, b"AP": 4, b"RG": 5, b"MF": 7,
    b"NS": 8, b"NP": 9, b"TS": 10, b"TL": 11, b"FN": 12, b"FP": 14,
    b"DL": 15, b"HC": 20, b"PD": 21, b"RS": 22, b"MQ": 23,
}
_ID_RN, _ID_FC = 6, 13
_ID_SC_VAL, _ID_SC_LEN, _ID_IN_VAL, _ID_IN_LEN = 16, 17, 18, 19
_ID_BS, _ID_QS = 24, 25
_ID_BB_LEN, _ID_BB_VAL = 26, 27
_ID_BA = 28
_ID_TAG_BASE = 32

# CRAM 3.0 substitution matrix (spec §10.5): one byte per reference
# base (ACGTN rows), 2-bit codes for the four alternatives in ACGTN
# order. 0x1B = codes 0,1,2,3 in order — htslib's default shape.
_DEFAULT_SM = bytes([0x1B] * 5)
_SUB_BASES = b"ACGTN"


def _sub_code(ref_b: int, alt_b: int):
    """Substitution code for alt given ref under _DEFAULT_SM, or None
    when alt is not representable (non-ACGTN read base)."""
    ri = _SUB_BASES.find(ref_b)
    if ri < 0:
        ri = 4
    alts = [b for j, b in enumerate(_SUB_BASES) if j != ri]
    try:
        j = alts.index(alt_b)
    except ValueError:
        return None
    return (_DEFAULT_SM[ri] >> (6 - 2 * j)) & 3
_RANS_SERIES = {b"BF", b"CF", b"FN"}  # exercise the rANS codec in-file

_X_OPS = {OP_M, 7, 8}  # M/=/X are implicit matches


def _enc_external(out: bytearray, content_id: int) -> None:
    write_itf8(out, E_EXTERNAL)
    p = bytearray()
    write_itf8(p, content_id)
    write_itf8(out, len(p))
    out.extend(p)


def _enc_byte_array_stop(out: bytearray, stop: int, content_id: int) -> None:
    write_itf8(out, E_BYTE_ARRAY_STOP)
    p = bytearray([stop])
    write_itf8(p, content_id)
    write_itf8(out, len(p))
    out.extend(p)


def _enc_byte_array_len(out: bytearray, len_id: int, val_id: int) -> None:
    write_itf8(out, E_BYTE_ARRAY_LEN)
    p = bytearray()
    _enc_external(p, len_id)
    _enc_external(p, val_id)
    write_itf8(out, len(p))
    out.extend(p)


def _cigar_to_features(cigar, seq: str, ref: bytes = None):
    """(code, read_pos_1based, payload) features for one alignment.

    With ``ref`` (reference bases starting at the record's POS), M-run
    mismatches are recorded as substitution features ('X', code vs the
    default matrix; non-ACGTN read bases fall back to a verbatim 'b'
    run) — the reference-based form whose SEQ a reader with the FASTA
    can reconstruct exactly."""
    feats = []
    rpos = 1
    rf = 0  # reference cursor (only meaningful when ref is given)
    sb = seq.encode() if isinstance(seq, str) else (seq or b"")
    for op, ln in cigar:
        if op in _X_OPS:
            if ref is not None and sb:
                for k in range(ln):
                    rb = ref[rf + k] if rf + k < len(ref) else ord("N")
                    ab = sb[rpos - 1 + k] if rpos - 1 + k < len(sb)                         else ord("N")
                    if ab == rb:
                        continue
                    code = _sub_code(rb, ab)
                    if code is None:
                        feats.append((ord("b"), rpos + k, bytes([ab])))
                    else:
                        feats.append((ord("X"), rpos + k, code))
            rf += ln
            rpos += ln
            continue
        elif op == OP_S:
            bases = seq[rpos - 1 : rpos - 1 + ln] if seq else ""
            feats.append((ord("S"), rpos, (bases or "N" * ln).encode()))
            rpos += ln
        elif op == OP_I:
            bases = seq[rpos - 1 : rpos - 1 + ln] if seq else ""
            feats.append((ord("I"), rpos, (bases or "N" * ln).encode()))
            rpos += ln
        elif op == OP_D:
            feats.append((ord("D"), rpos, ln))
            rf += ln
        elif op == OP_N:
            feats.append((ord("N"), rpos, ln))
            rf += ln
        elif op == OP_H:
            feats.append((ord("H"), rpos, ln))
        elif op == OP_P:
            feats.append((ord("P"), rpos, ln))
        else:
            raise ValueError("unsupported CIGAR op %d" % op)
    return feats


_FEAT_SERIES_INT = {ord("D"): b"DL", ord("H"): b"HC",
                    ord("N"): b"RS", ord("P"): b"PD"}


class CramWriter:
    """Drop-in sibling of BamWriter for CRAM output."""

    def __init__(self, path: str, refs: Sequence[Tuple[str, int]],
                 header_text: str = "", records_per_slice: int = 4096,
                 slices_per_container: int = 1,
                 ref_fasta: str = None,
                 ) -> None:
        self.path = path
        self.refs = list(refs)
        # reference-based mode: M-run mismatches become substitution
        # features and quals are stored, so a reader with the same
        # FASTA reconstructs full SEQ/QUAL (CRAM 3.0 §10.5)
        self._fasta = None
        if ref_fasta:
            from svtyper_tpu_torch.bamio.fasta import FastaFile

            self._fasta = FastaFile(ref_fasta)
        self._fh = open(path, "wb")
        self._fh.write(CRAM_MAGIC + bytes([3, 0]) + b"svtyper_tpu".ljust(20, b"\x00"))
        # file-header container: one gzip block with i32-length + SAM text
        text = header_text.encode()
        blk = bytearray()
        write_block(blk, M_GZIP, CT_FILE_HEADER, 0,
                    struct.pack("<i", len(text)) + text)
        hdr = ContainerHeader.emit(-1, 0, 0, 0, 0, 0, 1, [], len(blk))
        self._fh.write(hdr + bytes(blk))
        self._per_slice = records_per_slice
        # htslib packs multiple slices into one container (one shared
        # compression header, landmark per slice); >1 exercises the
        # reader's multi-slice path with our own writer
        self._slices_per_container = max(1, slices_per_container)
        self._recs: List[dict] = []
        self._cur_tid: Optional[int] = None
        self._counter = 0
        self._crai: List[Tuple[int, ...]] = []
        self._last_pos: Optional[Tuple[int, int]] = None
        self._td_lines: List[bytes] = [b""]
        self._td_index: Dict[bytes, int] = {b"": 0}
        self._rg_names: List[str] = []
        for line in header_text.splitlines():
            if line.startswith("@RG"):
                for f in line.split("\t")[1:]:
                    if f.startswith("ID:"):
                        self._rg_names.append(f[3:])
        self._rg_of = {n: i for i, n in enumerate(self._rg_names)}

    # ------------------------------------------------------------ write
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
        raw_tags: Optional[List[Tuple[bytes, int, bytes]]] = None,
    ) -> None:
        if raw_tags is None:
            raw_tags = []
            for tag, (typ, val) in (tags or {}).items():
                if typ in ("Z", "H"):
                    raw_tags.append(
                        (tag.encode(), ord(typ), str(val).encode() + b"\x00")
                    )
                elif typ == "i":
                    raw_tags.append(
                        (tag.encode(), ord("i"), struct.pack("<i", int(val)))
                    )
                else:
                    raise ValueError("unsupported tag type %r" % typ)
        rg = -1
        kept_tags = []
        for tag, typ, val in raw_tags:
            if tag == b"RG":
                rg = self._rg_of.get(val.rstrip(b"\x00").decode(), -1)
            else:
                kept_tags.append((tag, typ, val))
        if not (flag & FUNMAP):
            if self._last_pos is not None and (tid, pos) < self._last_pos:
                raise ValueError(
                    "records must be written in coordinate order"
                )
            self._last_pos = (tid, pos)
        if self._recs and (
            len(self._recs) >= self._per_slice * self._slices_per_container
            or (self._cur_tid is not None and tid != self._cur_tid)
        ):
            self._flush_container()
        self._cur_tid = tid
        refbased = False
        bases = None
        if flag & FUNMAP:
            feats = []
            if self._fasta is not None and seq:
                # reference-based files keep unmapped reads' literal
                # bases (BA series) so -w round-trips them too
                # (review, r5)
                bases = seq.encode() if isinstance(seq, str) else seq
        elif (self._fasta is not None and 0 <= tid < len(self.refs)
                and self.refs[tid][0] in self._fasta):
            ref_span = sum(
                ln for op, ln in cigar if op in _X_OPS or op in (OP_D, OP_N)
            )
            ref = self._fasta.fetch(
                self.refs[tid][0], max(pos, 0), max(pos, 0) + ref_span
            )
            feats = _cigar_to_features(cigar, seq, ref)
            refbased = bool(seq)
        else:
            feats = _cigar_to_features(cigar, seq)
        c = CigarFeatures(max(pos, 0), list(cigar)) if cigar else None
        rl = (c.query_len if c and c.query_len else len(seq)) or 0
        td_key = bytes(b"".join(t + bytes([y]) for t, y, _ in kept_tags))
        tl = self._td_index.get(td_key)
        if tl is None:
            tl = len(self._td_lines)
            self._td_lines.append(td_key)
            self._td_index[td_key] = tl
        self._recs.append({
            "bf": flag, "tid": tid, "pos": pos, "mapq": mapq, "rl": rl,
            "rg": rg, "qname": qname.encode(), "mate_tid": mate_tid,
            "mate_pos": mate_pos, "tlen": tlen, "feats": feats,
            "tl": tl, "tags": kept_tags, "refbased": refbased,
            "bases": bases, "qual": bytes(qual) if qual else None,
            "ref_end": (c.ref_end if c else pos) if not (flag & FUNMAP)
            else pos,
        })

    # ------------------------------------------------------------ flush
    def _encode_slice(
        self,
        recs: List[dict],
        tid: int,
        tag_ids: Dict[Tuple[bytes, int], Tuple[int, int]],
        first_rec_counter: int,
    ):
        """Encode one slice's records → (slice-header bytes, start,
        span, external streams). ``tag_ids`` is shared across a
        container's slices (the compression header is per container)."""
        start = min(r["pos"] for r in recs) + 1  # 1-based
        span = max(r["ref_end"] for r in recs) - (start - 1)
        streams: Dict[int, bytearray] = {}

        def s(cid: int) -> bytearray:
            st = streams.get(cid)
            if st is None:
                st = streams[cid] = bytearray()
            return st

        def put_int(key: bytes, v: int) -> None:
            write_itf8(s(_IDS[key]), v)

        # AP delta base = the SLICE's start (reader: prev_ap = sh.start)
        prev_ap = start
        for r in recs:
            ap = r["pos"] + 1
            put_int(b"BF", r["bf"])
            # CF: detached mate; 0x8 (sequence not reconstructable)
            # only when NOT reference-based; 0x1 when quals stored
            cf = 0x2
            if not (r.get("refbased") or r.get("bases")):
                cf |= 0x8
            if r.get("qual"):
                cf |= 0x1
            put_int(b"CF", cf)
            put_int(b"RL", r["rl"])
            put_int(b"AP", ap - prev_ap)
            prev_ap = ap
            put_int(b"RG", r["rg"])
            s(_ID_RN).extend(r["qname"] + b"\x00")
            mf = (0x1 if r["bf"] & 0x20 else 0) | (0x2 if r["bf"] & 0x8 else 0)
            put_int(b"MF", mf)
            put_int(b"NS", r["mate_tid"])
            put_int(b"NP", r["mate_pos"] + 1)
            put_int(b"TS", r["tlen"])
            put_int(b"TL", r["tl"])
            for tag, typ, val in r["tags"]:
                key = (tag, typ)
                ids = tag_ids.get(key)
                if ids is None:
                    base = _ID_TAG_BASE + 2 * len(tag_ids)
                    ids = tag_ids[key] = (base, base + 1)
                write_itf8(s(ids[0]), len(val))
                s(ids[1]).extend(val)
            if not (r["bf"] & FUNMAP):
                put_int(b"FN", len(r["feats"]))
                prev_p = 0
                for code, p, val in r["feats"]:
                    s(_ID_FC).append(code)
                    put_int(b"FP", p - prev_p)
                    prev_p = p
                    if code in _FEAT_SERIES_INT:
                        put_int(_FEAT_SERIES_INT[code], val)
                    elif code == ord("S"):
                        write_itf8(s(_ID_SC_LEN), len(val))
                        s(_ID_SC_VAL).extend(val)
                    elif code == ord("X"):
                        s(_ID_BS).append(val)
                    elif code == ord("b"):
                        write_itf8(s(_ID_BB_LEN), len(val))
                        s(_ID_BB_VAL).extend(val)
                    else:  # insertion
                        write_itf8(s(_ID_IN_LEN), len(val))
                        s(_ID_IN_VAL).extend(val)
                put_int(b"MQ", r["mapq"])
            elif r.get("bases"):
                # unmapped + stored bases: BA literal series
                s(_ID_BA).extend(r["bases"][:r["rl"]].ljust(
                    r["rl"], b"N"))
            if r.get("qual"):
                s(_ID_QS).extend(r["qual"][:r["rl"]].ljust(
                    r["rl"], b"\xff"))

        content_ids = sorted(streams)
        sh = bytearray()
        write_itf8(sh, tid)
        write_itf8(sh, start)
        write_itf8(sh, span)
        write_itf8(sh, len(recs))
        from svtyper_tpu_torch.bamio.cram import write_ltf8

        # the slice header carries the record counter of ITS first
        # record; the container header carries the container's
        # (CRAM 3.0 §8)
        write_ltf8(sh, first_rec_counter)
        write_itf8(sh, 1 + len(content_ids))  # core + externals
        write_itf8(sh, len(content_ids))
        for cid in content_ids:
            write_itf8(sh, cid)
        write_itf8(sh, -1)  # no embedded reference
        sh.extend(b"\x00" * 16)  # md5 not computed (RR=false)
        return sh, start, span, streams

    def _flush_container(self) -> None:
        recs_all, self._recs = self._recs, []
        if not recs_all:
            return
        tid = recs_all[0]["tid"]
        groups = [
            recs_all[i : i + self._per_slice]
            for i in range(0, len(recs_all), self._per_slice)
        ]
        tag_ids: Dict[Tuple[bytes, int], Tuple[int, int]] = {}
        encoded = []
        counter = self._counter
        for g in groups:
            encoded.append(self._encode_slice(g, tid, tag_ids, counter))
            counter += len(g)

        comp = self._compression_header(tag_ids)
        blocks = bytearray()
        write_block(blocks, M_GZIP, CT_COMP_HEADER, 0, bytes(comp))
        rans_ids = {_IDS[k] for k in _RANS_SERIES}
        landmarks = []
        crai_rows = []
        for sh, s_start, s_span, streams in encoded:
            landmarks.append(len(blocks))
            slice_blocks = bytearray()
            write_block(slice_blocks, M_RAW, CT_SLICE_HEADER, 0, bytes(sh))
            write_block(slice_blocks, M_RAW, CT_CORE, 0, b"")
            for cid in sorted(streams):
                method = M_RANS if cid in rans_ids else M_GZIP
                write_block(slice_blocks, method, CT_EXTERNAL, cid,
                            bytes(streams[cid]))
            blocks.extend(slice_blocks)
            crai_rows.append(
                (tid, s_start, s_span, landmarks[-1], len(slice_blocks))
            )
        start = min(r["pos"] for r in recs_all) + 1
        span = max(r["ref_end"] for r in recs_all) - (start - 1)
        n_blocks = 1 + sum(2 + len(st) for _, _, _, st in encoded)
        hdr = ContainerHeader.emit(
            tid, start, span, len(recs_all), self._counter,
            sum(r["rl"] for r in recs_all), n_blocks,
            landmarks, len(blocks),
        )
        c_off = self._fh.tell()
        self._fh.write(hdr + bytes(blocks))
        for t, s_start, s_span, s_off, s_len in crai_rows:
            self._crai.append((t, s_start, s_span, c_off, s_off, s_len))
        self._counter += len(recs_all)

    def _compression_header(self, tag_ids) -> bytearray:
        pres = bytearray()
        n_pres = 0
        for key, flag in ((b"AP", 1), (b"RN", 1), (b"RR", 0)):
            pres.extend(key)
            pres.append(flag)
            n_pres += 1
        pres.extend(b"SM" + _DEFAULT_SM)
        n_pres += 1
        td_blob = b"\x00".join(self._td_lines)
        pres.extend(b"TD")
        write_itf8(pres, len(td_blob))
        pres.extend(td_blob)
        n_pres += 1

        ds = bytearray()
        n_ds = 0
        for key, cid in _IDS.items():
            ds.extend(key)
            _enc_external(ds, cid)
            n_ds += 1
        ds.extend(b"RN")
        _enc_byte_array_stop(ds, 0x00, _ID_RN)
        n_ds += 1
        ds.extend(b"FC")
        _enc_external(ds, _ID_FC)
        n_ds += 1
        ds.extend(b"SC")
        _enc_byte_array_len(ds, _ID_SC_LEN, _ID_SC_VAL)
        n_ds += 1
        ds.extend(b"IN")
        _enc_byte_array_len(ds, _ID_IN_LEN, _ID_IN_VAL)
        n_ds += 1
        ds.extend(b"BS")
        _enc_external(ds, _ID_BS)
        n_ds += 1
        ds.extend(b"QS")
        _enc_external(ds, _ID_QS)
        n_ds += 1
        ds.extend(b"BB")
        _enc_byte_array_len(ds, _ID_BB_LEN, _ID_BB_VAL)
        n_ds += 1
        ds.extend(b"BA")
        _enc_external(ds, _ID_BA)
        n_ds += 1

        tg = bytearray()
        for (tag, typ), (lid, vid) in tag_ids.items():
            write_itf8(tg, (tag[0] << 16) | (tag[1] << 8) | typ)
            _enc_byte_array_len(tg, lid, vid)

        out = bytearray()
        for body, n in ((pres, n_pres), (ds, n_ds), (tg, len(tag_ids))):
            m = bytearray()
            write_itf8(m, n)
            m.extend(body)
            write_itf8(out, len(m))
            out.extend(m)
        return out

    def close(self, write_index: bool = True) -> None:
        self._flush_container()
        # EOF container: 0 records, ref -1, one empty raw block
        blk = bytearray()
        write_block(blk, M_RAW, CT_COMP_HEADER, 0, b"")
        self._fh.write(
            ContainerHeader.emit(-1, 0, 0, 0, 0, 0, 1, [], len(blk))
            + bytes(blk)
        )
        self._fh.close()
        if write_index:
            lines = b"".join(
                b"%d\t%d\t%d\t%d\t%d\t%d\n" % row for row in self._crai
            )
            with gzip.open(self.path + ".crai", "wb") as fh:
                fh.write(lines)


# ------------------------------------------------------------ transcode

_CORE = struct.Struct("<iiBBHHHIiii")
_TAG_SIZES = {
    ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
    ord("i"): 4, ord("I"): 4, ord("f"): 4,
}


_NIB = b"=ACMGRSVTWYHKDBN"


def iter_bam_records(path: str):
    """Full-fidelity BAM record iterator (qname, flag, tid, pos, mapq,
    cigar, mate_tid, mate_pos, tlen, seq, qual, raw tag list) —
    transcode support, not the fetch hot path."""
    reader = BgzfReader(path)
    vs = VirtualStream(reader)
    magic = vs.read(4)
    assert magic == b"BAM\x01", path
    (l_text,) = struct.unpack("<i", vs.read(4))
    vs.read(l_text)
    (n_ref,) = struct.unpack("<i", vs.read(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", vs.read(4))
        vs.read(l_name + 4)
    while True:
        if not vs.normalize():
            break
        head = vs.read(4)
        if len(head) < 4:
            break
        (block_size,) = struct.unpack("<i", head)
        rec = vs.read(block_size)
        (tid, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, mtid, mpos,
         tlen) = _CORE.unpack_from(rec, 0)
        off = 32
        qname = rec[off : off + l_rn - 1].decode()
        off += l_rn
        cigar = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", rec, off)
            cigar.append((v & 0xF, v >> 4))
            off += 4
        nib = rec[off : off + (l_seq + 1) // 2]
        seq = "".join(
            chr(_NIB[(nib[i >> 1] >> (4 if i % 2 == 0 else 0)) & 0xF])
            for i in range(l_seq)
        )
        off += (l_seq + 1) // 2
        qual = rec[off : off + l_seq]
        if qual[:1] == b"\xff" and qual == b"\xff" * l_seq:
            qual = b""  # BAM '*' quals
        off += l_seq
        raw_tags = []
        while off + 3 <= block_size:
            tag = rec[off : off + 2]
            typ = rec[off + 2]
            off += 3
            if typ in (ord("Z"), ord("H")):
                nul = rec.index(0, off)
                raw_tags.append((tag, typ, rec[off : nul + 1]))
                off = nul + 1
            elif typ == ord("B"):
                sub = rec[off]
                (cnt,) = struct.unpack_from("<I", rec, off + 1)
                ln = 5 + cnt * _TAG_SIZES[sub]
                raw_tags.append((tag, typ, rec[off : off + ln]))
                off += ln
            else:
                ln = _TAG_SIZES[typ]
                raw_tags.append((tag, typ, rec[off : off + ln]))
                off += ln
        yield (qname, flag, tid, pos, mapq, cigar, mtid, mpos, tlen,
               seq, qual, raw_tags)


def bam_to_cram(bam_path: str, cram_path: str,
                refs: Optional[Sequence[Tuple[str, int]]] = None,
                **writer_kwargs) -> None:
    """Transcode a coordinate-sorted BAM into CRAM (fixture helper).
    ``writer_kwargs`` pass through to :class:`CramWriter` (e.g.
    ``records_per_slice``, ``slices_per_container``)."""
    from svtyper_tpu_torch.bamio.bam import BamFile

    bf = BamFile(bam_path, use_native=False)
    w = CramWriter(cram_path, bf.header.refs, bf.header.text,
                   **writer_kwargs)
    for (qname, flag, tid, pos, mapq, cigar, mtid, mpos, tlen, seq,
         qual, raw_tags) in iter_bam_records(bam_path):
        w.write(qname, flag, tid, pos, mapq, cigar, mtid, mpos, tlen,
                seq=seq, qual=qual or None, raw_tags=raw_tags)
    w.close()
