"""BAM binary record decoding into columnar batches.

Pure-Python fallback backend (the C++ core in ``_native/`` implements the
same layout). One call decodes a whole BGZF byte range into a
:class:`~svtyper_tpu.bamio.columns.ReadBatch` — there are no per-read
Python objects on the fetch path (SURVEY.md §3.5).

BAM record layout (SAM spec §4.2): block_size i32, refID i32, pos i32,
l_read_name u8, mapq u8, bin u16, n_cigar_op u16, flag u16, l_seq u32,
next_refID i32, next_pos i32, tlen i32, read_name, cigar u32[n], seq
4-bit packed, qual, then aux tags.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.bamio.bgzf import VirtualStream
from svtyper_tpu_torch.bamio.cigar import CigarFeatures, parse_cigar_string
from svtyper_tpu_torch.bamio.columns import FREVERSE, FUNMAP, ReadBatch

_CORE = struct.Struct("<iiBBHHHIiii")  # refID..tlen (after block_size)

_TAG_SIZES = {
    ord("A"): 1, ord("c"): 1, ord("C"): 1,
    ord("s"): 2, ord("S"): 2,
    ord("i"): 4, ord("I"): 4, ord("f"): 4,
}


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _scan_cg(buf: bytes, off: int, end: int) -> Optional[List[Tuple[int, int]]]:
    """CG:B,I op array for the >65535-op long-CIGAR form (SAM spec
    §4.2.2): the record's cigar field holds a kSmN placeholder and the
    true ops (same len<<4|op encoding) live in this aux tag."""
    while off + 3 <= end:
        tag = buf[off : off + 2]
        typ = buf[off + 2]
        off += 3
        if typ in (ord("Z"), ord("H")):
            nul = buf.find(0, off, end)
            if nul < 0:
                # missing NUL terminator: fall back to the placeholder
                # cigar instead of raising, like the C++ cg_long_cigar
                return None
            off = nul + 1
        elif typ == ord("B"):
            if off + 5 > end:
                return None
            sub = buf[off]
            cnt = struct.unpack_from("<I", buf, off + 1)[0]
            # bounds + subtype guards mirror the C++ cg_long_cigar: a
            # corrupt count falls back to the placeholder cigar instead
            # of crashing (and keeps the two decoders in agreement)
            esz = _TAG_SIZES.get(sub, 4)
            if off + 5 + cnt * esz > end:
                return None
            if tag == b"CG" and sub == ord("I"):
                vals = struct.unpack_from("<%dI" % cnt, buf, off + 5)
                return [(v & 0xF, v >> 4) for v in vals]
            off += 5 + cnt * esz
        else:
            off += _TAG_SIZES.get(typ, 0) or (end - off)
    return None


def _scan_tags(buf: bytes, off: int, end: int) -> Tuple[Optional[bytes], Optional[bytes]]:
    """Return (RG value, SA value) Z-tag bytes if present."""
    rg = sa = None
    while off + 3 <= end:
        tag = buf[off : off + 2]
        typ = buf[off + 2]
        off += 3
        if typ in (ord("Z"), ord("H")):
            nul = buf.find(0, off, end)
            if nul < 0:
                break  # missing NUL: stop scanning, keep what we have
            if tag == b"RG":
                rg = buf[off:nul]
            elif tag == b"SA":
                sa = buf[off:nul]
            off = nul + 1
        elif typ == ord("B"):
            if off + 5 > end:
                break
            sub = buf[off]
            cnt = struct.unpack_from("<I", buf, off + 1)[0]
            off += 5 + cnt * _TAG_SIZES.get(sub, 4)
        else:
            off += _TAG_SIZES.get(typ, 0) or (end - off)
        if rg is not None and sa is not None:
            break
    return rg, sa


class _Cols:
    """Growable python-list column accumulator."""

    def __init__(self) -> None:
        self.tid: List[int] = []
        self.pos: List[int] = []
        self.ref_end: List[int] = []
        self.flag: List[int] = []
        self.mapq: List[int] = []
        self.tlen: List[int] = []
        self.mate_tid: List[int] = []
        self.mate_pos: List[int] = []
        self.qname_hash: List[int] = []
        self.left_soft: List[int] = []
        self.right_soft: List[int] = []
        self.ref_aln_len: List[int] = []
        self.query_len: List[int] = []
        self.lead_clip_q: List[int] = []
        self.lib_id: List[int] = []
        self.has_sa: List[bool] = []
        self.sa_tid: List[int] = []
        self.sa_pos: List[int] = []
        self.sa_end: List[int] = []
        self.sa_is_reverse: List[bool] = []
        self.sa_mapq: List[int] = []
        self.sa_lead_clip_q: List[int] = []
        self.voffset: List[int] = []
        self.blk_off: List[int] = [0]
        self.blk_start: List[int] = []
        self.blk_end: List[int] = []

    def to_batch(self) -> ReadBatch:
        d: Dict[str, np.ndarray] = {
            k: np.array(v) if v else np.zeros(0)
            for k, v in self.__dict__.items()
        }
        # plain np.array() on ints > 2**63 falls back to float64 and
        # silently rounds the low bits — force the unsigned dtypes
        d["qname_hash"] = np.array(self.qname_hash, dtype=np.uint64)
        d["voffset"] = np.array(self.voffset, dtype=np.uint64)
        d["blk_off"] = np.array(self.blk_off, dtype=np.int64)
        return ReadBatch.from_columns(d)


def append_read(
    cols: _Cols,
    name_to_tid: Dict[str, int],
    rg_index: Dict[bytes, int],
    tid: int,
    pos: int,
    flag: int,
    mapq: int,
    tlen: int,
    mtid: int,
    mpos: int,
    qname: bytes,
    cig_ops: List[Tuple[int, int]],
    l_seq: int,
    rg: Optional[bytes],
    sa: Optional[bytes],
    vo: int,
) -> None:
    """Append one decoded alignment to the column accumulator — the
    single place ReadBatch rows are derived from record fields, shared
    by the BAM decoder below and the CRAM decoder (bamio/cram.py)."""
    feats = CigarFeatures(pos, cig_ops)
    _append_with_feats(
        cols, name_to_tid, rg_index, tid, pos, flag, mapq, tlen,
        mtid, mpos, qname, feats, l_seq, rg, sa, vo,
    )


def _append_with_feats(
    cols, name_to_tid, rg_index, tid, pos, flag, mapq, tlen,
    mtid, mpos, qname, feats, l_seq, rg, sa, vo,
) -> None:
    is_rev = bool(flag & FREVERSE)
    cols.tid.append(tid)
    cols.pos.append(pos)
    cols.ref_end.append(feats.ref_end)
    cols.flag.append(flag)
    cols.mapq.append(mapq)
    cols.tlen.append(tlen)
    cols.mate_tid.append(mtid)
    cols.mate_pos.append(mpos)
    cols.qname_hash.append(_fnv1a(qname))
    cols.left_soft.append(feats.left_soft)
    cols.right_soft.append(feats.right_soft)
    cols.ref_aln_len.append(feats.ref_aln_len)
    cols.query_len.append(feats.query_len if feats.query_len else l_seq)
    cols.lead_clip_q.append(feats.lead_clip_query(is_rev))
    cols.lib_id.append(rg_index.get(rg, -1) if rg is not None else -1)
    if sa is not None:
        first = sa.split(b";", 1)[0].decode()
        rname, spos, strand, scigar, smapq, _nm = first.split(",")[:6]
        sops = parse_cigar_string(scigar)
        sfeats = CigarFeatures(int(spos) - 1, sops)
        cols.has_sa.append(True)
        cols.sa_tid.append(name_to_tid.get(rname, -1))
        cols.sa_pos.append(int(spos) - 1)
        cols.sa_end.append(sfeats.ref_end)
        cols.sa_is_reverse.append(strand == "-")
        cols.sa_mapq.append(int(smapq))
        cols.sa_lead_clip_q.append(sfeats.lead_clip_query(strand == "-"))
    else:
        cols.has_sa.append(False)
        cols.sa_tid.append(-1)
        cols.sa_pos.append(-1)
        cols.sa_end.append(-1)
        cols.sa_is_reverse.append(False)
        cols.sa_mapq.append(0)
        cols.sa_lead_clip_q.append(0)
    cols.voffset.append(vo)
    cols.blk_off.append(cols.blk_off[-1] + len(feats.blocks))
    for bs, be in feats.blocks:
        cols.blk_start.append(bs)
        cols.blk_end.append(be)


def decode_stream(
    vs: VirtualStream,
    ref_names: List[str],
    rg_index: Dict[bytes, int],
    stop_voffset: Optional[int] = None,
    max_records: Optional[int] = None,
    region: Optional[Tuple[int, int, int]] = None,
    keep_unmapped: bool = False,
) -> Tuple[ReadBatch, int]:
    """Decode records from ``vs`` until EOF/stop/region-end.

    ``region=(tid,start,end)``: emit only reads overlapping [start,end) on
    tid; assumes coordinate order and stops once past it. Returns
    (batch, records_seen).
    """
    name_to_tid = {n: i for i, n in enumerate(ref_names)}
    cols = _Cols()
    seen = 0
    unpack_core = _CORE.unpack_from
    while True:
        if stop_voffset is not None and vs.voffset >= stop_voffset:
            break
        if max_records is not None and seen >= max_records:
            break
        if not vs.normalize():
            break
        vo = vs.voffset
        head = vs.read(4)
        if len(head) < 4:
            break
        (block_size,) = struct.unpack("<i", head)
        rec = vs.read(block_size)
        if len(rec) < block_size:
            raise ValueError("truncated BAM record")
        (
            tid, pos, l_rn, mapq, _bin, n_cig, flag, l_seq,
            mtid, mpos, tlen,
        ) = unpack_core(rec, 0)
        seen += 1
        if region is not None:
            rtid, rstart, rend = region
            if tid != rtid or pos >= rend:
                break  # coordinate-sorted: nothing further can overlap
        if (flag & FUNMAP) and not keep_unmapped:
            continue
        off = 32
        qname = rec[off : off + l_rn - 1]
        off += l_rn
        cig_ops = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", rec, off)
            cig_ops.append((v & 0xF, v >> 4))
            off += 4
        if (
            n_cig == 2 and l_seq > 0 and cig_ops[0] == (4, l_seq)
            and cig_ops[1][0] == 3
        ):
            # possible long-CIGAR placeholder (kSmN): use CG:B,I ops
            cg_ops = _scan_cg(
                rec, off + (l_seq + 1) // 2 + l_seq, block_size
            )
            if cg_ops is not None:
                cig_ops = cg_ops
        feats = CigarFeatures(pos, cig_ops)
        if region is not None and feats.ref_end <= region[1]:
            continue  # no overlap with [start, end)
        off += (l_seq + 1) // 2 + l_seq  # skip seq + qual
        rg, sa = _scan_tags(rec, off, block_size)
        _append_with_feats(
            cols, name_to_tid, rg_index, tid, pos, flag, mapq, tlen,
            mtid, mpos, qname, feats, l_seq, rg, sa, vo,
        )
    return cols.to_batch(), seen
