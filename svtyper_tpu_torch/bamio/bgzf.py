"""BGZF (blocked gzip) reader/writer.

BGZF is the container format of BAM/BAI ecosystems: a concatenation of gzip
members, each at most 64 KiB uncompressed, carrying their compressed size in
a ``BC`` extra subfield so that virtual offsets ``(coffset << 16) | uoffset``
allow random access. Replaces the htslib BGZF layer used (via pysam) by the
reference (SURVEY.md §2.1 "Native components").
"""

from __future__ import annotations

import struct
import zlib
from collections import OrderedDict
from typing import IO, Tuple

# 28-byte empty BGZF block that terminates every BGZF file.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2B2H")  # magic..XLEN


def _parse_block_header(buf: bytes, off: int) -> Tuple[int, int]:
    """Return (compressed_data_start, total_block_size) for block at off."""
    if buf[off] != 0x1F or buf[off + 1] != 0x8B:
        raise ValueError("not a gzip member at offset %d" % off)
    flg = buf[off + 3]
    if not flg & 4:
        raise ValueError("gzip member without FEXTRA: not BGZF")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    xoff = off + 12
    xend = xoff + xlen
    bsize = None
    while xoff < xend:
        si1, si2, slen = struct.unpack_from("<BBH", buf, xoff)
        if si1 == 66 and si2 == 67 and slen == 2:  # 'BC'
            bsize = struct.unpack_from("<H", buf, xoff + 4)[0] + 1
        xoff += 4 + slen
    if bsize is None:
        raise ValueError("BGZF BC subfield missing")
    return xend, bsize


def decompress_block(buf: bytes, off: int) -> Tuple[bytes, int]:
    """Inflate the BGZF block at ``off``; return (data, next_block_offset)."""
    data_start, bsize = _parse_block_header(buf, off)
    cdata = buf[data_start : off + bsize - 8]
    data = zlib.decompress(cdata, wbits=-15)
    isize = struct.unpack_from("<I", buf, off + bsize - 4)[0]
    if len(data) != isize:
        raise ValueError("BGZF ISIZE mismatch")
    return data, off + bsize


class BgzfReader:
    """Random-access BGZF reader over an mmap'd/whole-file buffer.

    BAM files touched per-variant are re-read many times with high locality;
    a small LRU of inflated blocks makes repeated region fetches cheap.
    """

    def __init__(self, path: str, cache_blocks: int = 512) -> None:
        self.path = path
        self._fh = open(path, "rb")
        try:
            import mmap

            self._buf = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file or no mmap support
            self._buf = self._fh.read()
        self._cache: "OrderedDict[int, Tuple[bytes, int]]" = OrderedDict()
        self._cache_blocks = cache_blocks

    def block_at(self, coffset: int) -> Tuple[bytes, int]:
        """Inflated data of the block starting at coffset + next coffset."""
        hit = self._cache.get(coffset)
        if hit is not None:
            self._cache.move_to_end(coffset)
            return hit
        data, nxt = decompress_block(self._buf, coffset)
        self._cache[coffset] = (data, nxt)
        if len(self._cache) > self._cache_blocks:
            self._cache.popitem(last=False)
        return data, nxt

    @property
    def file_size(self) -> int:
        return len(self._buf)

    def at_eof(self, coffset: int) -> bool:
        if coffset >= len(self._buf):
            return True
        # the EOF sentinel block inflates to b""
        data, _ = self.block_at(coffset)
        return len(data) == 0 and coffset + 28 >= len(self._buf)


class VirtualStream:
    """Sequential byte reader starting at a BGZF virtual offset."""

    __slots__ = ("reader", "coffset", "uoffset", "_data", "_next")

    def __init__(self, reader: BgzfReader, voffset: int = 0) -> None:
        self.reader = reader
        self.seek(voffset)

    def seek(self, voffset: int) -> None:
        self.coffset = voffset >> 16
        self.uoffset = voffset & 0xFFFF
        if self.coffset < self.reader.file_size:
            self._data, self._next = self.reader.block_at(self.coffset)
        else:
            self._data, self._next = b"", self.coffset

    @property
    def voffset(self) -> int:
        return (self.coffset << 16) | self.uoffset

    def normalize(self) -> bool:
        """Canonicalize a block-boundary position to (next_block, 0) —
        the convention of the writer and BAI chunks. False at EOF."""
        while self.uoffset >= len(self._data):
            if not self._advance_block():
                return False
        return True

    def _advance_block(self) -> bool:
        if self._next >= self.reader.file_size:
            return False
        self.coffset = self._next
        self._data, self._next = self.reader.block_at(self.coffset)
        self.uoffset = 0
        return len(self._data) > 0 or self._advance_block()

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            avail = len(self._data) - self.uoffset
            if avail <= 0:
                if not self._advance_block():
                    break
                continue
            take = min(avail, n)
            out += self._data[self.uoffset : self.uoffset + take]
            self.uoffset += take
            n -= take
        return bytes(out)

    def eof(self) -> bool:
        if self.uoffset < len(self._data):
            return False
        save_c, save_u = self.coffset, self.uoffset
        ok = self._advance_block()
        if ok:
            # rewind: caller only asked whether data remains
            self.coffset, self.uoffset = save_c, save_u
            self._data, self._next = self.reader.block_at(self.coffset)
            return False
        return True


class BgzfWriter:
    """Streaming BGZF compressor (used by the BAM writer and ``-w``)."""

    MAX_BLOCK = 0xFF00  # uncompressed payload per block

    def __init__(self, fileobj: IO[bytes], level: int = 6) -> None:
        self._fh = fileobj
        self._level = level
        self._pending = bytearray()

    def tell_voffset(self) -> int:
        return (self._fh.tell() << 16) | len(self._pending)

    def write(self, data: bytes) -> None:
        self._pending += data
        while len(self._pending) >= self.MAX_BLOCK:
            self._flush_block(self.MAX_BLOCK)

    def flush(self) -> None:
        while self._pending:
            self._flush_block(min(len(self._pending), self.MAX_BLOCK))

    def write_bulk(self, data: bytes):
        """Write ``data`` as full MAX_BLOCK blocks (+ a pending tail)
        and return the compressed offset of every block boundary:
        ``offs[i]`` is where block ``i`` starts, so the virtual offset
        of uncompressed position P within ``data`` is
        ``offs[P // MAX_BLOCK] << 16 | (P % MAX_BLOCK)`` — the bulk
        writer's replacement for per-record tell_voffset() calls.
        Requires an empty pending buffer (call flush() first)."""
        if self._pending:
            raise ValueError("write_bulk requires a flushed writer")
        B = self.MAX_BLOCK
        offs = []
        i, n = 0, len(data)
        while n - i >= B:
            offs.append(self._fh.tell())
            self._pending += data[i : i + B]
            self._flush_block(B)
            i += B
        # trailing partial block: tell() is exactly where it will start
        # once flushed, matching tell_voffset()'s convention
        offs.append(self._fh.tell())
        self._pending += data[i:]
        return offs

    def _flush_block(self, n: int) -> None:
        chunk = bytes(self._pending[:n])
        del self._pending[:n]
        comp = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = comp.compress(chunk) + comp.flush()
        bsize = len(cdata) + 26
        if bsize > 0xFFFF:
            raise ValueError("BGZF block overflow")
        header = (
            b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC"
            + struct.pack("<HH", 2, bsize - 1)
        )
        self._fh.write(header)
        self._fh.write(cdata)
        self._fh.write(struct.pack("<II", zlib.crc32(chunk), len(chunk)))

    def close(self) -> None:
        self.flush()
        self._fh.write(BGZF_EOF)
