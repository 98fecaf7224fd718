"""rANS 4x8 codec (CRAM 3.0 block compression method 4).

Order-0 and order-1 static arithmetic coding with four interleaved
rANS states, per the CRAM 3.0 spec §13 (the reference delegates all of
CRAM to htslib's ``rANS_static.c``; this is the from-scratch equivalent,
pure Python — CRAM is a compatibility surface here, not the hot path;
see docs/ARCHITECTURE.md).

Both encode and decode are implemented so the codec round-trips under
test without external CRAM files (none can exist in this offline
environment — SURVEY.md §0). [MUST-VERIFY against an htslib-written
CRAM when one becomes available: frequency-table RLE serialization and
the interleave order of the final (n % 4) symbols.]

Stream layout: 1 byte order (0|1), u32le compressed size (bytes after
this 9-byte header), u32le uncompressed size, frequency table(s), then
four u32le initial states and the renormalization byte stream.
Frequencies are normalized to sum 4096 (12-bit).
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT  # 4096
RANS_L = 1 << 23  # lower renormalization bound


# ---------------------------------------------------------------- tables

def _normalize(freq: np.ndarray, total: int = TOTFREQ) -> np.ndarray:
    """Scale counts to sum exactly ``total``, keeping present symbols
    at frequency >= 1 (spec requirement)."""
    n = int(freq.sum())
    if n == 0:
        return freq.astype(np.int64)
    out = (freq.astype(np.float64) * (total / n)).astype(np.int64)
    out[(freq > 0) & (out == 0)] = 1
    big = int(np.argmax(out))
    out[big] += total - int(out.sum())
    if out[big] <= 0:
        raise ValueError("rans: cannot normalize frequency table")
    return out


def _write_freq(out: bytearray, f: int) -> None:
    if f >= 128:
        out.append(0x80 | (f >> 8))
        out.append(f & 0xFF)
    else:
        out.append(f)


def _read_freq(buf: bytes, off: int) -> Tuple[int, int]:
    f = buf[off]
    off += 1
    if f >= 128:
        f = ((f & 0x7F) << 8) | buf[off]
        off += 1
    return f, off


def _write_sym_list(out: bytearray, syms, write_payload) -> None:
    """Ascending symbol list with the spec's run-length shortcut: a
    symbol written immediately after its predecessor is followed by a
    count of further implicit consecutive symbols. ``write_payload(s)``
    emits each symbol's payload (its frequency, or a whole inner table
    for order-1 contexts). Terminated by a 0 where a symbol would go
    (0 itself can only appear as the first, smallest symbol)."""
    rle = 0
    last = -2
    for idx, s in enumerate(syms):
        s = int(s)
        if rle > 0:
            rle -= 1
        else:
            out.append(s)
            if s == last + 1:
                run = 0
                while (idx + run + 1 < len(syms)
                       and int(syms[idx + run + 1]) == s + run + 1):
                    run += 1
                out.append(run)
                rle = run
        last = s
        write_payload(s)
    out.append(0)


def _read_sym_list(buf: bytes, off: int, read_payload) -> int:
    """Inverse of ``_write_sym_list``; ``read_payload(sym, off) -> off``."""
    sym = buf[off]
    off += 1
    rle = 0
    while True:
        off = read_payload(sym, off)
        last = sym
        if rle > 0:
            rle -= 1
            sym = last + 1
        else:
            sym = buf[off]
            off += 1
            if sym == 0:
                return off
            if sym == last + 1:
                rle = buf[off]
                off += 1


def _write_freq_table(out: bytearray, freq: np.ndarray) -> None:
    syms = np.flatnonzero(freq)
    _write_sym_list(out, syms, lambda s: _write_freq(out, int(freq[s])))


def _read_freq_table(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    freq = np.zeros(256, dtype=np.int64)

    def payload(sym, off):
        freq[sym], off = _read_freq(buf, off)
        return off

    off = _read_sym_list(buf, off, payload)
    return freq, off


def _lookup(freq: np.ndarray) -> np.ndarray:
    """12-bit slot → symbol. Pads to 4096 with the last present symbol
    (defensive for tables whose sum drifted below TOTFREQ)."""
    t = np.repeat(np.arange(256, dtype=np.uint8), np.maximum(freq, 0))
    if len(t) < TOTFREQ:
        pad = t[-1] if len(t) else np.uint8(0)
        t = np.concatenate([t, np.full(TOTFREQ - len(t), pad, np.uint8)])
    return t


def _cum(freq: np.ndarray) -> np.ndarray:
    c = np.zeros(257, dtype=np.int64)
    np.cumsum(freq, out=c[1:])
    return c


def _flush_states(rev: bytearray, states) -> None:
    """Append the 4 final states so the REVERSED stream starts with
    state0..state3 as u32le (the decoder's read order)."""
    for j in (3, 2, 1, 0):
        x = states[j]
        rev.extend(((x >> 24) & 0xFF, (x >> 16) & 0xFF,
                    (x >> 8) & 0xFF, x & 0xFF))


# ---------------------------------------------------------------- order-0

def encode_o0(data: bytes) -> bytes:
    src = np.frombuffer(data, dtype=np.uint8)
    n = len(src)
    freq = _normalize(np.bincount(src, minlength=256))
    cum = _cum(freq)
    body = bytearray()
    _write_freq_table(body, freq)

    # encode in reverse decode order (i = n-1..0, state j = i & 3),
    # appending renorm bytes; one global flip restores stream order
    states = [RANS_L] * 4
    rev = bytearray()
    fr = freq.tolist()
    cm = cum.tolist()
    for i in range(n - 1, -1, -1):
        s = int(src[i])
        f, c = fr[s], cm[s]
        x = states[i & 3]
        x_max = ((RANS_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            rev.append(x & 0xFF)
            x >>= 8
        states[i & 3] = ((x // f) << TF_SHIFT) + (x % f) + c
    _flush_states(rev, states)
    comp = bytes(body) + bytes(rev[::-1])
    return struct.pack("<BII", 0, len(comp), n) + comp


def decode_o0(buf: bytes, off: int, end: int, n_out: int) -> bytes:
    freq, off = _read_freq_table(buf, off)
    cum = _cum(freq).tolist()
    fr = freq.tolist()
    sym_of = _lookup(freq)
    states = list(struct.unpack_from("<IIII", buf, off))
    off += 16
    out = np.empty(n_out, dtype=np.uint8)
    for i in range(n_out):
        j = i & 3
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = int(sym_of[slot])
        out[i] = s
        x = fr[s] * (x >> TF_SHIFT) + slot - cum[s]
        while x < RANS_L and off < end:
            x = (x << 8) | buf[off]
            off += 1
        states[j] = x
    return out.tobytes()


# ---------------------------------------------------------------- order-1

def _quarters(n: int):
    q = n >> 2
    starts = [0, q, 2 * q, 3 * q]
    ends = [q, 2 * q, 3 * q, n]
    return starts, ends


def encode_o1(data: bytes) -> bytes:
    src = np.frombuffer(data, dtype=np.uint8)
    n = len(src)
    if n < 4:
        raise ValueError("order-1 needs >= 4 bytes")
    # four states own four consecutive quarters (the last also takes the
    # n % 4 remainder); context = previous byte within the quarter, 0
    # for each quarter's first byte
    starts, ends = _quarters(n)
    ctx = np.zeros(n, dtype=np.uint8)
    for k in range(4):
        ctx[starts[k] + 1 : ends[k]] = src[starts[k] : ends[k] - 1]
    counts = np.zeros((256, 256), dtype=np.int64)
    np.add.at(counts, (ctx.astype(np.int64), src.astype(np.int64)), 1)

    freqs: Dict[int, list] = {}
    cums: Dict[int, list] = {}
    body = bytearray()
    used = np.flatnonzero(counts.sum(axis=1))

    def payload(c):
        f = _normalize(counts[c])
        freqs[c] = f.tolist()
        cums[c] = _cum(f).tolist()
        _write_freq_table(body, f)

    _write_sym_list(body, used, payload)

    # reverse decode order: decode round t does k=0..3 (k participating
    # while t < quarter length), so encode rounds run t = maxlen-1..0
    # with k = 3..0
    states = [RANS_L] * 4
    rev = bytearray()
    lens = [ends[k] - starts[k] for k in range(4)]
    for t in range(max(lens) - 1, -1, -1):
        for k in (3, 2, 1, 0):
            if t >= lens[k]:
                continue
            i = starts[k] + t
            s = int(src[i])
            c = int(ctx[i])
            f, cmv = freqs[c][s], cums[c][s]
            x = states[k]
            x_max = ((RANS_L >> TF_SHIFT) << 8) * f
            while x >= x_max:
                rev.append(x & 0xFF)
                x >>= 8
            states[k] = ((x // f) << TF_SHIFT) + (x % f) + cmv
    _flush_states(rev, states)
    comp = bytes(body) + bytes(rev[::-1])
    return struct.pack("<BII", 1, len(comp), n) + comp


def decode_o1(buf: bytes, off: int, end: int, n_out: int) -> bytes:
    freq: Dict[int, list] = {}
    cum: Dict[int, list] = {}
    sym_of: Dict[int, np.ndarray] = {}

    def payload(c, off):
        f, off = _read_freq_table(buf, off)
        freq[c] = f.tolist()
        cum[c] = _cum(f).tolist()
        sym_of[c] = _lookup(f)
        return off

    off = _read_sym_list(buf, off, payload)
    states = list(struct.unpack_from("<IIII", buf, off))
    off += 16
    out = np.empty(n_out, dtype=np.uint8)
    starts, ends = _quarters(n_out)
    pos = list(starts)
    lctx = [0, 0, 0, 0]
    done = 0
    while done < n_out:
        for k in range(4):
            if pos[k] >= ends[k]:
                continue
            x = states[k]
            slot = x & (TOTFREQ - 1)
            cx = lctx[k]
            s = int(sym_of[cx][slot])
            out[pos[k]] = s
            x = freq[cx][s] * (x >> TF_SHIFT) + slot - cum[cx][s]
            while x < RANS_L and off < end:
                x = (x << 8) | buf[off]
                off += 1
            states[k] = x
            lctx[k] = s
            pos[k] += 1
            done += 1
    return out.tobytes()


# ---------------------------------------------------------------- public

def compress(data: bytes, order: int = 0) -> bytes:
    """CRAM rANS4x8 block payload for ``data``."""
    if len(data) == 0:
        return struct.pack("<BII", 0, 0, 0)
    if order == 1 and len(data) >= 4:
        return encode_o1(data)
    return encode_o0(data)


def uncompress(blob: bytes) -> bytes:
    """Inverse of :func:`compress` (accepts any spec-conforming blob)."""
    order, comp_len, n_out = struct.unpack_from("<BII", blob, 0)
    if n_out == 0:
        return b""
    end = 9 + comp_len
    if order == 0:
        return decode_o0(blob, 9, end, n_out)
    return decode_o1(blob, 9, end, n_out)
