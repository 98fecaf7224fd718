"""Reference FASTA access (.fai-indexed) for reference-based CRAM.

The reference's CRAM path gets this from htslib's ``faidx``; here a
minimal native equivalent backs SEQ reconstruction in ``bamio/cram.py``
(substitution features are deltas against the reference, SAM spec
CRAM 3.0 §8.4 / §10.5). The evidence model itself never reads bases,
so this loads lazily and only when a FASTA is actually supplied
(``-T``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


class FastaFile:
    """mmap-backed FASTA with samtools-compatible ``.fai`` (built and
    cached on first use when absent)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fh = open(path, "rb")
        import mmap

        self._map = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        fai = path + ".fai"
        if os.path.exists(fai):
            self._idx = self._parse_fai(fai)
        else:
            self._idx = self._build_index()
            # pid-suffixed temp: concurrent first-open of a shared
            # reference must not interleave writes into one tmp file
            # (review, r5)
            tmp = "%s.tmp.%d" % (fai, os.getpid())
            try:
                with open(tmp, "w") as fh:
                    for name, (ln, off, bpl, cpl) in self._idx.items():
                        fh.write("%s\t%d\t%d\t%d\t%d\n"
                                 % (name, ln, off, bpl, cpl))
                os.replace(tmp, fai)
            except OSError:
                pass  # read-only dir: index stays in-memory only

    @staticmethod
    def _parse_fai(path: str) -> Dict[str, Tuple[int, int, int, int]]:
        idx: Dict[str, Tuple[int, int, int, int]] = {}
        with open(path) as fh:
            for line in fh:
                cols = line.rstrip("\n").split("\t")
                if len(cols) >= 5:
                    idx[cols[0]] = (int(cols[1]), int(cols[2]),
                                    int(cols[3]), int(cols[4]))
        return idx

    def _build_index(self) -> Dict[str, Tuple[int, int, int, int]]:
        idx: Dict[str, Tuple[int, int, int, int]] = {}
        m = self._map
        pos = 0
        n = len(m)
        while pos < n:
            if m[pos : pos + 1] != b">":
                raise ValueError("malformed FASTA at offset %d" % pos)
            eol = m.find(b"\n", pos)
            if eol < 0:
                raise ValueError("truncated FASTA header")
            name = m[pos + 1 : eol].split()[0].decode()
            seq_off = eol + 1
            # first sequence line fixes the layout
            line_end = m.find(b"\n", seq_off)
            if line_end < 0:
                line_end = n
            bpl = line_end - seq_off
            has_cr = bpl and m[line_end - 1 : line_end] == b"\r"
            if has_cr:
                bpl -= 1
            cpl = line_end - seq_off + 1
            total = 0
            pos2 = seq_off
            last_ll = None
            while pos2 < n and m[pos2 : pos2 + 1] != b">":
                le = m.find(b"\n", pos2)
                if le < 0:
                    le = n
                ll = le - pos2
                if ll and m[le - 1 : le] == b"\r":
                    ll -= 1
                # fetch() computes offsets assuming uniform wrapping —
                # a mid-record line longer/shorter than the first would
                # silently return wrong bases (samtools faidx rejects
                # such files too; review, r5). Only the LAST line of a
                # record may be short.
                if last_ll is not None and last_ll != bpl:
                    raise ValueError(
                        "FASTA %r: record %r has non-uniform line "
                        "lengths (%d then %d); re-wrap it (e.g. "
                        "seqkit seq -w) before indexing"
                        % (self.path, name, bpl, last_ll)
                    )
                if ll > bpl:
                    raise ValueError(
                        "FASTA %r: record %r has non-uniform line "
                        "lengths (%d then %d); re-wrap it before "
                        "indexing" % (self.path, name, bpl, ll)
                    )
                last_ll = ll
                total += ll
                pos2 = le + 1
            idx[name] = (total, seq_off, bpl if bpl else total, cpl)
            pos = pos2
        return idx

    def references(self) -> List[str]:
        return list(self._idx)

    def __contains__(self, chrom: str) -> bool:
        return chrom in self._idx

    def length(self, chrom: str) -> int:
        return self._idx[chrom][0]

    def fetch(self, chrom: str, start: int, end: int) -> bytes:
        """Uppercase reference bases for [start, end) (0-based,
        clamped); positions past the contig end fill with 'N' so CRAM
        reads running off the reference still reconstruct (spec
        behavior for beyond-end bases)."""
        ln, off, bpl, cpl = self._idx[chrom]
        start = max(0, start)
        want = end - start
        end_c = min(end, ln)
        out = bytearray()
        p = start
        while p < end_c:
            line, col = divmod(p, bpl)
            take = min(bpl - col, end_c - p)
            fo = off + line * cpl + col
            out += self._map[fo : fo + take]
            p += take
        if len(out) < want:
            out += b"N" * (want - len(out))
        return bytes(out).upper()

    def close(self) -> None:
        try:
            self._map.close()
        finally:
            self._fh.close()
