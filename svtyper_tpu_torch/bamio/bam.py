"""BamFile: the fetch/scan front-end over BGZF + BAI.

The parity surface of ``pysam.AlignmentFile`` as used by the reference
(SURVEY.md §1 L0): ``fetch(chrom, start, end)`` (here returning a columnar
:class:`ReadBatch`), sequential head-scan for library bootstrap
(``Sample.from_bam``, SURVEY.md §3.4), and ``idxstats``-style mapped/
unmapped counts. Chooses the C++ core when built, else the pure-Python
decoder.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.bamio.bai import BaiIndex
from svtyper_tpu_torch.bamio.bgzf import BgzfReader, VirtualStream
from svtyper_tpu_torch.bamio.columns import ReadBatch, _ragged_gather_indices
from svtyper_tpu_torch.bamio.records import decode_stream


class BamHeader:
    def __init__(self, text: str, refs: List[Tuple[str, int]]) -> None:
        self.text = text
        self.refs = refs
        self.ref_names = [n for n, _ in refs]
        self.ref_lengths = {n: l for n, l in refs}
        self.name_to_tid = {n: i for i, n in enumerate(self.ref_names)}
        # @RG lines → id, sample (SM), library (LB)
        self.read_groups: List[Dict[str, str]] = []
        for line in text.splitlines():
            if line.startswith("@RG"):
                rg = dict(
                    f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                )
                self.read_groups.append(rg)

    @property
    def sample_name(self) -> Optional[str]:
        for rg in self.read_groups:
            if "SM" in rg:
                return rg["SM"]
        return None


class FineIndex:
    """Fine-grained linear index (see bamcore.cpp::svt_build_fineidx).

    ``vo[slot_off[tid] + (pos >> g_shift)]`` is a tight, safe lower-bound
    voffset for records overlapping positions ≥ pos: after a global
    backward fill, each slot holds the voffset of the first record
    overlapping that or any later interval (monotone in file order).
    Sidecar-cached as ``<bam>.fidx.npz`` — an index artifact exactly
    like the ``.bai``.
    """

    __slots__ = ("g_shift", "slot_off", "vo")

    def __init__(self, g_shift: int, slot_off: np.ndarray, vo: np.ndarray):
        self.g_shift = g_shift
        self.slot_off = slot_off
        self.vo = vo


class BamFile:
    def __init__(self, path: str, use_native: Optional[bool] = None,
                 threads: Optional[int] = None) -> None:
        self.path = path
        # native C++ decoder unless disabled (env SVT_NO_NATIVE=1) or
        # unavailable; falls back to the pure-Python decoder either way
        if use_native is None:
            use_native = os.environ.get("SVT_NO_NATIVE") != "1"
        self._use_native = use_native
        self._native = None
        self._native_failed = False
        # decode-thread fan-out: explicit arg (CLI --cores) > env > auto.
        # Auto scales with the host (floor 2 so the common 2-vCPU case
        # keeps both cores busy, cap 8 — the chunk arena is one fetch
        # in flight, so threads only parallelize within a fetch)
        ncpu = os.cpu_count() or 1
        self._threads = (
            threads
            or int(os.environ.get("SVT_THREADS", "0"))
            or max(2 if ncpu >= 2 else 1, min(8, ncpu - 1))
        )
        self._reader = BgzfReader(path)
        vs = VirtualStream(self._reader)
        magic = vs.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file: %s" % path)
        (l_text,) = struct.unpack("<i", vs.read(4))
        text = vs.read(l_text).split(b"\x00", 1)[0].decode()
        (n_ref,) = struct.unpack("<i", vs.read(4))
        refs: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", vs.read(4))
            name = vs.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", vs.read(4))
            refs.append((name, l_ref))
        self.header = BamHeader(text, refs)
        self._body_voffset = vs.voffset
        # RG id → dense index (ReadBatch.lib_id holds this at decode time;
        # svtyper_tpu.stats remaps it to a library index per Sample)
        self.rg_index: Dict[bytes, int] = {
            rg.get("ID", "").encode(): i
            for i, rg in enumerate(self.header.read_groups)
        }
        self._bai: Optional[BaiIndex] = None
        self._fineidx = None
        self._fineidx_failed = False

    # -- native backend -----------------------------------------------------
    def _get_native(self):
        if self._native is not None or self._native_failed or not self._use_native:
            return self._native
        try:
            from svtyper_tpu_torch.bamio.native import NativeBam, get_lib

            if get_lib() is None:
                self._native_failed = True
                return None
            rg_names = [rg.get("ID", "") for rg in self.header.read_groups]
            self._native = NativeBam(self.path, self.header.ref_names, rg_names)
        except Exception:
            self._native_failed = True
            self._native = None
        return self._native

    def _get_fineidx(self) -> Optional[FineIndex]:
        """Load-or-build the fine linear index (native core required).

        Built once per BAM with one sequential header-only pass, then
        cached as ``<bam>.fidx.npz`` keyed on the BAM's (size, mtime);
        disable with SVT_NO_FINEIDX=1. Falls back to None (BAI-only
        fetch) on any failure — purely an optimization, never required
        for correctness.
        """
        if self._fineidx is not None:
            return self._fineidx
        if self._fineidx_failed or os.environ.get("SVT_NO_FINEIDX") == "1":
            return None
        native = self._get_native()
        if native is None:
            self._fineidx_failed = True
            return None
        try:
            st = os.stat(self.path)
            sig = np.asarray([st.st_size, int(st.st_mtime)], dtype=np.int64)
            sidecar = self.path + ".fidx.npz"
            if os.path.exists(sidecar):
                with np.load(sidecar) as z:
                    if np.array_equal(z["sig"], sig):
                        self._fineidx = FineIndex(
                            int(z["g_shift"]), z["slot_off"], z["vo"]
                        )
                        return self._fineidx
            env_shift = os.environ.get("SVT_FINEIDX_SHIFT")
            if env_shift is not None:
                g_shift = int(env_shift)
            else:
                # adaptive granularity: finest shift ≥ 7 (128bp) whose
                # table stays ≤ 8M slots (64MB sidecar) — small genomes
                # get near-exact seeks, human-scale gets 512bp
                total_bp = sum(l for _, l in self.header.refs)
                g_shift = 7
                while g_shift < 16 and (total_bp >> g_shift) > (8 << 20):
                    g_shift += 1
            slot_off, vo = native.build_fineidx(
                self._body_voffset, g_shift,
                [l for _, l in self.header.refs],
            )
            # global backward fill: empty slots take the next set slot's
            # voffset (set slots are monotone non-decreasing in file
            # order, so a reversed cummin fills gaps without disturbing
            # set values; cross-tid leakage is safe — the decode loop
            # breaks on the first tid-mismatched record)
            vo = np.minimum.accumulate(vo[::-1])[::-1].copy()
            self._fineidx = FineIndex(g_shift, slot_off, vo)
            try:
                np.savez(
                    sidecar, sig=sig, g_shift=np.int64(g_shift),
                    slot_off=slot_off, vo=vo,
                )
            except OSError:
                pass  # read-only dir: keep the in-memory index
        except Exception:
            self._fineidx_failed = True
            return None
        return self._fineidx

    # -- index ------------------------------------------------------------
    @property
    def bai(self) -> BaiIndex:
        """The region index: ``.bai``, falling back to ``.csi`` (the
        long-contig format htslib emits past 2^29 bp — same query
        surface, see bamio/csi.py)."""
        if self._bai is None:
            for cand in (self.path + ".bai", re.sub(r"\.bam$", ".bai", self.path)):
                if os.path.exists(cand):
                    self._bai = BaiIndex.load(cand)
                    break
            else:
                from svtyper_tpu_torch.bamio.csi import CsiIndex

                for cand in (
                    self.path + ".csi",
                    re.sub(r"\.bam$", ".csi", self.path),
                ):
                    if os.path.exists(cand):
                        self._bai = CsiIndex.load(cand)
                        break
                else:
                    raise FileNotFoundError(
                        "no .bai/.csi index for %s" % self.path
                    )
        return self._bai

    def idxstats(self) -> List[Tuple[str, int, int, int]]:
        return [
            (name, length, m, u)
            for (name, length), (m, u) in zip(self.header.refs, self.bai.idxstats())
        ]

    def mapped_unmapped(self) -> Tuple[int, int]:
        stats = self.bai.idxstats()
        return (
            sum(m for m, _ in stats),
            sum(u for _, u in stats) + self.bai.n_no_coor,
        )

    # -- fetch ---------------------------------------------------------------
    def fetch(self, chrom: str, start: int, end: int) -> ReadBatch:
        """All mapped reads overlapping [start, end) on chrom, decoded to
        columns. 0-based half-open, like pysam."""
        tid = self.header.name_to_tid.get(chrom)
        if tid is None:
            return ReadBatch(0)
        start = max(0, start)
        end = min(end, self.header.refs[tid][1])
        if end <= start:
            return ReadBatch(0)
        native = self._get_native()
        batches = []
        for cb, ce in self.bai.query(tid, start, end):
            if native is not None:
                batch, _ = native.decode(
                    cb, stop_voffset=ce, region=(tid, start, end),
                    cap_hint=1024,
                )
            else:
                vs = VirtualStream(self._reader, cb)
                batch, _ = decode_stream(
                    vs,
                    self.header.ref_names,
                    self.rg_index,
                    stop_voffset=ce,
                    region=(tid, start, end),
                )
            batches.append(batch)
        return ReadBatch.concat(batches)

    def head(self, max_records: int, keep_unmapped: bool = True) -> ReadBatch:
        """First ``max_records`` records in file order (library bootstrap)."""
        native = self._get_native()
        if native is not None:
            batch, _ = native.decode(
                self._body_voffset,
                max_records=max_records,
                keep_unmapped=keep_unmapped,
                cap_hint=max(min(max_records, 1 << 18), 256),
            )
            return batch
        vs = VirtualStream(self._reader, self._body_voffset)
        batch, _ = decode_stream(
            vs,
            self.header.ref_names,
            self.rg_index,
            max_records=max_records,
            keep_unmapped=keep_unmapped,
        )
        return batch

    def _clamp_regions(self, regions: List[Tuple[str, int, int]]):
        """Shared region validation: name→tid, clamp to [0, ref_len),
        validity mask (used by both range-prep paths so they cannot
        drift)."""
        nq = len(regions)
        tids = np.fromiter(
            (self.header.name_to_tid.get(c, -1) for c, _, _ in regions),
            dtype=np.int64, count=nq,
        )
        los = np.maximum(
            np.fromiter((s for _, s, _ in regions), dtype=np.int64, count=nq),
            0,
        )
        ref_len = np.asarray(
            [l for _, l in self.header.refs] + [0], dtype=np.int64
        )
        his = np.minimum(
            np.fromiter((e for _, _, e in regions), dtype=np.int64, count=nq),
            ref_len[tids],
        )
        valid = (tids >= 0) & (his > los)
        return tids, los, his, valid

    def _prep_ranges_fine(self, regions: List[Tuple[str, int, int]]):
        """Fine-index-only voffset ranges for ``fetch_chunk``.

        The chunk decode loop early-breaks on ``tid != rtid or pos >=
        rhi`` (coordinate-sorted file), so a region needs only a START
        lower bound — which the fine index supplies directly (and
        tighter than a BAI linear-index slot). The full BAI bin query
        (`_prep_ranges`) added nothing on this path: its chunk starts
        were clamped UP to the same fine lower bound, and its stop
        voffsets are redundant under the coordinate break. Skipping it
        removes the per-chunk bin expansion + interval merge from the
        prep thread (~20% of host prep). One range per kept region;
        ``range_end = UINT64_MAX``. Returns None when the fine index is
        unavailable (caller falls back to `_prep_ranges`) or no region
        has records.
        """
        if os.environ.get("SVT_NO_FINERANGE") == "1":
            return None
        fi = self._get_fineidx()
        if fi is None:
            return None
        tids, los, his, valid = self._clamp_regions(regions)
        n_slots = np.diff(fi.slot_off)
        safe_tid = np.where(valid, tids, 0)
        slot = fi.slot_off[safe_tid] + np.minimum(
            los >> fi.g_shift, np.maximum(n_slots[safe_tid] - 1, 0)
        )
        rb = fi.vo[slot]
        # UINT64_MAX = no record at/after this slot anywhere in the file
        valid &= rb != np.uint64(0xFFFFFFFFFFFFFFFF)
        keep = np.flatnonzero(valid)
        if not len(keep):
            return None
        remap = keep.astype(np.int32)
        ro = np.arange(len(keep) + 1, dtype=np.int64)
        rn = np.full(len(keep), 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
        return (
            keep, remap, tids[keep], los[keep], his[keep], ro,
            np.ascontiguousarray(rb[keep]), rn,
        )

    def _prep_ranges(self, regions: List[Tuple[str, int, int]]):
        """Region list → clamped, BAI-resolved, fine-index-tightened
        voffset ranges for the native decode loops.

        Returns None when no region has any index chunk, else
        ``(keep, remap, rt, rs, re_, ro, rb, rn)`` where ``keep``/
        ``remap`` map kept queries back to input region indices.
        """
        tids, los, his, valid = self._clamp_regions(regions)
        row_off, rb_all, rn_all = self.bai.query_many(
            np.where(valid, tids, -1), los, np.maximum(his, los + 1)
        )
        counts = np.diff(row_off)
        keep = np.flatnonzero(valid & (counts > 0))
        if not len(keep):
            return None
        remap = keep.astype(np.int32)
        rt, rs, re_ = tids[keep], los[keep], his[keep]
        cnt = counts[keep]
        sel = _ragged_gather_indices(row_off, keep)
        rb, rn = rb_all[sel], rn_all[sel]
        fi = self._get_fineidx()
        if fi is not None and len(rb):
            # clamp each BAI chunk's start voffset up to the fine
            # index's per-window lower bound: skips the (up to 16kb
            # of) records between the BAI linear-index slot and the
            # window's first overlapping record
            w = rs >> fi.g_shift
            lower = fi.vo[fi.slot_off[rt] + w]
            rb = np.maximum(rb, np.repeat(lower, cnt))
            live = rb < rn
            if not live.all():
                q_of_range = np.repeat(
                    np.arange(len(keep), dtype=np.int64), cnt
                )[live]
                rb, rn = rb[live], rn[live]
                cnt = np.bincount(q_of_range, minlength=len(keep))
                qlive = cnt > 0
                if not qlive.all():
                    keep = keep[qlive]
                    remap = remap[qlive]
                    rt, rs, re_ = rt[qlive], rs[qlive], re_[qlive]
                    cnt = cnt[qlive]
                if not len(keep):
                    return None
        ro = np.zeros(len(keep) + 1, dtype=np.int64)
        np.cumsum(cnt, out=ro[1:])
        return keep, remap, rt, rs, re_, ro, rb, rn

    def fetch_many(
        self, regions: List[Tuple[str, int, int]], filt=None,
        transient: bool = False,
    ) -> Tuple[ReadBatch, "np.ndarray"]:
        """Batched fetch of many regions in one native call.

        Returns (batch, region_id per row); rows arrive grouped by
        region in input order, each region's rows in coordinate order —
        identical to concatenating single ``fetch`` results.

        ``filt`` (a :class:`svtyper_tpu.bamio.native.FetchFilter`) pushes
        flag/read-group filtering and the aligned-coverage predicate into
        the decode loop; the pure-Python path applies the identical
        filters post-hoc so outputs match the native core byte-for-byte.
        """
        native = self._get_native()
        if native is not None:
            pre = self._prep_ranges(regions)
            if pre is None:
                return ReadBatch(0), np.zeros(0, dtype=np.int32)
            keep, remap, rt, rs, re_, ro, rb, rn = pre
            nfilt = filt.slice_take(remap) if filt is not None else None
            batch, qid = native.fetch_many(
                rt, rs, re_, ro, rb, rn, threads=self._threads, filt=nfilt,
                transient=transient,
            )
            return batch, remap[qid]
        nq = len(regions)
        tids = np.fromiter(
            (self.header.name_to_tid.get(c, -1) for c, _, _ in regions),
            dtype=np.int64, count=nq,
        )
        los = np.maximum(
            np.fromiter((s for _, s, _ in regions), dtype=np.int64, count=nq),
            0,
        )
        ref_len = np.asarray(
            [l for _, l in self.header.refs] + [0], dtype=np.int64
        )
        his = np.minimum(
            np.fromiter((e for _, _, e in regions), dtype=np.int64, count=nq),
            ref_len[tids],
        )
        valid = (tids >= 0) & (his > los)
        row_off, _rb, _rn = self.bai.query_many(
            np.where(valid, tids, -1), los, np.maximum(his, los + 1)
        )
        counts = np.diff(row_off)
        keep = np.flatnonzero(valid & (counts > 0))
        if not len(keep):
            return ReadBatch(0), np.zeros(0, dtype=np.int32)
        # python fallback: sequential fetches + post-hoc filter
        batches, ids = [], []
        for qi in keep.tolist():
            b = self.fetch(
                self.header.ref_names[int(tids[qi])],
                int(los[qi]), int(his[qi]),
            )
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

    def fetch_chunk(
        self,
        regions: List[Tuple[str, int, int]],
        var_of: "np.ndarray",
        n_var: int,
        filt,
        max_reads: Optional[int] = None,
        vpred: Optional[Tuple["np.ndarray", "np.ndarray"]] = None,
    ):
        """Decode + full device-chunk layout in one native call (see
        bamcore.cpp::svt_fetch_chunk). ``var_of[i]`` is region *i*'s
        variant slot (must be non-decreasing — regions grouped per
        variant). Returns ``(n_cand, n_pair, var_over, var_rows,
        export)`` where ``export(r_i32, r_u8, p_i32, p_i16, p_u8)``
        copies the tables into caller-allocated padded matrices, or
        None when the native core is unavailable (caller falls back to
        the numpy layout).

        With ``vpred = (v_i32, v_u8)`` the decode threads also compute
        the compact-wire predicate flags; ``export`` is then
        ``export(cr_u16, cr_u8, cp_u16, cp_i32, cp_u8)``
        (native.chunk_export_compact).
        """
        native = self._get_native()
        if native is None or not hasattr(native._lib, "svt_fetch_chunk"):
            return None
        if vpred is not None and not hasattr(
            native._lib, "svt_chunk_export_compact"
        ):
            return None
        pre = self._prep_ranges_fine(regions)
        if pre is None:
            pre = self._prep_ranges(regions)
        if pre is None:
            empty = np.zeros(n_var, dtype=np.uint8)
            rows = np.zeros(n_var, dtype=np.int64)

            def export_empty(*mats):
                return None

            # the native arena was NOT touched: chunk_evidence() must
            # report THIS chunk's (empty) rows, not the previous chunk's
            self._evidence_empty = True
            return 0, 0, empty, rows, export_empty
        keep, remap, rt, rs, re_, ro, rb, rn = pre
        nfilt = filt.slice_take(remap) if filt is not None else None
        vq = np.ascontiguousarray(
            np.asarray(var_of, dtype=np.int32)[remap]
        )
        n_cand, n_pair, var_over, var_rows = native.fetch_chunk(
            rt, rs, re_, ro, rb, rn, vq, n_var, nfilt,
            max_reads=max_reads, threads=self._threads, vpred=vpred,
        )
        self._evidence_empty = False
        export = (
            native.chunk_export_compact if vpred is not None
            else native.chunk_export
        )
        return n_cand, n_pair, var_over, var_rows, export

    def set_evidence_export(self, on: bool) -> bool:
        """Toggle -w evidence-row recording in the native chunk fetch
        (cli/write_alignment.py); returns False when unsupported (pure
        Python, stale .so) so callers fall back to a batched re-fetch."""
        native = self._get_native()
        if native is None or not hasattr(
            native._lib, "svt_chunk_export_evidence"
        ):
            return False
        native.set_evidence(bool(on))
        return True

    def chunk_evidence(self):
        if getattr(self, "_evidence_empty", False):
            z32 = np.zeros(0, np.int32)
            return z32, z32.copy(), z32.copy(), z32.copy(), np.zeros(0, np.uint64)
        native = self._get_native()
        return native.chunk_evidence() if native is not None else None

    def scan(
        self,
        voffset: Optional[int] = None,
        max_records: Optional[int] = None,
        keep_unmapped: bool = True,
    ) -> Tuple[ReadBatch, int, Optional[int]]:
        """Sequential chunk scan: (batch, records_seen, next_voffset|None).

        Start at ``voffset`` (default: first record). Used by the
        library-stats bootstrap (SURVEY.md §3.4).
        """
        if voffset is None:
            voffset = self._body_voffset
        native = self._get_native()
        if native is not None:
            return native.decode_resumable(
                voffset,
                max_records=max_records,
                keep_unmapped=keep_unmapped,
                cap_hint=max(min(max_records or 4096, 1 << 18), 256),
            )
        vs = VirtualStream(self._reader, voffset)
        batch, seen = decode_stream(
            vs,
            self.header.ref_names,
            self.rg_index,
            max_records=max_records,
            keep_unmapped=keep_unmapped,
        )
        nxt = vs.voffset if vs.normalize() else None
        return batch, seen, nxt

    def raw_records(self, voffsets: List[int]) -> List[bytes]:
        """Raw record bytes at the given virtual offsets (for ``-w``).

        Block-sliced bulk path: offsets are visited in sorted order so
        each BGZF block inflates once (LRU-cached) and in-block records
        are plain byte slices; only block-spanning records fall back to
        a VirtualStream. ~4× the per-record VirtualStream loop on the
        bench fixture's 630k-record evidence dump.
        """
        out: List[bytes] = [b""] * len(voffsets)
        cur_co = -1
        data = b""
        for idx in sorted(range(len(voffsets)), key=voffsets.__getitem__):
            vo = int(voffsets[idx])
            co, uo = vo >> 16, vo & 0xFFFF
            if co != cur_co:
                data, _ = self._reader.block_at(co)
                cur_co = co
            if uo + 4 <= len(data):
                size = int.from_bytes(data[uo : uo + 4], "little")
                if uo + 4 + size <= len(data):
                    out[idx] = data[uo + 4 : uo + 4 + size]
                    continue
            vs = VirtualStream(self._reader, vo)
            (size,) = struct.unpack("<i", vs.read(4))
            out[idx] = vs.read(size)
        return out


def _apply_filter_py(batch: ReadBatch, rid: np.ndarray, filt):
    """Python twin of the bamcore in-loop FetchFilter (flag drop, RG
    keep/remap, §4.1 coverage) — applied post-hoc on the fallback path so
    both paths return identical batches."""
    from svtyper_tpu_torch.bamio.columns import coverage_from_blocks

    keep = np.ones(batch.n, dtype=bool)
    if filt.drop_flags:
        keep &= (batch.flag & filt.drop_flags) == 0
    lib = batch.lib_id
    if filt.rg_keep is not None or filt.rg_to_lib is not None:
        tab = filt.rg_to_lib if filt.rg_to_lib is not None else filt.rg_keep
        n_tab = len(tab) - 1
        slot = np.where((lib >= 0) & (lib < n_tab), lib, n_tab)
        if filt.rg_keep is not None:
            keep &= filt.rg_keep[slot].astype(bool)
        if filt.rg_to_lib is not None:
            lib = filt.rg_to_lib[slot]
    idx = np.flatnonzero(keep)
    out = batch.take(idx)
    rid = rid[idx]
    out.lib_id = lib[idx].astype(np.int32)
    if filt.cov_pos_a is not None and out.n:
        out.cov_a = coverage_from_blocks(
            out, filt.cov_pos_a[rid], filt.cov_tid_a[rid], filt.min_aligned
        )
        out.cov_b = coverage_from_blocks(
            out, filt.cov_pos_b[rid], filt.cov_tid_b[rid], filt.min_aligned
        )
    return out, rid


def open_bam(path: str, threads: Optional[int] = None,
             ref_fasta: Optional[str] = None):
    """Open an alignment file by magic: BAM (BGZF) or CRAM. CRAM needs
    no reference FASTA for GENOTYPING (the evidence model never reads
    bases — bamio/cram.py); providing ``-T`` additionally enables full
    SEQ/QUAL reconstruction in ``-w`` evidence output."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"CRAM":
        from svtyper_tpu_torch.bamio.cram import CramFile

        return CramFile(path, threads=threads, ref_fasta=ref_fasta)
    return BamFile(path, threads=threads)
