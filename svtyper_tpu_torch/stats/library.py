"""Library insert-size models and per-BAM Sample bootstrap.

Reconstruction of ``svtyper/parsers.py::Sample/Library`` (SURVEY.md §2.2,
§3.4; SPEC.md §7). The insert-size scan runs on columnar batches
(numpy bincount per library) rather than the reference's per-read loop.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.bamio.bam import BamFile
from svtyper_tpu_torch.bamio.columns import (
    FDUP,
    FMUNMAP,
    FPAIRED,
    FQCFAIL,
    FSECONDARY,
    FSUPPLEMENTARY,
    FUNMAP,
    ReadBatch,
)
from svtyper_tpu_torch.statistics import median, upper_mad

TRIM_MADS = 10.0  # histogram tail cut: > median + 10 * upper_mad [RECON §7]


class Library:
    """Insert-size model of one sequencing library (RG ``LB`` group)."""

    def __init__(
        self,
        name: str,
        readgroups: List[str],
        histogram: Dict[int, int],
        read_length: int,
        prevalence: float,
        mean: Optional[float] = None,
        sd: Optional[float] = None,
    ) -> None:
        self.name = name
        self.readgroups = list(readgroups)
        self.hist = dict(histogram)
        self.read_length = int(read_length)
        self.prevalence = float(prevalence)
        if mean is None or sd is None:
            mean, sd = _hist_moments(self.hist)
        self.mean = float(mean)
        self.sd = float(sd)
        total = sum(self.hist.values())
        self.dens: Dict[int, float] = (
            {k: v / total for k, v in self.hist.items()} if total else {}
        )
        # dense density vector for the device path: dens_vec[i] = P(insert=i)
        self.max_insert = max(self.hist) if self.hist else 0
        self.dens_vec = np.zeros(self.max_insert + 1, dtype=np.float64)
        for k, v in self.dens.items():
            self.dens_vec[k] = v

    @classmethod
    def from_inserts(
        cls,
        name: str,
        readgroups: List[str],
        inserts: np.ndarray,
        read_length: int,
        prevalence: float,
    ) -> "Library":
        """Build from raw |tlen| samples with outlier tail trimming."""
        hist: Dict[int, int] = {}
        if len(inserts):
            vals = np.sort(inserts.astype(np.int64))
            med = median(vals.tolist())
            umad = upper_mad(vals.tolist())
            cut = med + TRIM_MADS * umad
            vals = vals[vals <= cut]
            uniq, counts = np.unique(vals, return_counts=True)
            hist = {int(k): int(c) for k, c in zip(uniq, counts)}
        return cls(name, readgroups, hist, read_length, prevalence)

    def to_json_obj(self) -> Dict:
        return {
            "library_name": self.name,
            "readgroups": self.readgroups,
            "read_length": self.read_length,
            "mean": self.mean,
            "sd": self.sd,
            "prevalence": self.prevalence,
            "histogram": {str(k): v for k, v in sorted(self.hist.items())},
        }

    @classmethod
    def from_json_obj(cls, obj: Dict) -> "Library":
        return cls(
            obj["library_name"],
            obj["readgroups"],
            {int(k): int(v) for k, v in obj["histogram"].items()},
            obj["read_length"],
            obj["prevalence"],
            mean=obj.get("mean"),
            sd=obj.get("sd"),
        )


def _hist_moments(hist: Dict[int, int]) -> Tuple[float, float]:
    if not hist:
        return 0.0, 0.0
    ks = np.fromiter(hist.keys(), dtype=np.float64)
    cs = np.fromiter(hist.values(), dtype=np.float64)
    total = cs.sum()
    m = float((ks * cs).sum() / total)
    var = float((cs * (ks - m) ** 2).sum() / total)
    return m, var**0.5


# filter for "counted" bootstrap reads (SPEC.md §7 [RECON])
_SKIP_FLAGS = FUNMAP | FMUNMAP | FSECONDARY | FSUPPLEMENTARY | FDUP | FQCFAIL


def _counted_mask(batch: ReadBatch) -> np.ndarray:
    return (
        ((batch.flag & _SKIP_FLAGS) == 0)
        & ((batch.flag & FPAIRED) != 0)
        & (batch.tid == batch.mate_tid)
        & (batch.tlen > 0)
    )


class Sample:
    """One BAM's sample: library registry + fetch-window model.

    Parity of ``parsers.py::Sample`` (SURVEY.md §2.2): built either by
    scanning the BAM head (``from_bam``) or from the ``-l`` JSON cache
    (``from_lib_info``).
    """

    def __init__(
        self,
        name: str,
        bam: BamFile,
        libraries: List[Library],
        mapped: int,
        unmapped: int,
        min_lib_prevalence: float = 1e-3,
    ) -> None:
        self.name = name
        self.bam = bam
        self.lib_dict: Dict[str, Library] = {l.name: l for l in libraries}
        self.libraries = libraries
        self.mapped = mapped
        self.unmapped = unmapped
        self.min_lib_prevalence = min_lib_prevalence
        self.active_libs = [
            l.name for l in libraries if l.prevalence >= min_lib_prevalence
        ]
        # rg name → library
        self.rg_to_lib: Dict[str, Library] = {}
        for lib in libraries:
            for rg in lib.readgroups:
                self.rg_to_lib[rg] = lib
        # dense decode-time RG index → library index (ReadBatch.lib_id remap)
        lib_index = {l.name: i for i, l in enumerate(libraries)}
        rgs = bam.header.read_groups
        self._rg_idx_to_lib = np.full(max(len(rgs), 1), -1, dtype=np.int32)
        for i, rg in enumerate(rgs):
            lib = self.rg_to_lib.get(rg.get("ID", ""))
            if lib is not None:
                self._rg_idx_to_lib[i] = lib_index[lib.name]
        self._active_lib_idx = np.array(
            [lib_index[n] for n in self.active_libs], dtype=np.int32
        )

    # -- construction -------------------------------------------------------
    @classmethod
    def from_bam(
        cls,
        bam: BamFile,
        num_samp: int = 1_000_000,
        min_lib_prevalence: float = 1e-3,
    ) -> "Sample":
        name = bam.header.sample_name or "unknown"
        rgs = bam.header.read_groups
        rg_ids = [rg.get("ID", "") for rg in rgs]
        # RG LB → member RG ids; reads without RG fall into a default lib
        lb_of_rg = {rg.get("ID", ""): rg.get("LB", name) for rg in rgs}
        lib_names: List[str] = []
        lib_rgs: Dict[str, List[str]] = {}
        for rg_id in rg_ids:
            lb = lb_of_rg[rg_id]
            if lb not in lib_rgs:
                lib_names.append(lb)
                lib_rgs[lb] = []
            lib_rgs[lb].append(rg_id)
        if not lib_names:
            lib_names = [name]
            lib_rgs[name] = []

        # chunked head scan until num_samp counted reads
        counted = 0
        per_lib_inserts: Dict[str, List[np.ndarray]] = {n: [] for n in lib_names}
        per_lib_rlen: Dict[str, int] = {n: 0 for n in lib_names}
        per_lib_count: Dict[str, int] = {n: 0 for n in lib_names}
        chunk = 262_144
        voffset = None
        while counted < num_samp:
            batch, seen, voffset = bam.scan(
                voffset, max_records=chunk, keep_unmapped=True
            )
            if seen == 0:
                break
            mask = _counted_mask(batch)
            take = int(mask.sum())
            if counted + take > num_samp:
                # trim overshoot deterministically: keep first quota rows
                keep = np.flatnonzero(mask)[: num_samp - counted]
                mask = np.zeros(batch.n, dtype=bool)
                mask[keep] = True
                take = len(keep)
            counted += take
            lib_idx_of_rg = np.array(
                [lib_names.index(lb_of_rg.get(r, name)) for r in rg_ids]
                or [0],
                dtype=np.int32,
            )
            rg_col = batch.lib_id[mask]
            libcol = np.where(
                rg_col >= 0, lib_idx_of_rg[np.maximum(rg_col, 0)], 0
            )
            tl = batch.tlen[mask]
            ql = batch.query_len[mask]
            for li, lname in enumerate(lib_names):
                sel = libcol == li
                if sel.any():
                    per_lib_inserts[lname].append(tl[sel])
                    per_lib_rlen[lname] = max(
                        per_lib_rlen[lname], int(ql[sel].max())
                    )
                    per_lib_count[lname] += int(sel.sum())
            if seen < chunk or voffset is None:
                break

        total = max(counted, 1)
        libs = [
            Library.from_inserts(
                lname,
                lib_rgs[lname],
                np.concatenate(per_lib_inserts[lname])
                if per_lib_inserts[lname]
                else np.zeros(0, dtype=np.int64),
                per_lib_rlen[lname],
                per_lib_count[lname] / total,
            )
            for lname in lib_names
        ]
        mapped, unmapped = bam.mapped_unmapped()
        return cls(name, bam, libs, mapped, unmapped, min_lib_prevalence)

    @classmethod
    def from_lib_info(
        cls,
        bam: BamFile,
        lib_info: Dict,
        min_lib_prevalence: float = 1e-3,
    ) -> "Sample":
        name = bam.header.sample_name or "unknown"
        if name not in lib_info:
            raise KeyError("sample %r not in lib_info JSON" % name)
        obj = lib_info[name]
        libs = [Library.from_json_obj(lo) for lo in obj["libraryArray"]]
        return cls(
            name, bam, libs, obj["mapped"], obj["unmapped"], min_lib_prevalence
        )

    # -- serialization ----------------------------------------------------
    def to_json_obj(self) -> Dict:
        return {
            "mapped": self.mapped,
            "unmapped": self.unmapped,
            "libraryArray": [l.to_json_obj() for l in self.libraries],
        }

    @staticmethod
    def save_lib_info(samples: List["Sample"], path: str) -> None:
        with open(path, "w") as fh:
            json.dump({s.name: s.to_json_obj() for s in samples}, fh, indent=2)

    @staticmethod
    def load_lib_info(path: str) -> Dict:
        with open(path) as fh:
            return json.load(fh)

    # -- evidence-layer services ------------------------------------------
    def get_fetch_flank(self, z: float = 3.0) -> int:
        """max over libraries of (mean + z*sd) — SPEC.md §3."""
        if not self.libraries:
            return 0
        return int(
            max(lib.mean + z * lib.sd for lib in self.libraries) + 0.5
        )

    def assign_libs(self, batch: ReadBatch) -> np.ndarray:
        """Remap decode-time RG indices to library indices; -1 = no RG."""
        rg = batch.lib_id
        out = np.where(rg >= 0, self._rg_idx_to_lib[np.maximum(rg, 0)], -1)
        # readless-RG fallback: single-library samples adopt orphan reads
        if len(self.libraries) == 1:
            out = np.where(out < 0, 0, out)
        return out.astype(np.int32)

    def is_active_lib(self, lib_idx: np.ndarray) -> np.ndarray:
        active = np.zeros(len(self.libraries) + 1, dtype=bool)
        active[self._active_lib_idx] = True
        return active[np.clip(lib_idx, 0, len(self.libraries))] & (lib_idx >= 0)

    def fetch_filter_tables(self):
        """(rg_keep[u8], rg_to_lib[i32]) tables for bamcore's in-loop
        filter — [n_rg+1] with slot n_rg = reads carrying no RG tag.
        Encodes assign_libs + is_active_lib exactly (single-library
        samples adopt orphan reads; inactive libraries dropped)."""
        n_rg = len(self._rg_idx_to_lib)
        rg_to_lib = np.empty(n_rg + 1, dtype=np.int32)
        rg_to_lib[:n_rg] = self._rg_idx_to_lib
        rg_to_lib[n_rg] = -1
        if len(self.libraries) == 1:
            rg_to_lib = np.where(rg_to_lib < 0, 0, rg_to_lib).astype(np.int32)
        rg_keep = self.is_active_lib(rg_to_lib).astype(np.uint8)
        return np.ascontiguousarray(rg_keep), np.ascontiguousarray(rg_to_lib)

    def dens_matrix(self, max_insert: Optional[int] = None) -> np.ndarray:
        """[n_libs, max_insert+1] float64 density table (device gathers)."""
        if max_insert is None:
            max_insert = max((l.max_insert for l in self.libraries), default=0)
        out = np.zeros((len(self.libraries), max_insert + 1), dtype=np.float64)
        for i, lib in enumerate(self.libraries):
            n = min(len(lib.dens_vec), max_insert + 1)
            out[i, :n] = lib.dens_vec[:n]
        return out

    @property
    def rg_ids(self) -> List[str]:
        return [rg.get("ID", "") for rg in self.bam.header.read_groups]
