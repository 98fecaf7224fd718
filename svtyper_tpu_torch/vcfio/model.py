"""VCF object model with byte-exact round-trip.

Parity surface of ``svtyper/parsers.py::Vcf/Variant/Genotype`` (SURVEY.md
§2.2, L1). Design differences from the reference (this is not a port):

- Original text is kept verbatim: un-genotyped records echo their input
  line byte-for-byte, and genotyped records re-emit the original CHROM..INFO
  columns untouched, rewriting only QUAL/FORMAT/samples (SPEC.md §6).
- Header patching splices new ``##FORMAT`` lines after the last existing
  FORMAT line (or before ``#CHROM``) instead of re-normalizing the header,
  so unknown meta lines survive unchanged.
- Records are cheap column holders; the hot data (evidence counts, GLs)
  lives in dense arrays elsewhere (``svtyper_tpu/gt``), not on objects.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple


class Vcf:
    """VCF header model + sample registry."""

    def __init__(self) -> None:
        self.file_format: str = "VCFv4.2"
        self.reference: str = ""
        self.meta_lines: List[str] = []  # original ## lines, verbatim
        self.info_list: List[str] = []  # declared INFO ids (input + added)
        self.format_list: List[str] = []  # declared FORMAT ids in order
        self._format_defs: Dict[str, Tuple[str, str, str]] = {}
        self._added_format_lines: List[str] = []
        self.sample_list: List[str] = []
        self._chrom_line_cols: List[str] = []

    # -- header ingestion -------------------------------------------------
    def add_header(self, lines: Iterable[str]) -> None:
        for raw in lines:
            line = raw.rstrip("\n")
            if line.startswith("##"):
                self.meta_lines.append(line)
                if line.startswith("##fileformat="):
                    self.file_format = line.split("=", 1)[1]
                elif line.startswith("##reference="):
                    self.reference = line.split("=", 1)[1]
                elif line.startswith("##INFO=<ID="):
                    self.info_list.append(_field_id(line))
                elif line.startswith("##FORMAT=<ID="):
                    fid = _field_id(line)
                    if fid not in self._format_defs:
                        self.format_list.append(fid)
                        self._format_defs[fid] = ("", "", "")
            elif line.startswith("#CHROM"):
                self._chrom_line_cols = line.split("\t")
                self.sample_list = self._chrom_line_cols[9:]

    # -- header additions --------------------------------------------------
    def add_info(self, fid: str, number, ftype: str, desc: str) -> None:
        if fid in self.info_list:
            return
        self.info_list.append(fid)
        self.meta_lines.append(
            '##INFO=<ID=%s,Number=%s,Type=%s,Description="%s">'
            % (fid, number, ftype, desc)
        )

    def add_format(self, fid: str, number, ftype: str, desc: str) -> None:
        if fid in self._format_defs and fid in self.format_list:
            return
        self.format_list.append(fid)
        self._format_defs[fid] = (str(number), ftype, desc)
        self._added_format_lines.append(
            '##FORMAT=<ID=%s,Number=%s,Type=%s,Description="%s">'
            % (fid, number, ftype, desc)
        )

    def add_sample(self, name: str) -> None:
        if name not in self.sample_list:
            self.sample_list.append(name)

    def format_rank(self, fid: str) -> int:
        """Emission order of FORMAT fields: GT first, then declaration order."""
        if fid == "GT":
            return -1
        try:
            return self.format_list.index(fid)
        except ValueError:
            return len(self.format_list)

    # -- header emission ----------------------------------------------------
    def get_header(self) -> str:
        lines: List[str] = []
        last_fmt = -1
        for i, line in enumerate(self.meta_lines):
            if line.startswith("##FORMAT="):
                last_fmt = i
        if last_fmt < 0:
            lines = list(self.meta_lines) + list(self._added_format_lines)
        else:
            lines = (
                self.meta_lines[: last_fmt + 1]
                + list(self._added_format_lines)
                + self.meta_lines[last_fmt + 1 :]
            )
        chrom_cols = [
            "#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO",
        ]
        if self.sample_list:
            chrom_cols.append("FORMAT")
            chrom_cols.extend(self.sample_list)
        lines.append("\t".join(chrom_cols))
        return "\n".join(lines) + "\n"


class Genotype:
    """Per-sample FORMAT value map (``parsers.py::Genotype`` parity)."""

    __slots__ = ("variant", "_values")

    def __init__(self, variant: "Variant") -> None:
        self.variant = variant
        self._values: Dict[str, object] = {}

    def set_format(self, fid: str, value) -> None:
        if fid not in self.variant.vcf.format_list:
            raise KeyError("FORMAT field %r not declared in header" % fid)
        self._values[fid] = value
        self.variant.active_formats.add(fid)

    def get_format(self, fid: str):
        return self._values.get(fid)

    def get_gt_string(self, fields: List[str]) -> str:
        out = []
        for fid in fields:
            v = self._values.get(fid)
            out.append("." if v is None else str(v))
        return ":".join(out)


class Variant:
    """One VCF record bound to a :class:`Vcf` (``parsers.py::Variant`` parity)."""

    def __init__(self, line: str, vcf: Vcf) -> None:
        self.vcf = vcf
        self.original_line = line.rstrip("\n")
        cols = self.original_line.split("\t")
        if len(cols) < 8:
            raise ValueError("VCF record with <8 columns: %r" % line[:120])
        self.cols = cols
        self.chrom: str = cols[0]
        self.pos: int = int(cols[1])
        self.var_id: str = cols[2]
        self.ref: str = cols[3]
        self.alt: str = cols[4]
        self.qual_text: str = cols[5]
        try:
            self.qual: float = float(cols[5]) if cols[5] != "." else 0.0
        except ValueError:
            self.qual = 0.0
        self.filter: str = cols[6]
        self._info_text: str = cols[7]
        self._info: Optional[Dict[str, Optional[str]]] = None
        self._info_dirty = False
        self.active_formats: set = set()
        self._gts: Dict[str, Genotype] = {}
        self.genotyped = False  # QUAL/FORMAT rewritten on emit when True
        # Pre-existing sample columns: declare their FORMAT ids and
        # record which carry values, but build the per-sample Genotype
        # objects LAZILY (first genotype() call). Genotype holds a
        # backref to its Variant, so eager construction makes a
        # reference cycle per record that only cycle-GC can reclaim —
        # at CLI streaming rates that backlogged tens of thousands of
        # records between gen-2 collections (r5 soak finding); the
        # vectorized fast path never touches Genotype at all.
        self._gts_parsed = len(cols) <= 9
        if len(cols) > 9:
            in_fields = cols[8].split(":")
            for fid in in_fields:
                if fid not in vcf.format_list:
                    vcf.format_list.append(fid)
                    vcf._format_defs.setdefault(fid, ("", "", ""))
            for text in cols[9:]:
                for fid, val in zip(in_fields, text.split(":")):
                    if val != ".":
                        self.active_formats.add(fid)

    # -- INFO --------------------------------------------------------------
    @property
    def info(self) -> Dict[str, Optional[str]]:
        if self._info is None:
            d: Dict[str, Optional[str]] = {}
            if self._info_text != ".":
                for item in self._info_text.split(";"):
                    if "=" in item:
                        k, v = item.split("=", 1)
                        d[k] = v
                    else:
                        d[item] = None  # flag
            self._info = d
        return self._info

    def get_info(self, key: str) -> Optional[str]:
        """Value of an INFO key; None when absent or a bare flag."""
        return self.info.get(key)

    def has_info(self, key: str) -> bool:
        return key in self.info

    def set_info(self, key: str, value) -> None:
        self.info[key] = None if value is None else str(value)
        self._info_dirty = True

    def _info_string(self) -> str:
        if not self._info_dirty:
            return self._info_text
        if not self.info:
            return "."
        parts = []
        for k, v in self.info.items():
            parts.append(k if v is None else "%s=%s" % (k, v))
        return ";".join(parts)

    # -- genotypes -----------------------------------------------------------
    def _parse_gts(self) -> None:
        """Deferred ingestion of pre-existing sample columns (see
        ``__init__``); idempotent."""
        if self._gts_parsed:
            return
        self._gts_parsed = True
        in_fields = self.cols[8].split(":")
        for name, text in zip(self.vcf.sample_list, self.cols[9:]):
            g = Genotype(self)
            for fid, val in zip(in_fields, text.split(":")):
                if val != ".":
                    g._values[fid] = val
            self._gts[name] = g

    def genotype(self, sample_name: str) -> Genotype:
        self._parse_gts()
        g = self._gts.get(sample_name)
        if g is None:
            g = Genotype(self)
            self._gts[sample_name] = g
        return g

    # -- emission -------------------------------------------------------------
    def get_var_string(self) -> str:
        if not self.genotyped and not self._info_dirty:
            return self.original_line
        fields = sorted(self.active_formats, key=self.vcf.format_rank)
        out = [
            self.chrom,
            str(self.pos),
            self.var_id,
            self.ref,
            self.alt,
            ("%.2f" % self.qual) if self.genotyped else self.qual_text,
            self.filter,
            self._info_string(),
        ]
        if self.vcf.sample_list and fields:
            out.append(":".join(fields))
            for name in self.vcf.sample_list:
                out.append(self.genotype(name).get_gt_string(fields))
        return "\t".join(out)


def _field_id(meta_line: str) -> str:
    inner = meta_line.split("<", 1)[1]
    assert inner.startswith("ID=")
    return inner[3:].split(",", 1)[0].rstrip(">")
