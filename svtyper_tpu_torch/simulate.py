"""SV read simulator — golden-test and bench fixture generator.

The reference repo ships real NA12878 data (`data/NA12878.target_loci.
sorted.bam`, SURVEY.md §2.1) which is unavailable here (empty mount,
SURVEY.md §0), so the test strategy (SURVEY.md §4) synthesizes its own:
diploid haplotypes are built per event (DEL/DUP/INV/BND), fragments are
sampled from a Gaussian insert model, and each read is mapped back to
reference coordinates base-by-base — split reads, SA tags, and soft
clips arise naturally from junction crossings.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from svtyper_tpu_torch.bamio.cigar import M as OP_M, S as OP_S
from svtyper_tpu_torch.bamio.columns import (
    FMREVERSE,
    FPAIRED,
    FREAD1,
    FREAD2,
    FREVERSE,
)
from svtyper_tpu_torch.bamio.writer import BamWriter, make_header_text

MIN_SA_PIECE = 20  # shorter secondary pieces become bare soft clips


class SimConfig:
    def __init__(
        self,
        read_len: int = 150,
        insert_mean: float = 350.0,
        insert_sd: float = 40.0,
        depth: float = 30.0,
        mapq_choices: Sequence[int] = (60, 60, 60, 40, 27),
        sample_name: str = "NA12878",
        library_name: str = "lib1",
        noise_clip_rate: float = 0.0,
        noise_lowmapq_rate: float = 0.0,
        noise_chimera_rate: float = 0.0,
        noise_discordant_rate: float = 0.0,
    ) -> None:
        self.read_len = read_len
        self.insert_mean = insert_mean
        self.insert_sd = insert_sd
        self.depth = depth
        self.mapq_choices = list(mapq_choices)
        self.sample_name = sample_name
        self.library_name = library_name
        # "hard mode" (VERDICT r4 Missing #3: synthesized fixtures are
        # cleaner than real NA12878 data) — geometric noise classes
        # that stress the EVIDENCE model (bases are never read):
        #   clip_rate      fraction of reads given a spurious soft clip
        #                  (random end, 5-30 bp) — false clip evidence
        #   lowmapq_rate   fraction of reads remapped to mapq 0-10 —
        #                  prob_mapq down-weighting under ambiguity
        #   chimera_rate   fraction of reads given a bogus SA tag to a
        #                  random far locus — false split evidence
        #   discordant_rate fraction of background pairs re-oriented or
        #                  stretched — false span evidence at random loci
        self.noise_clip_rate = noise_clip_rate
        self.noise_lowmapq_rate = noise_lowmapq_rate
        self.noise_chimera_rate = noise_chimera_rate
        self.noise_discordant_rate = noise_discordant_rate

    def has_noise(self) -> bool:
        return any((self.noise_clip_rate, self.noise_lowmapq_rate,
                    self.noise_chimera_rate, self.noise_discordant_rate))

    @property
    def window(self) -> int:
        return int(self.insert_mean + 4 * self.insert_sd) + self.read_len


class Event:
    """One SV to simulate. Positions are 1-based VCF POS/END."""

    def __init__(
        self,
        svtype: str,
        chrom: str,
        pos: int,
        end: int,
        gt: str,
        var_id: Optional[str] = None,
        chrom2: Optional[str] = None,
        ci: Tuple[int, int] = (0, 0),
        depth_scale: float = 1.0,
    ) -> None:
        assert svtype in ("DEL", "DUP", "INV", "BND")
        self.svtype = svtype
        self.chrom = chrom
        self.pos = pos
        self.end = end
        self.gt = gt
        self.var_id = var_id or "%s_%d" % (svtype.lower(), pos)
        self.chrom2 = chrom2 or chrom  # BND partner chromosome
        self.ci = ci  # emitted as CIPOS and CIEND (gate fodder for --max_ci_dist)
        self.depth_scale = depth_scale  # local depth multiplier (--max_reads fodder)

    def n_alt_haps(self) -> int:
        return self.gt.count("1")


def _hap_maps(
    ev: Event, tid_of: Dict[str, int], cfg: SimConfig, is_alt: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-base (tid, ref_pos, strand) arrays of the local haplotype."""
    W = cfg.window
    a0 = ev.pos - 1  # breakpoint A, 0-based
    b0 = ev.end - 1
    t1 = tid_of[ev.chrom]
    t2 = tid_of[ev.chrom2]

    def span(tid: int, lo: int, hi: int, rev: bool = False):
        idx = np.arange(lo, hi, dtype=np.int64)
        if rev:
            idx = idx[::-1]
        return (
            np.full(len(idx), tid, dtype=np.int32),
            idx,
            np.full(len(idx), -1 if rev else 1, dtype=np.int8),
        )

    if not is_alt:
        if ev.svtype == "BND":
            segs = [span(t1, a0 - W, a0 + W), span(t2, b0 - W, b0 + W)]
        else:
            segs = [span(t1, a0 - W, b0 + W + 1)]
    elif ev.svtype == "DEL":
        segs = [span(t1, a0 - W, a0 + 1), span(t1, b0 + 1, b0 + W + 1)]
    elif ev.svtype == "DUP":
        # tandem: ...→b0 | a0→b0 | b0+1→...
        segs = [
            span(t1, a0 - W, b0 + 1),
            span(t1, a0, b0 + 1),
            span(t1, b0 + 1, b0 + W + 1),
        ]
    elif ev.svtype == "INV":
        segs = [
            span(t1, a0 - W, a0 + 1),
            span(t1, a0 + 1, b0 + 1, rev=True),
            span(t1, b0 + 1, b0 + W + 1),
        ]
    else:  # BND, DEL-type junction chrA:a0 → chrB:b0
        segs = [span(t1, a0 - W, a0 + 1), span(t2, b0, b0 + W)]
    tids = np.concatenate([s[0] for s in segs])
    poss = np.concatenate([s[1] for s in segs])
    strs = np.concatenate([s[2] for s in segs])
    return tids, poss, strs


class _Rec:
    __slots__ = ("qname", "flag", "tid", "pos", "mapq", "cigar", "mate_tid",
                 "mate_pos", "tlen", "seq_len", "tags", "seq")

    def __init__(self, **kw):
        self.seq = None
        for k, v in kw.items():
            setattr(self, k, v)


def _pieces(tid: np.ndarray, ref: np.ndarray, strand: np.ndarray):
    """Maximal runs of ±1-stepping ref positions with constant tid/strand."""
    n = len(ref)
    cut = np.flatnonzero(
        (tid[1:] != tid[:-1])
        | (strand[1:] != strand[:-1])
        | (ref[1:] - ref[:-1] != strand[:-1])
    )
    starts = np.concatenate(([0], cut + 1))
    ends = np.concatenate((cut + 1, [n]))
    return list(zip(starts.tolist(), ends.tolist()))


def _emit_read(
    qname: str,
    q_tid: np.ndarray,
    q_ref: np.ndarray,
    q_strand: np.ndarray,
    mapq: int,
    flag_base: int,
    ref_names: List[str],
    rg_id: str,
) -> Optional[_Rec]:
    """Build the primary record (+SA tag) for one read's per-base mapping."""
    rl = len(q_ref)
    pieces = _pieces(q_tid, q_ref, q_strand)
    pieces.sort(key=lambda p: p[1] - p[0], reverse=True)
    qs, qe = pieces[0]
    plen = qe - qs

    def rec_fields(qs: int, qe: int) -> Tuple[int, int, bool, List, str]:
        fwd = q_strand[qs] > 0
        if fwd:
            pos = int(q_ref[qs])
            lclip, rclip = qs, rl - qe
        else:
            pos = int(q_ref[qe - 1])
            lclip, rclip = rl - qe, qs
        cig = []
        if lclip:
            cig.append((OP_S, lclip))
        cig.append((OP_M, qe - qs))
        if rclip:
            cig.append((OP_S, rclip))
        cigstr = "".join(
            "%d%s" % (ln, "MIDNSHP=X"[op]) for op, ln in cig
        )
        return pos, int(q_tid[qs]), fwd, cig, cigstr

    pos, tid, fwd, cig, _ = rec_fields(qs, qe)
    flag = flag_base | (0 if fwd else FREVERSE)
    tags: Dict[str, Tuple[str, object]] = {"RG": ("Z", rg_id)}
    if len(pieces) > 1:
        sqs, sqe = pieces[1]
        if sqe - sqs >= MIN_SA_PIECE:
            spos, stid, sfwd, _, scig = rec_fields(sqs, sqe)
            tags["SA"] = (
                "Z",
                "%s,%d,%s,%s,%d,0;"
                % (ref_names[stid], spos + 1, "+" if sfwd else "-", scig, mapq),
            )
    return _Rec(
        qname=qname, flag=flag, tid=tid, pos=pos, mapq=mapq, cigar=cig,
        mate_tid=-1, mate_pos=-1, tlen=0, seq_len=rl, tags=tags,
    )


def _apply_noise(recs, refs, cfg: SimConfig, rng) -> None:
    """In-place geometric noise over the simulated record set (see
    SimConfig). Pairs stay internally consistent (mate fields follow
    any position shift); truth genotypes are unchanged — noise is what
    the genotyper must be ROBUST to, and the concordance floor in
    tests/test_noise_robustness.py is the measure."""
    ref_names = [name for name, _ in refs]
    by_qname = {}
    for r in recs:
        by_qname.setdefault(r.qname, []).append(r)
    for r in recs:
        if cfg.noise_lowmapq_rate and rng.random() < cfg.noise_lowmapq_rate:
            r.mapq = int(rng.integers(0, 11))
        if cfg.noise_clip_rate and rng.random() < cfg.noise_clip_rate:
            k = int(rng.integers(5, 31))
            cig = list(r.cigar)
            # clip k bases off one end of the outermost M run
            left = bool(rng.integers(0, 2))
            mi = 0 if cig[0][0] == OP_M else (1 if len(cig) > 1 else 0)
            if not left:
                mi = len(cig) - 1
                if cig[mi][0] != OP_M and mi > 0:
                    mi -= 1
            if cig[mi][0] == OP_M and cig[mi][1] > k + 20:
                cig[mi] = (OP_M, cig[mi][1] - k)
                if left:
                    # aligned span now starts k later
                    if cig[0][0] == OP_S:
                        cig[0] = (OP_S, cig[0][1] + k)
                    else:
                        cig.insert(0, (OP_S, k))
                    old = r.pos
                    r.pos += k
                    for m in by_qname[r.qname]:
                        if m is not r and m.mate_pos == old:
                            m.mate_pos = r.pos
                else:
                    if cig[-1][0] == OP_S:
                        cig[-1] = (OP_S, cig[-1][1] + k)
                    else:
                        cig.append((OP_S, k))
                r.cigar = cig
        if (cfg.noise_chimera_rate and "SA" not in r.tags
                and rng.random() < cfg.noise_chimera_rate):
            t = int(rng.integers(0, len(refs)))
            p = int(rng.integers(0, max(refs[t][1] - 200, 1)))
            r.tags = dict(r.tags)
            r.tags["SA"] = (
                "Z", "%s,%d,%s,%dM,%d,0;" % (
                    ref_names[t], p + 1,
                    "+" if rng.integers(0, 2) else "-",
                    cfg.read_len // 2, r.mapq),
            )
    if cfg.noise_discordant_rate:
        for r in recs:
            if not r.qname.startswith("bg_"):
                continue
            if rng.random() < cfg.noise_discordant_rate:
                mode = int(rng.integers(0, 2))
                mates = [m for m in by_qname[r.qname] if m is not r]
                if mode == 0:
                    # orientation flip (tandem-dup-like false signal)
                    r.flag ^= FREVERSE
                    for m in mates:
                        m.flag ^= FMREVERSE
                else:
                    # stretched insert (deletion-like false signal)
                    r.tlen = int(r.tlen * 4) if r.tlen else 1400


_BASE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = {65: 84, 67: 71, 71: 67, 84: 65, 78: 78}  # A<->T C<->G N


def _write_fasta(path: str, refs, genomes) -> None:
    with open(path, "w") as fh:
        for name, _l in refs:
            fh.write(">%s\n" % name)
            g = genomes[name].tobytes().decode()
            for i in range(0, len(g), 70):
                fh.write(g[i : i + 70] + "\n")


def _read_bases(genomes_by_tid, q_tid, q_ref, q_strand,
                rec_flag: int) -> str:
    """BAM SEQ for one read: the sequenced bases are the genome base at
    each (tid, ref_pos), complemented where the query maps reverse;
    BAM stores the FORWARD-strand projection, so reverse-aligned
    records (FREVERSE) store the reverse complement of the sequenced
    read."""
    out = bytearray(len(q_ref))
    for i in range(len(q_ref)):
        b = int(genomes_by_tid[int(q_tid[i])][int(q_ref[i])])
        out[i] = _COMP[b] if q_strand[i] < 0 else b
    if rec_flag & FREVERSE:
        out = bytearray(_COMP[b] for b in reversed(out))
    return out.decode()


def simulate_events(
    bam_path: str,
    refs: List[Tuple[str, int]],
    events: List[Event],
    cfg: Optional[SimConfig] = None,
    seed: int = 0,
    extra_background: int = 0,
    fasta_out: Optional[str] = None,
) -> None:
    """Write a coordinate-sorted, indexed BAM covering all events.

    ``fasta_out``: also generate a random reference genome (seeded),
    write it as an indexed-ready FASTA, and give every read its TRUE
    bases from the haplotype mapping (reverse strand complemented) —
    enabling reference-based CRAM transcodes and base-realistic -w
    fixtures. Without it, reads carry placeholder 'A' bases (the
    evidence model never reads bases; geometry is what matters)."""
    cfg = cfg or SimConfig()
    rng = np.random.default_rng(seed)
    tid_of = {name: i for i, (name, _) in enumerate(refs)}
    ref_names = [name for name, _ in refs]
    rl = cfg.read_len
    recs: List[_Rec] = []
    genomes = None
    if fasta_out:
        grng = np.random.default_rng(seed ^ 0x5EED)
        genomes = {
            name: _BASE_LUT[grng.integers(0, 4, ln)].copy()
            for name, ln in refs
        }
        _write_fasta(fasta_out, refs, genomes)
        genomes_by_tid = [genomes[name] for name, _l in refs]

    for ei, ev in enumerate(events):
        n_alt = ev.n_alt_haps()
        for hap in range(2):
            is_alt = hap < n_alt
            tids, poss, strs = _hap_maps(ev, tid_of, cfg, is_alt)
            hap_len = len(tids)
            n_frag = int(cfg.depth * ev.depth_scale / 2 * hap_len / (2 * rl))
            inserts = np.clip(
                rng.normal(cfg.insert_mean, cfg.insert_sd, n_frag),
                2 * rl + 2,
                None,
            ).astype(np.int64)
            starts = rng.integers(0, np.maximum(hap_len - inserts, 1))
            for fi in range(n_frag):
                f, ins = int(starts[fi]), int(inserts[fi])
                if f + ins > hap_len:
                    continue
                mapq = int(rng.choice(cfg.mapq_choices))
                qname = "ev%d_h%d_f%d" % (ei, hap, fi)
                # read1 forward on hap
                sl1 = slice(f, f + rl)
                # read2 = revcomp of hap tail: query base q ↦ hap f+ins-1-q
                idx2 = np.arange(f + ins - 1, f + ins - 1 - rl, -1)
                r1 = _emit_read(
                    qname, tids[sl1], poss[sl1], strs[sl1], mapq,
                    FPAIRED | FREAD1, ref_names, "rg0",
                )
                r2 = _emit_read(
                    qname, tids[idx2], poss[idx2], -strs[idx2], mapq,
                    FPAIRED | FREAD2, ref_names, "rg0",
                )
                if r1 is None or r2 is None:
                    continue
                if genomes is not None:
                    r1.seq = _read_bases(
                        genomes_by_tid, tids[sl1], poss[sl1], strs[sl1],
                        r1.flag,
                    )
                    r2.seq = _read_bases(
                        genomes_by_tid, tids[idx2], poss[idx2],
                        -strs[idx2], r2.flag,
                    )
                for a, b in ((r1, r2), (r2, r1)):
                    a.mate_tid = b.tid
                    a.mate_pos = b.pos
                    if b.flag & FREVERSE:
                        a.flag |= FMREVERSE
                lo = min(r1.pos, r2.pos)
                hi = max(r1.pos + rl, r2.pos + rl)
                if r1.tid == r2.tid:
                    span = hi - lo
                    r1.tlen = span if r1.pos <= r2.pos else -span
                    r2.tlen = -r1.tlen
                recs.extend((r1, r2))

    # optional pure-background fragments (library-stats mass)
    if extra_background:
        tid0, ref_len = 0, refs[0][1]
        inserts = np.clip(
            rng.normal(cfg.insert_mean, cfg.insert_sd, extra_background),
            2 * rl + 2, None,
        ).astype(np.int64)
        starts = rng.integers(0, max(ref_len - int(inserts.max()) - 1, 1),
                              extra_background)
        bg_genome = genomes_by_tid[0] if genomes is not None else None
        for i in range(extra_background):
            f, ins = int(starts[i]), int(inserts[i])
            mapq = int(rng.choice(cfg.mapq_choices))
            q = "bg_f%d" % i
            r1 = _Rec(qname=q, flag=FPAIRED | FREAD1 | FMREVERSE, tid=tid0,
                      pos=f, mapq=mapq, cigar=[(OP_M, rl)], mate_tid=tid0,
                      mate_pos=f + ins - rl, tlen=ins, seq_len=rl,
                      tags={"RG": ("Z", "rg0")})
            r2 = _Rec(qname=q, flag=FPAIRED | FREAD2 | FREVERSE, tid=tid0,
                      pos=f + ins - rl, mapq=mapq, cigar=[(OP_M, rl)],
                      mate_tid=tid0, mate_pos=f, tlen=-ins, seq_len=rl,
                      tags={"RG": ("Z", "rg0")})
            if bg_genome is not None:
                r1.seq = bg_genome[f : f + rl].tobytes().decode()
                # reverse read: stored SEQ is the forward-strand bases
                # of its alignment span (BAM convention)
                r2.seq = bg_genome[
                    f + ins - rl : f + ins
                ].tobytes().decode()
            recs.extend((r1, r2))

    if cfg.has_noise():
        _apply_noise(recs, refs, cfg, rng)

    recs.sort(key=lambda r: (r.tid, r.pos))
    hdr = make_header_text(
        refs,
        read_groups=[
            {"ID": "rg0", "SM": cfg.sample_name, "LB": cfg.library_name}
        ],
    )
    w = BamWriter(bam_path, refs, hdr)
    for r in recs:
        w.write(
            r.qname, r.flag, r.tid, r.pos, r.mapq, r.cigar,
            mate_tid=r.mate_tid, mate_pos=r.mate_pos, tlen=r.tlen,
            seq=r.seq if r.seq is not None else "A" * r.seq_len,
            tags=r.tags,
        )
    w.close()


def events_to_vcf(events: List[Event], refs: List[Tuple[str, int]],
                  sample: str = "NA12878", bnd_mates: bool = False) -> str:
    """Minimal LUMPY-style VCF text for the simulated events.

    ``bnd_mates=True`` emits each BND event as a mate PAIR (``<id>_1``
    at chromA:pos with ALT ``N[chromB:end[`` and ``<id>_2`` at
    chromB:end with ALT ``]chromA:pos]N``, cross-referenced via
    MATEID) — the LUMPY breakend form the BndRegistry genotypes once
    and copies to the mate (SURVEY.md §3.2)."""
    lines = [
        "##fileformat=VCFv4.2",
        "##source=svtyper_tpu.simulate",
    ]
    for name, ln in refs:
        lines.append("##contig=<ID=%s,length=%d>" % (name, ln))
    for k, n, t, d in (
        ("SVTYPE", 1, "String", "Type of structural variant"),
        ("END", 1, "Integer", "End position of the variant"),
        ("CIPOS", 2, "Integer", "Confidence interval around POS"),
        ("CIEND", 2, "Integer", "Confidence interval around END"),
        ("MATEID", ".", "String", "ID of mate breakends"),
        ("EVENT", 1, "String", "ID of event associated to breakend"),
    ):
        lines.append(
            '##INFO=<ID=%s,Number=%s,Type=%s,Description="%s">' % (k, n, t, d)
        )
    lines.append(
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">'
    )
    lines.append(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + sample
    )
    for ev in events:
        ci = "CIPOS=%d,%d;CIEND=%d,%d" % (ev.ci[0], ev.ci[1],
                                          ev.ci[0], ev.ci[1])
        if ev.svtype == "BND":
            if bnd_mates:
                id1, id2 = ev.var_id + "_1", ev.var_id + "_2"
                alt1 = "N[%s:%d[" % (ev.chrom2, ev.end)
                alt2 = "]%s:%d]N" % (ev.chrom, ev.pos)
                info1 = "SVTYPE=BND;MATEID=%s;EVENT=%s;%s" % (
                    id2, ev.var_id, ci)
                info2 = "SVTYPE=BND;MATEID=%s;EVENT=%s;SECONDARY;%s" % (
                    id1, ev.var_id, ci)
                lines.append("\t".join(
                    (ev.chrom, str(ev.pos), id1, "N", alt1, ".", ".",
                     info1, "GT", "./.")))
                lines.append("\t".join(
                    (ev.chrom2, str(ev.end), id2, "N", alt2, ".", ".",
                     info2, "GT", "./.")))
                continue
            alt = "N[%s:%d[" % (ev.chrom2, ev.end)
            info = "SVTYPE=BND;" + ci
        else:
            alt = "<%s>" % ev.svtype
            info = "SVTYPE=%s;END=%d;%s" % (ev.svtype, ev.end, ci)
        lines.append(
            "\t".join(
                (ev.chrom, str(ev.pos), ev.var_id, "N", alt, ".", ".",
                 info, "GT", "./.")
            )
        )
    return "\n".join(lines) + "\n"
