"""The ``svtyper`` command line on PyTorch (parity of
``classic.py::main/sv_genotype``, SURVEY.md §2.2–2.3).

Counterpart of ``svtyper_tpu.cli.classic``: the same flags, chunking,
BND mate sharing, checkpoint/resume, ``-w`` and ``--num_shards``, with
``--engine torch`` (the default) driving ``gt.engine.TorchEngine`` on
one device, CUDA unless the library caller passes another. Not ported
yet: the ``SVT_DIST_*`` multi-host mode and ``--profile``, which raise.

    python -m svtyper_tpu_torch.cli.classic -i in.vcf -B s.bam -o out.vcf
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import IO, List, Optional

from svtyper_tpu.bamio.bam import open_bam
from svtyper_tpu.breakpoints import BndRegistry
from svtyper_tpu.cli.classic import open_vcf_input
from svtyper_tpu.output import add_format_headers, apply_variant
from svtyper_tpu.stats import Sample
from svtyper_tpu.vcfio.model import Variant, Vcf
from svtyper_tpu.vcfio.reader import read_vcf_lines
from svtyper_tpu.version import __version__


def get_args(argv=None):
    p = argparse.ArgumentParser(
        prog="svtyper",
        description="Compute genotype of structural variants based on breakpoint depth (PyTorch/CUDA)",
    )
    p.add_argument("--version", action="version",
                   version="%%(prog)s %s" % __version__)
    p.add_argument("-i", "--input_vcf", default=None,
                   help="VCF input (default: stdin)")
    p.add_argument("-o", "--output_vcf", default=None,
                   help="output VCF to write (default: stdout)")
    p.add_argument("-B", "--bam", required=True,
                   help="BAM file(s), comma-separated if genotyping multiple samples")
    p.add_argument("-T", "--ref_fasta", default=None,
                   help="reference FASTA (optional: CRAM genotyping "
                        "decodes CIGAR from read features without it; "
                        "providing it restores full SEQ/QUAL in -w "
                        "output from CRAM)")
    p.add_argument("-l", "--lib_info", default=None,
                   help="create/read JSON file of library information")
    p.add_argument("-m", "--min_aligned", type=int, default=20,
                   help="minimum number of aligned bases to consider read as evidence [20]")
    p.add_argument("-n", dest="num_samp", type=int, default=1000000,
                   help="number of reads to sample from BAM file for building insert size distribution [1000000]")
    p.add_argument("-q", "--sum_quals", action="store_true",
                   help="add genotyping quality to existing QUAL (default: overwrite QUAL field)")
    p.add_argument("--split_weight", type=float, default=1.0,
                   help="weight for split reads [1]")
    p.add_argument("--disc_weight", type=float, default=1.0,
                   help="weight for discordant paired-end reads [1]")
    p.add_argument("--max_reads", type=int, default=None,
                   help="maximum number of reads to assess at any variant (reduces processing time in high-depth regions) [unlimited]")
    p.add_argument("--max_ci_dist", type=float, default=1e10,
                   help="maximum size of a confidence interval before 0/0 genotype [1e10]")
    p.add_argument("-w", "--write_alignment", default=None,
                   help="write relevant reads to BAM file (CRAM inputs "
                        "emit full SEQ/QUAL when -T provides the "
                        "reference FASTA; seq-less '*' records "
                        "otherwise)")
    p.add_argument("--debug", action="store_true", help="debugging verbosity")
    p.add_argument("--verbose", action="store_true", help="progress logging")
    # device-framework extensions (not in the reference)
    p.add_argument("--engine", choices=("torch", "oracle"), default="torch",
                   help="genotyping engine: batched device pipeline or the float64 per-read oracle [torch]")
    p.add_argument("--batch_size", type=int, default=1024,
                   help="variants per device chunk [1024]")
    p.add_argument("--cores", type=int, default=None,
                   help="host-side prep threads (default: auto)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profiler trace of the run (not yet ported: raises)")
    p.add_argument("--checkpoint_dir", default=None, metavar="DIR",
                   help="spill each genotyped chunk to DIR and resume a killed "
                        "run at chunk granularity (same input + batch_size)")
    p.add_argument("--num_shards", type=int, default=1,
                   help="split the variant set into N contiguous shards "
                        "(multi-host data parallelism; each shard emits only "
                        "its slice, concatenate shard outputs in order)")
    p.add_argument("--shard_index", type=int, default=0,
                   help="which shard this process genotypes [0]")
    return p.parse_args(argv)


def sv_genotype(
    bam_string: str,
    vcf_in: IO[str],
    vcf_out: IO[str],
    min_aligned: int = 20,
    split_weight: float = 1.0,
    disc_weight: float = 1.0,
    num_samp: int = 1_000_000,
    lib_info_path: Optional[str] = None,
    debug: bool = False,
    alignment_outpath: Optional[str] = None,
    ref_fasta: Optional[str] = None,
    sum_quals: bool = False,
    max_reads: Optional[int] = None,
    max_ci_dist: float = 1e10,
    engine_kind: str = "torch",
    batch_size: int = 1024,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    num_shards: int = 1,
    shard_index: int = 0,
    cores: Optional[int] = None,
    device=None,
    dtype=None,
) -> None:
    """Library entry point (parity of ``classic.py::sv_genotype``).

    ``device`` is the torch engine's device (None → "cuda"); ``dtype``
    its float type (None → float32 on CUDA, float64 on the CPU)."""
    t0 = time.time()
    if os.environ.get("SVT_DIST_COORD") or os.environ.get("SVT_DIST_NPROCS"):
        raise RuntimeError(
            "SVT_DIST_* multi-host mode is not ported to svtyper_tpu_torch "
            "yet: unset SVT_DIST_COORD/SVT_DIST_NPROCS, or split the run "
            "with --num_shards/--shard_index"
        )
    bam_paths = [b for b in bam_string.split(",") if b]
    # --cores drives the native decoder's per-fetch thread fan-out (the
    # role of the reference sso's fork pool: host-side parallelism)
    bams = [open_bam(p, threads=cores, ref_fasta=ref_fasta)
            for p in bam_paths]

    # Samples: JSON cache if it exists, else head-scan (then save cache)
    samples: List[Sample] = []
    if lib_info_path and os.path.exists(lib_info_path):
        info = Sample.load_lib_info(lib_info_path)
        for bam in bams:
            samples.append(Sample.from_lib_info(bam, info))
    else:
        for bam in bams:
            samples.append(Sample.from_bam(bam, num_samp=num_samp))
        if lib_info_path:
            Sample.save_lib_info(samples, lib_info_path)
    if verbose:
        sys.stderr.write(
            "svtyper_tpu_torch %s: %d sample(s) ready in %.1fs\n"
            % (__version__, len(samples), time.time() - t0)
        )

    if engine_kind == "oracle":
        from svtyper_tpu.oracle import OracleEngine

        engine = OracleEngine(
            samples, min_aligned=min_aligned, split_weight=split_weight,
            disc_weight=disc_weight, max_reads=max_reads,
            max_ci_dist=max_ci_dist,
        )

        def run_chunk(bps):
            return [engine.genotype_variant(bp) if bp is not None
                    else [None] * len(samples) for bp in bps]
    else:
        from svtyper_tpu_torch.gt.engine import TorchEngine

        engine = TorchEngine(
            samples, min_aligned=min_aligned, split_weight=split_weight,
            disc_weight=disc_weight, max_reads=max_reads,
            max_ci_dist=max_ci_dist, chunk_size=batch_size,
            prep_workers=cores, device=device or "cuda", dtype=dtype,
        )

    # the body start for get_body() re-streams must be the stream's
    # CURRENT position, not byte 0 — a library caller may hand us a
    # handle positioned past a prefix (review, r5)
    try:
        _body_origin = vcf_in.tell()
    except (OSError, ValueError, AttributeError):
        _body_origin = None
    header_lines, body = read_vcf_lines(vcf_in)
    vcf = Vcf()
    vcf.add_header(header_lines)
    add_format_headers(vcf)
    sample_names = [s.name for s in samples]
    for name in sample_names:
        vcf.add_sample(name)

    # Streaming pre-scan (SURVEY.md §5 scale axis; VERDICT r4 item 4):
    # ONE pass over the body computes the record count, the checkpoint
    # manifest's content hash, and the BND-only line subset the mate
    # registry needs (it must see mates that appear after the current
    # record). Seekable inputs are then RE-STREAMED lazily per
    # consumer instead of materialized, so CLI host RSS stays flat
    # over million-variant VCFs; a pipe (stdin) still buffers.
    import hashlib
    import itertools

    vcf_sha = hashlib.sha256()
    for line in header_lines:
        vcf_sha.update(line.encode())
        vcf_sha.update(b"\n")
    vcf_sha.update(b"--\n")
    bnd_lines: List[str] = []
    n_records = 0

    def _prescan(lines):
        # ONE loop shared by both branches: the hash scheme must stay
        # byte-identical to checkpoint.build_manifest or manifests stop
        # matching across code paths (review, r5)
        nonlocal n_records
        for line in lines:
            n_records += 1
            vcf_sha.update(line.encode())
            vcf_sha.update(b"\n")
            if "SVTYPE=BND" in line:
                bnd_lines.append(line)

    try:
        seekable = _body_origin is not None and vcf_in.seekable()
    except Exception:
        seekable = False
    if seekable:
        _prescan(body)

        def get_body():
            vcf_in.seek(_body_origin)
            return read_vcf_lines(vcf_in)[1]
    else:
        _buf = list(body)
        _prescan(_buf)

        def get_body():
            return iter(_buf)

    # the registry only reads BND records; feeding it the filtered
    # subset preserves relative input order (its primary-anchor
    # tie-break), so resolution is identical to a full-body scan
    registry = BndRegistry()
    registry.scan(bnd_lines)

    # checkpoint manifest guard: replay is keyed by chunk index, so the
    # directory must be bound to THIS input + flag tuple — a mismatch
    # (different VCF/BAM/flags) refuses instead of silently emitting
    # stale genotypes (cli/checkpoint.py)
    from svtyper_tpu.cli.checkpoint import CrashInjector

    crash = CrashInjector()
    if checkpoint_dir:
        import json

        from svtyper_tpu.cli.checkpoint import (
            build_manifest_hashed,
            ensure_manifest,
        )

        lib_sha = hashlib.sha256(
            json.dumps(
                [s.to_json_obj() for s in samples], sort_keys=True
            ).encode()
        ).hexdigest()
        ensure_manifest(
            checkpoint_dir,
            build_manifest_hashed(
                bam_paths, vcf_sha.hexdigest(), n_records,
                flags={
                    "min_aligned": min_aligned,
                    "split_weight": split_weight,
                    "disc_weight": disc_weight,
                    "sum_quals": sum_quals,
                    "max_reads": max_reads,
                    "max_ci_dist": max_ci_dist,
                    "batch_size": batch_size,
                    "num_shards": num_shards,
                    "shard_index": shard_index,
                    "n_procs": 1,
                    # engines are byte-identical on the f64 parity
                    # config but may differ at format-rounding
                    # boundaries in f32 — never mix their chunks
                    "engine": engine_kind,
                    "lib_stats_sha256": lib_sha,
                },
            ),
        )

    if shard_index == 0:
        # shards >0 emit body-only so that `cat shard0 shard1 ...` is
        # byte-identical to the single-process output
        vcf_out.write(vcf.get_header())

    writer_bams = None
    evidence_streamed = False
    if alignment_outpath:
        from svtyper_tpu.cli.write_alignment import EvidenceWriter

        writer_bams = EvidenceWriter(alignment_outpath, samples)
        # engine-export fast path: the native chunk fetch records every
        # kept row's location during genotyping prep, so -w costs no
        # second decode pass (falls back to the batched re-fetch when
        # any sample lacks native support — CRAM, pure-Python); engine
        # chunks are the CLI's chunk plans, keeping the writer's
        # per-chunk flag FIFO 1:1 with them
        fallback_why = None
        if engine_kind != "torch":
            fallback_why = "oracle engine has no decode arena"
        if fallback_why is None:
            toggles = [
                getattr(s.bam, "set_evidence_export", lambda v: False)
                for s in samples
            ]
            enabled = [t(True) for t in toggles]
            if all(enabled):
                engine.evidence_sink = writer_bams.push_native
                evidence_streamed = True
            else:
                # mixed support (e.g. BAM + CRAM): roll back so no
                # handle records rows nobody will export
                for t, on in zip(toggles, enabled):
                    if on:
                        t(False)
                fallback_why = (
                    "input(s) without native evidence export (CRAM or "
                    "pure-Python decode)"
                )
        if fallback_why is not None:
            # the arena path costs no second decode; the re-fetch path
            # re-reads every evidence window — never degrade silently
            # (VERDICT r4 Weak #5)
            sys.stderr.write(
                "note: -w using the batched re-fetch path (%s); "
                "expect roughly one extra read pass over the evidence "
                "windows\n" % fallback_why
            )

    n_done = 0
    chunk_idx = 0
    t_gt = time.time()
    t_first_chunk = [None]  # wall time when the first chunk emitted
    pending: List[Variant] = []
    # BND mate pairing (SPEC.md §2, §8.8): each breakend event is
    # genotyped ONCE — at the first-arriving record's slot, with the
    # registry's shared anchor breakpoint — and the result row is
    # copied to the mate when it appears (records stay in input order;
    # unpaired breakends are genotyped independently)
    bnd_results: dict = {}
    bnd_computed: set = set()

    def part_path():
        """Per-chunk checkpoint part file; advances the chunk counter.
        SINGLE SOURCE for part naming + counter + replay side effects —
        the serial flush() drive and the streaming plan/emit drive both
        go through here (a diverged copy caused the r4 phase-2 cursor
        bug)."""
        nonlocal chunk_idx
        if not checkpoint_dir:
            return None
        path = os.path.join(
            checkpoint_dir, "part_%06d.vcfpart" % chunk_idx
        )
        chunk_idx += 1
        return path

    def replay_part(path, vars_):
        """Emit a finished chunk's spilled lines; advance every piece
        of per-chunk state a computed chunk would have advanced —
        including the -w evidence collection, which a replayed chunk
        must re-fetch (the engine never sees its reads)."""
        nonlocal n_done
        with open(path) as fh:
            for line in fh:
                vcf_out.write(line)
        if writer_bams is not None:
            # plain resolve (no bnd_computed mutation): mates share the
            # anchor breakpoint and close() dedups by voffset
            writer_bams.add_batch([registry.resolve(v) for v in vars_])
        n_done += len(vars_)
        crash.chunk_done()

    def plan_chunk(vars_):
        """bps + run_bps for one chunk (run order = feed order): the
        second record of an already-computed breakend event gets
        ``run_bps[i] = None`` — its row is copied from the mate at
        emission."""
        bps = [registry.resolve(v) for v in vars_]
        for v, bp in zip(vars_, bps):
            if bp is None:
                sys.stderr.write(
                    "Warning: skipping variant %s, SVTYPE %s not supported\n"
                    % (v.var_id, v.get_info("SVTYPE"))
                )
        run_bps = list(bps)
        for i, (v, bp) in enumerate(zip(vars_, bps)):
            if bp is not None and bp.svtype == "BND":
                mate_id = v.get_info("MATEID")
                if mate_id and mate_id in bnd_computed:
                    run_bps[i] = None
                else:
                    bnd_computed.add(v.var_id)
        return bps, run_bps

    def emit_tail(vars_, bps, out_lines, part):
        """Shared per-chunk epilogue (-w collection, output write, part
        spill, progress) for the object and vectorized formatters."""
        nonlocal n_done
        if writer_bams is not None:
            if evidence_streamed:
                wide = [
                    bp for bp in bps
                    if bp is not None and bp.ci_width() > max_ci_dist
                ]
                writer_bams.finish_chunk(bps, wide)
            else:
                # one batched fetch per chunk (rides the block cache
                # the genotyping pass just warmed) — not per variant
                writer_bams.add_batch(bps)
        vcf_out.writelines(out_lines)
        if part is not None:
            tmp = part + ".tmp"
            with open(tmp, "w") as fh:
                fh.writelines(out_lines)
            os.replace(tmp, part)
        n_done += len(vars_)
        if t_first_chunk[0] is None:
            # one-time device program load/compile dominates the first
            # chunk on a fresh process; recording its boundary lets the
            # bench report steady-state CLI throughput honestly
            t_first_chunk[0] = time.time()
        crash.chunk_done()
        if verbose:
            dt = time.time() - t_gt
            sys.stderr.write(
                "genotyped %d variants (%.1f variants/s)\n"
                % (n_done, n_done / dt if dt > 0 else 0.0)
            )

    def emit_chunk(vars_, bps, rows, part):
        """Format + write one genotyped chunk (BND mate sharing, QUAL
        aggregation, -w collection, part spill, progress)."""
        out_lines: List[str] = []
        for v, bp, res_row in zip(vars_, bps, rows):
            if bp is None:
                out_lines.append(v.get_var_string() + "\n")
                continue
            if bp.svtype == "BND":
                mate_id = v.get_info("MATEID")
                if mate_id and mate_id in bnd_results:
                    res_row = bnd_results.pop(mate_id)
                    bnd_computed.discard(mate_id)
                elif mate_id and registry.mate_known(v.var_id):
                    bnd_results[v.var_id] = res_row
            apply_variant(v, sample_names, res_row, sum_quals=sum_quals)
            if debug:
                for name, res in zip(sample_names, res_row):
                    sys.stderr.write(
                        "%s %s counts=%s QR=%s QA=%s GT=%s\n"
                        % (v.var_id, name, res.counts, res.qr, res.qa,
                           res.gt_string)
                    )
            out_lines.append(v.get_var_string() + "\n")
        emit_tail(vars_, bps, out_lines, part)

    def flush():
        if not pending:
            return
        # chunk checkpoint/resume (SURVEY.md §5): a completed chunk's
        # formatted lines are spilled to a part file; a rerun with the
        # same input and batch_size replays them without re-genotyping
        part = part_path()
        if part is not None and os.path.exists(part):
            replay_part(part, pending)
            pending.clear()
            return
        bps, run_bps = plan_chunk(pending)
        rows = run_chunk(run_bps)
        emit_chunk(pending, bps, rows, part)
        pending.clear()

    # contiguous variant sharding (--num_shards): this process emits only
    # the records of its shard, in input order; shard outputs concatenate
    # to the single-process output byte-for-byte
    from svtyper_tpu_torch.parallel.multihost import shard_slices

    body_emit = get_body()
    if num_shards > 1:
        # the BND registry was built from the FULL body above, so a
        # breakend pair straddling a shard boundary still resolves to
        # the same anchor breakpoint on both shards
        lo, hi = shard_slices(n_records, num_shards)[shard_index]
        body_emit = itertools.islice(body_emit, lo, hi)

    if engine_kind == "torch":
        # streaming drive: chunk PLANS feed the engine's pipelined
        # genotype_stream (prep thread / async dispatch / collect
        # thread), while this loop formats chunks in input order as
        # their rows surface; a per-chunk genotype_chunk drive would
        # serialize prep→transfer→sync and expose the device round trip
        # on every chunk.
        def chunk_plans():
            pend: List[Variant] = []

            def mk(vars_):
                part = part_path()
                if part is not None and os.path.exists(part):
                    return (vars_, None, None, part, True)
                bps, run_bps = plan_chunk(vars_)
                return (vars_, bps, run_bps, part, False)

            for line in body_emit:
                pend.append(Variant(line, vcf))
                if len(pend) >= batch_size:
                    yield mk(pend)
                    pend = []
            if pend:
                yield mk(pend)

        # two views of one plan stream: the feed side is consumed by
        # genotype_stream's pump (same thread, during next()), the
        # format side below — tee buffers only the in-flight chunks
        plans_feed, plans_fmt = itertools.tee(chunk_plans())

        def bp_feed():
            for _v, _b, run_bps, _p, replay in plans_feed:
                if not replay:
                    yield from run_bps

        # vectorized emission (fast_emit): chunk-at-a-time numpy
        # formatting of the packed result matrices, byte-identical to
        # the object path. Needs the default FORMAT declaration order;
        # --debug needs the per-variant objects.
        from svtyper_tpu_torch.cli.fast_emit import (
            eligible as _fast_ok,
            format_chunk_lines,
        )

        use_fast = not debug and _fast_ok(vcf, sample_names)
        if use_fast:
            raw_stream = engine.genotype_stream(bp_feed(), raw=True)
        else:
            flat = (
                row
                for chunk_rows in engine.genotype_stream(bp_feed())
                for row in chunk_rows
            )
        # the first chunk of a fresh checkout also builds the CUDA
        # kernel (nvcc); if it takes long, tell the user the run is alive
        import threading

        first_done = threading.Event()

        def _watch():
            if not first_done.wait(90):
                sys.stderr.write(
                    "note: still waiting on the first device chunk "
                    "(>90s) — typically the one-time kernel build or "
                    "device start-up; the run proceeds once the device "
                    "responds\n"
                )

        threading.Thread(target=_watch, daemon=True).start()
        for vars_, bps, run_bps, part, replay in plans_fmt:
            if replay:
                first_done.set()  # progress: the run is not device-hung
                replay_part(part, vars_)
                continue
            if use_fast:
                n_r, per_sample = next(raw_stream)
                first_done.set()
                # plan chunks and engine chunks are 1:1 (both are
                # batch_size long)
                assert n_r == len(vars_), (n_r, len(vars_))
                out_lines = format_chunk_lines(
                    vars_, bps, per_sample, sample_names, sum_quals,
                    bnd_results, bnd_computed, registry,
                )
                emit_tail(vars_, bps, out_lines, part)
            else:
                rows = [next(flat) for _ in range(len(vars_))]
                first_done.set()
                emit_chunk(vars_, bps, rows, part)
        first_done.set()  # loop done (possibly zero chunks): stop watcher
    else:
        for line in body_emit:
            pending.append(Variant(line, vcf))
            if len(pending) >= batch_size:
                flush()
        flush()
    if writer_bams is not None:
        writer_bams.close()
    if hasattr(engine, "close"):
        engine.close()  # release the multi-sample prep pool promptly
    if verbose and hasattr(engine, "stats"):
        st = engine.stats
        dt = time.time() - t_gt
        sys.stderr.write(
            "summary: %d variants in %.2fs (%.1f variants/s) | "
            "%d reads, %d pairs, %d chunks | prep %.2fs, send %.2fs, "
            "device-sync %.2fs\n"
            % (st["variants"], dt, st["variants"] / dt if dt > 0 else 0.0,
               st["reads"], st["pairs"], st["chunks"],
               st["prep_s"], st["send_s"], st["sync_s"])
        )
    stats_path = os.environ.get("SVT_CLI_STATS")
    if stats_path:
        # machine-readable run stats (chip_smoke.py reads them):
        # genotype_wall_s covers parse → last
        # write, total_wall_s adds sample bootstrap; n_done counts
        # emitted records (replayed checkpoint chunks included)
        import json as _json

        payload = {
            "n_variants": n_done,
            "genotype_wall_s": time.time() - t_gt,
            "total_wall_s": time.time() - t0,
            "first_chunk_s": (
                (t_first_chunk[0] - t_gt) if t_first_chunk[0] else None
            ),
        }
        if hasattr(engine, "stats"):
            payload.update(
                {k: engine.stats[k]
                 for k in ("prep_s", "send_s", "sync_s", "reads", "pairs",
                           "chunks")}
            )
        from svtyper_tpu.bamio.native import perf_counters

        payload["native_perf"] = perf_counters()
        with open(stats_path, "w") as fh:
            _json.dump(payload, fh)


def main(argv=None, device=None) -> int:
    """CLI entry point; ``device`` None → "cuda"."""
    args = get_args(argv)
    if args.profile:
        raise NotImplementedError(
            "--profile is not yet ported to svtyper_tpu_torch (ROADMAP)"
        )
    vcf_in = open_vcf_input(args.input_vcf) if args.input_vcf \
        else sys.stdin
    vcf_out = open(args.output_vcf, "w") if args.output_vcf else sys.stdout
    try:
        sv_genotype(
            args.bam,
            vcf_in,
            vcf_out,
            min_aligned=args.min_aligned,
            split_weight=args.split_weight,
            disc_weight=args.disc_weight,
            num_samp=args.num_samp,
            lib_info_path=args.lib_info,
            debug=args.debug,
            alignment_outpath=args.write_alignment,
            ref_fasta=args.ref_fasta,
            sum_quals=args.sum_quals,
            max_reads=args.max_reads,
            max_ci_dist=args.max_ci_dist,
            engine_kind=args.engine,
            batch_size=args.batch_size,
            verbose=args.verbose or args.debug,
            checkpoint_dir=args.checkpoint_dir,
            num_shards=args.num_shards,
            shard_index=args.shard_index,
            cores=args.cores,
            device=device,
        )
    finally:
        if args.input_vcf:
            vcf_in.close()
        if args.output_vcf:
            vcf_out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
