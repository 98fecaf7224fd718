"""TorchEngine: chunked genotyping on one PyTorch device.

Counterpart of ``svtyper_tpu.gt.engine.TpuEngine`` on the single-device
path. The host prepares each chunk's compact wire (native
``svt_fetch_chunk`` through ``svtyper_tpu.evidence.extract``), ships it
as ONE uint8 buffer and one host-to-device copy, and one device step
runs unwire → ``classify_compact`` → the GL stage, producing the packed
``[N,24]`` rows that ``cli/fast_emit.py`` formats.

Float dtype: float64 on the CPU (oracle parity, ``ops/gl.py``'s f64
branch) and float32 on CUDA, where the GL stage is the hand-written
kernel of ``ops/gl_kernel.py``. ``dtype=torch.float32`` on the CPU runs
that kernel's plain twin instead.

The row layout helpers (``INT_FIELDS`` … ``row_to_result``,
``pack_wire``, ``_repad_compact``) are jax-free copies of the JAX
engine's, so the CLI and emitter need nothing from ``svtyper_tpu.gt``.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from svtyper_tpu.breakpoints import Breakpoint
from svtyper_tpu.evidence.extract import (
    COMPACT_KEYS,
    VARS_BOOL,
    compact_chunk,
    prepare_chunk,
    prepare_compact_chunk,
)
from svtyper_tpu.models.bayes import GT_STRINGS, GenotypeResult
from svtyper_tpu.stats.library import Sample
from svtyper_tpu_torch.evidence.device import classify_compact
from svtyper_tpu_torch.ops.gl import genotype_batch, log_choose_table
from svtyper_tpu_torch.ops.gl_kernel import genotype_rows

MAX_N_TABLE = 1 << 17  # log-choose table span; QR+QA beyond this clamps


def _repad_compact(c, r_pad: int, f_pad: int, n_var: int):
    """Grow compact matrices to common shard geometry. Padding rows:
    var = n_var (trash segment) and zero flags, so they contribute
    nothing regardless of the other fields."""
    def grow(m, pad, fill=0):
        if m.shape[1] == pad:
            return m
        out = np.full((m.shape[0], pad), fill, dtype=m.dtype)
        out[:, : m.shape[1]] = m
        return out

    out = dict(c)
    out["cr_u16"] = grow(c["cr_u16"], r_pad, n_var)
    out["cr_u8"] = grow(c["cr_u8"], r_pad)
    out["cp_u16"] = grow(c["cp_u16"], f_pad, n_var)
    out["cp_i32"] = grow(c["cp_i32"], f_pad)
    out["cp_u8"] = grow(c["cp_u8"], f_pad)
    return out


def pack_wire(packed, multi: bool = False):
    """Concatenate the compact matrices (extract.COMPACT_KEYS order)
    into one contiguous uint8 wire buffer (+ static geometry for the
    device-side unpack). With ``multi``, matrices carry a leading
    device axis and the wire is [D, nbytes]."""
    mats = [np.ascontiguousarray(packed[k]) for k in COMPACT_KEYS]
    if multi:
        d = mats[0].shape[0]
        geom = tuple((m.dtype.str, m.shape[1:]) for m in mats)
        wire = np.concatenate(
            [m.reshape(d, -1).view(np.uint8) for m in mats], axis=1
        )
    else:
        geom = tuple((m.dtype.str, m.shape) for m in mats)
        wire = np.concatenate([m.reshape(-1).view(np.uint8) for m in mats])
    return wire, geom


# packed output layout: one [N, 24] float matrix per chunk
INT_FIELDS = (
    "null", "gt_idx", "gq", "qr", "qa", "dp", "ro", "ao",
    "rs", "as_", "asc", "rp", "ap", "ab_valid",
)
_I = {k: i for i, k in enumerate(INT_FIELDS)}
# float columns: gl0 gl1 gl2 sq ab c0..c4
_NI = len(INT_FIELDS)
ROW_WIDTH = _NI + 10  # int fields + (gl0 gl1 gl2 sq ab c0..c4)

_IB = {name: i for i, name in enumerate(VARS_BOOL)}

# wire dtypes → torch views. uint16 is viewed as int16 and widened
# with a 0xFFFF mask (unsigned 16-bit ops are sparse on CUDA).
_VIEW = {
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def unwire(wire: torch.Tensor, geom) -> List[torch.Tensor]:
    """One uint8 wire buffer → the seven packed matrices, as typed views
    of the buffer (uint16 matrices come back widened to int32)."""
    if wire.storage_offset() != 0:
        raise ValueError("the wire must start at its storage's first byte")
    parts = []
    off = 0
    for dt_str, shape in geom:
        dt = np.dtype(dt_str)
        nb = int(np.prod(shape)) * dt.itemsize
        if off % dt.itemsize:
            raise ValueError(
                "wire slice at byte %d is not aligned to %s" % (off, dt)
            )
        arr = wire[off: off + nb].view(_VIEW[dt])
        if dt == np.uint16:
            arr = arr.to(torch.int32) & 0xFFFF
        parts.append(arr.reshape(shape))
        off += nb
    return parts


def dens_state(dens_np: np.ndarray, device, dtype) -> torch.Tensor:
    """A sample's insert-density matrix as device state, bucketed as
    ``TpuEngine._dens_for`` does: width padded to the next power of two
    ≥ 1024, at least one row."""
    w = 1024
    while w < dens_np.shape[1]:
        w *= 2
    padded = np.zeros((max(dens_np.shape[0], 1), w), dtype=np.float64)
    if dens_np.size:
        padded[: dens_np.shape[0], : dens_np.shape[1]] = dens_np
    return torch.as_tensor(padded, dtype=dtype, device=device)


def _resolve_device(device, dtype):
    """→ (torch.device, dtype); refuses what the port cannot run."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        dtype = dtype or torch.float32
        if dtype != torch.float32:
            raise ValueError(
                "the CUDA GL kernel is float32; got dtype %s" % dtype
            )
    elif device.type == "cpu":
        dtype = dtype or torch.float64
        if dtype not in (torch.float32, torch.float64):
            raise ValueError("unsupported dtype %s" % dtype)
    else:
        raise ValueError("unsupported device %s" % device)
    return device, dtype


class TorchEngine:
    def __init__(
        self,
        samples: List[Sample],
        min_aligned: int = 20,
        split_weight: float = 1.0,
        disc_weight: float = 1.0,
        max_reads: Optional[int] = None,
        max_ci_dist: float = 1e10,
        chunk_size: int = 1024,
        prep_workers: Optional[int] = None,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        self.device, self.dtype = _resolve_device(device, dtype)
        self.samples = samples
        self.min_aligned = min_aligned
        self.split_weight = split_weight
        self.disc_weight = disc_weight
        self.max_reads = max_reads
        self.max_ci_dist = max_ci_dist
        self.chunk_size = chunk_size
        self._cuda = self.device.type == "cuda"
        # the log-choose table serves the float64 GL branch only; the
        # float32 stage takes lc from lgamma
        self._lcf = (
            torch.as_tensor(
                log_choose_table(MAX_N_TABLE, use_f64=True),
                device=self.device,
            )
            if self.dtype == torch.float64
            else None
        )
        self._dens_cache: Dict[int, torch.Tensor] = {}
        self._hw_reads = 0
        self._hw_pairs = 0
        self._sample_pool = None  # lazy; multi-sample prep fan-out
        # -w evidence export: when set, called as sink(sample_idx, ev)
        # once per (chunk, sample) from the prep thread(s); ev is the
        # native chunk_evidence() tuple, or None when this chunk's prep
        # used a non-native path (caller falls back to a re-fetch)
        self.evidence_sink = None
        self._prep_workers = prep_workers  # None = env/auto
        # per-stage wall-time observability (SURVEY.md §5)
        self.stats = {
            "prep_s": 0.0,   # host: fetch + layout (prep thread)
            "send_s": 0.0,   # host→device copy + step launches
            "sync_s": 0.0,   # device execution exposed at the sync point
            "reads": 0,
            "pairs": 0,
            "chunks": 0,
            "variants": 0,
        }

    def _step(self, wire: torch.Tensor, geom, dens: torch.Tensor, n_var: int):
        """The device step: unwire → classify_compact → GL → [n_var,24]."""
        cr16, cr8, cp16, cp32, cp8, v32, v8 = unwire(wire, geom)
        counts = classify_compact(
            cr16, cr8, cp16, cp32, cp8, v32, v8, dens, n_var,
            dtype=self.dtype,
        )
        is_dup = v8[_IB["is_dup"]]
        force_null = v8[_IB["force_null"]]
        if self.dtype == torch.float32:
            return genotype_rows(
                counts, is_dup, force_null,
                self.split_weight, self.disc_weight,
            )
        out = genotype_batch(
            counts, is_dup, force_null, self._lcf,
            split_weight=self.split_weight, disc_weight=self.disc_weight,
        )
        ints = torch.stack([out[k].to(self.dtype) for k in INT_FIELDS], dim=1)
        flts = torch.cat(
            [out["gl"], out["sq"][:, None], out["ab"][:, None], out["counts"]],
            dim=1,
        )
        return torch.cat([ints, flts], dim=1)

    def _dens_for(self, sample_idx: int) -> torch.Tensor:
        d = self._dens_cache.get(sample_idx)
        if d is None:
            d = dens_state(
                self.samples[sample_idx].dens_matrix(), self.device, self.dtype
            )
            self._dens_cache[sample_idx] = d
        return d

    def _prepare(self, bps: List[Optional[Breakpoint]]):
        """Host-only stage: fetch + layout for one chunk → per-sample
        payloads. Runs on a single prep thread (the native chunk arena
        is one-in-flight per BAM handle); the C++ decode inside releases
        the GIL and fans out over its own threads. The numpy predicate
        pass of the non-native path runs in ``_send`` instead, on the
        main thread, overlapping the next chunk's native fetch."""
        t0 = time.time()
        n_real = len(bps)
        # constant chunk geometry: pad short chunks with absent variants
        # and reuse high-water read/pair buckets
        if len(bps) < self.chunk_size:
            bps = list(bps) + [None] * (self.chunk_size - len(bps))
        # every Sample owns its own BAM handle (separate native arena +
        # block cache) and the C++ decode drops the GIL, so per-sample
        # fetches overlap on multi-core hosts
        if len(self.samples) > 1:
            outs = list(
                self._get_sample_pool().map(
                    lambda t: self._prepare_sample(t[1], bps, t[0]),
                    enumerate(self.samples),
                )
            )
        else:
            outs = [self._prepare_sample(self.samples[0], bps, 0)]
        payloads = []
        for entry, n_ev, n_pair, r_w, p_w in outs:
            self._hw_reads = max(self._hw_reads, r_w)
            self._hw_pairs = max(self._hw_pairs, p_w)
            self.stats["reads"] += n_ev
            self.stats["pairs"] += n_pair
            payloads.append(entry)
        self.stats["prep_s"] += time.time() - t0
        self.stats["chunks"] += 1
        self.stats["variants"] += n_real
        return payloads

    def _prepare_sample(self, sample: Sample, bps, si: int = 0):
        """Stateless single-sample prep body → ``(payload_entry, n_ev,
        n_pair, r_width, p_width)``; the caller owns high-water /stats
        updates (keeps this safe to run concurrently per sample)."""
        res = prepare_compact_chunk(
            sample,
            bps,
            min_aligned=self.min_aligned,
            max_reads=self.max_reads,
            max_ci_dist=self.max_ci_dist,
            pad_reads=self._hw_reads,
            pad_pairs=self._hw_pairs,
        )
        if res is not None:
            compact, n_var, n_ev, n_pair = res
            if self.evidence_sink is not None:
                # pull the arena's kept-row records BEFORE the next
                # fetch on this handle overwrites them
                self.evidence_sink(si, sample.bam.chunk_evidence())
            return (
                (("compact", compact), n_var), n_ev, n_pair,
                compact["cr_u16"].shape[1], compact["cp_u16"].shape[1],
            )
        if self.evidence_sink is not None:
            self.evidence_sink(si, None)  # non-native prep: re-fetch
        chunk = prepare_chunk(
            sample,
            bps,
            min_aligned=self.min_aligned,
            max_reads=self.max_reads,
            max_ci_dist=self.max_ci_dist,
            pad_reads=self._hw_reads,
            pad_pairs=self._hw_pairs,
        )
        n_ev = int(np.count_nonzero(chunk.reads["var"] < chunk.n_var))
        n_pair = int(np.count_nonzero(chunk.pairs["var"] < chunk.n_var))
        return (
            (chunk, chunk.n_var), n_ev, n_pair,
            len(chunk.reads["var"]), len(chunk.pairs["var"]),
        )

    def _get_sample_pool(self):
        """Lazy multi-sample prep pool (SURVEY.md §3.1: the reference's
        classic.py gathers samples serially)."""
        from concurrent.futures import ThreadPoolExecutor

        if self._sample_pool is None:
            import os

            # auto-size against the decode fan-out: each concurrent
            # prep launches its sample's native decode threads, so the
            # two knobs must share the host, not each assume they own it
            dec = max(
                (getattr(s.bam, "_threads", 1) for s in self.samples),
                default=1,
            )
            workers = (
                self._prep_workers
                or int(os.environ.get("SVT_PREP_WORKERS", "0"))
                or max(
                    1,
                    min(
                        len(self.samples),
                        (os.cpu_count() or 2) // max(dec, 1),
                    ),
                )
            )
            self._sample_pool = ThreadPoolExecutor(max_workers=workers)
            # the pool must not outlive the engine (close() is the
            # explicit path; the finalizer covers dropped engines)
            import weakref

            self._pool_finalizer = weakref.finalize(
                self, self._sample_pool.shutdown, wait=False
            )
        return self._sample_pool

    def _to_device(self, wire: np.ndarray) -> torch.Tensor:
        """One host→device copy of the chunk's wire. On CUDA the wire is
        staged in a fresh pinned buffer and copied asynchronously; the
        caching host allocator keeps that buffer from reuse until the
        copy has completed, so chunks in flight never share one."""
        host = torch.from_numpy(wire)
        if not self._cuda:
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _send(self, payloads):
        """Device stage: host→device copy + step launches, no sync. Runs
        on the main thread; the device runs chunk k while chunk k+1
        preps and chunk k-1 collects. Each result is copied back into a
        pinned buffer behind an event that ``_collect`` waits on."""
        t0 = time.time()
        arrs = []
        with torch.cuda.device(self.device) if self._cuda else nullcontext():
            for si, (payload, n_var) in enumerate(payloads):
                if isinstance(payload, tuple) and payload[0] == "compact":
                    packed = payload[1]
                else:
                    packed = compact_chunk(payload, self.min_aligned)
                wire, geom = pack_wire(packed)
                rows = self._step(
                    self._to_device(wire), geom, self._dens_for(si), n_var
                )
                if not self._cuda:
                    arrs.append((rows, None))
                    continue
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                arrs.append((host, done))
        self.stats["send_s"] += time.time() - t0
        return arrs

    def _dispatch(self, bps: List[Optional[Breakpoint]]):
        """Prep + send for one chunk (the synchronous entry point)."""
        return self._send(self._prepare(bps))

    def _collect(
        self, n_bps: int, arrs, raw: bool = False
    ) -> List[List[GenotypeResult]]:
        t0 = time.time()
        per_sample = []
        for rows, done in arrs:
            if done is not None:
                done.synchronize()  # sync point
            per_sample.append(rows.numpy())
        self.stats["sync_s"] += time.time() - t0
        if raw:
            # vectorized-emission path (cli fast_emit): hand back the
            # packed [chunk, 24] matrices — one per sample
            return n_bps, per_sample
        return [
            [_to_result(ps, vi) for ps in per_sample]
            for vi in range(n_bps)
        ]

    def close(self) -> None:
        """Release host-side resources (the multi-sample prep pool).
        Idempotent; the engine remains usable afterwards (the pool is
        rebuilt lazily if needed)."""
        if self._sample_pool is not None:
            self._sample_pool.shutdown(wait=False)
            self._sample_pool = None

    def __enter__(self) -> "TorchEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def genotype_chunk(
        self, bps: List[Optional[Breakpoint]]
    ) -> List[List[GenotypeResult]]:
        """→ results[variant][sample], matching OracleEngine layout."""
        return self._collect(len(bps), self._dispatch(bps))

    def genotype_stream(self, bps_iter, raw: bool = False):
        """Consume an ITERABLE of breakpoints lazily and yield one
        chunk's worth of ``results[variant][sample]`` lists at a time.
        Three-stage pipeline: a prep thread runs fetch+layout for chunk
        k+1 while the main thread copies/launches chunk k and a collector
        thread waits on chunk k-1; at most 2 preps and 3 collects are in
        flight, so device and pinned buffers stay O(1).

        ``raw=True`` yields ``(n_real, [per-sample [chunk, 24] array])``
        per chunk instead of GenotypeResult lists (``cli/fast_emit``)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        from itertools import islice

        it = iter(bps_iter)
        with ThreadPoolExecutor(max_workers=1) as prep_pool, \
                ThreadPoolExecutor(max_workers=1) as collect_pool:
            preps: deque = deque()
            collects: deque = deque()
            done = False

            def pump():
                nonlocal done
                while not done and len(preps) < 2:
                    chunk = list(islice(it, self.chunk_size))
                    if not chunk:
                        done = True
                        return
                    preps.append(
                        (len(chunk), prep_pool.submit(self._prepare, chunk))
                    )

            pump()
            while preps:
                n_real, f = preps.popleft()
                payloads = f.result()
                pump()
                arrs = self._send(payloads)
                collects.append(
                    collect_pool.submit(self._collect, n_real, arrs, raw)
                )
                while len(collects) >= 3:
                    yield collects.popleft().result()
            while collects:
                yield collects.popleft().result()

    def genotype_all(
        self, bps: List[Optional[Breakpoint]]
    ) -> List[List[GenotypeResult]]:
        """Pipelined genotyping of a full list (see
        :meth:`genotype_stream`); accumulates every chunk's results."""
        results: List[List[GenotypeResult]] = []
        for chunk_results in self.genotype_stream(bps):
            results.extend(chunk_results)
        return results


def result_to_row(r: Optional[GenotypeResult]) -> np.ndarray:
    """Inverse of ``_to_result``: fixed-width float64 row. None encodes
    as null."""
    row = np.zeros(ROW_WIDTH, dtype=np.float64)
    if r is None:
        row[_I["null"]] = 1.0
        return row
    row[_I["qr"]], row[_I["qa"]] = r.qr, r.qa
    if r.counts is not None:
        row[_NI + 5 : _NI + 10] = r.counts
    if r.null:
        row[_I["null"]] = 1.0
        return row
    row[_I["gt_idx"]] = r.gt_idx
    row[_I["gq"]] = r.gq
    row[_NI + 0 : _NI + 3] = r.gl
    row[_NI + 3] = r.sq
    if r.ab is not None:
        row[_I["ab_valid"]] = 1.0
        row[_NI + 4] = r.ab
    return row


def row_to_result(row: np.ndarray) -> GenotypeResult:
    """Decode one fixed-width row (see ``result_to_row``)."""
    return _to_result(row[None], 0)


def _to_result(packed: np.ndarray, i: int) -> GenotypeResult:
    row = packed[i]
    row_f = row[_NI:]
    r = GenotypeResult()
    r.counts = tuple(float(x) for x in row_f[5:10])
    r.qr = int(row[_I["qr"]])
    r.qa = int(row[_I["qa"]])
    if row[_I["null"]]:
        return r
    r.null = False
    r.gt_idx = int(row[_I["gt_idx"]])
    r.gt_string = GT_STRINGS[r.gt_idx]
    r.gl = [float(row_f[0]), float(row_f[1]), float(row_f[2])]
    r.gq = int(row[_I["gq"]])
    r.sq = float(row_f[3])
    r.ab = float(row_f[4]) if row[_I["ab_valid"]] else None
    return r
