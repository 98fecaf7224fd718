"""TorchEngine: chunked genotyping on one or more PyTorch devices.

Counterpart of ``svtyper_tpu.gt.engine.TpuEngine``. The host prepares
each chunk's compact wire (native ``svt_fetch_chunk`` through
``evidence/extract.py``), one per device shard (with several devices
the shards of a chunk fetch concurrently, each on a BAM handle of its
own), ships each as
ONE uint8 buffer and one host-to-device copy, and one device step per
shard runs the classifier on the wire and then the GL stage, producing
the packed ``[N,24]`` rows that ``cli/fast_emit.py`` formats: on CUDA
two launches, the hand-written classify and GL kernels of
``ops/classify_kernel.py`` and ``ops/gl_kernel.py``. Where the JAX
engine runs one ``shard_map`` program over rectangular blocks, each
shard here has its own wire geometry and step; their rows are
concatenated in shard order.

Float dtype: float64 on the CPU (oracle parity: ``unwire`` →
``classify_compact`` → ``ops/gl.py``'s f64 branch) and float32 on CUDA.
``dtype=torch.float32`` on the CPU runs both kernels' plain versions
instead.

The row layout helpers (``INT_FIELDS`` … ``row_to_result``,
``pack_wire``, ``_repad_compact``) are jax-free copies of the JAX
engine's, so the CLI and emitter need nothing from ``svtyper_tpu.gt``.

On CUDA the engine needs the native BAM decoder and raises when it did
not build or load (``bamio.native.require_lib``): the pure-Python
decoder would bound every chunk at ~100x the time, without any other
sign.

A card's first use in a process (its context, the kernel modules, the
pinned host allocator, the sample's density upload) runs on warm-up
threads (``warm_devices``) that the engine starts when it is built and
that the shipped command starts earlier still, before it reads its
inputs; the first send joins them.
"""

from __future__ import annotations

import copy
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from svtyper_tpu_torch.bamio.bam import BamFile
from svtyper_tpu_torch.bamio.native import require_lib
from svtyper_tpu_torch.breakpoints import Breakpoint
from svtyper_tpu_torch.evidence.device import _prob_mapq_table
from svtyper_tpu_torch.evidence.extract import (
    COMPACT_KEYS,
    VARS_BOOL,
    compact_chunk,
    prepare_chunk,
    prepare_compact_chunk,
)
from svtyper_tpu_torch.models.bayes import GT_STRINGS, GenotypeResult
from svtyper_tpu_torch.stats.library import Sample
from svtyper_tpu_torch.ops.gl import genotype_batch, log_choose_table
from svtyper_tpu_torch.ops import _build, classify_kernel, gl_kernel
from svtyper_tpu_torch.ops.classify_kernel import classify_wire, wire_rows

MAX_N_TABLE = 1 << 17  # log-choose table span; QR+QA beyond this clamps
KERNELS = ("classify_kernel", "gl_kernel")  # the step's, csrc/<name>.cu
# the warm-up's pinned host block: a shard's wire at chunk 1,024 on a
# 30x sample is ~2 MB
WARM_BLOCK_BYTES = 1 << 21


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
_V_U8 = COMPACT_KEYS.index("v_u8")


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


def _reopen(bam) -> Optional[BamFile]:
    """A second handle on ``bam``'s file, with its own native arena and
    block cache, sharing the indexes ``bam`` parsed (read-only tables:
    a handle of its own would parse the ``.bai`` again, and rescan the
    BAM for its fine index where the ``.fidx.npz`` sidecar cannot be
    written). None where a second handle is not cheap or would not
    fetch concurrently: CRAM (no native chunk fetch) and a ``BamFile``
    on the pure-Python decoder (GIL-bound).

    ``BamFile`` has no public way to hand a parsed index to a new
    handle, so this reads and sets its private ``_threads``,
    ``_get_native()``, ``_get_fineidx()``, ``_fineidx``,
    ``_fineidx_failed`` and ``_bai``.
    ``tests/test_torch_shard_prep.py::test_reopen_pins_the_bamfile_internals``
    fails when one of them stops doing what this relies on."""
    if type(bam) is not BamFile or bam._get_native() is None:
        return None
    h = BamFile(bam.path, use_native=True, threads=bam._threads)
    fine = bam._get_fineidx()
    h._fineidx, h._fineidx_failed = fine, fine is None
    # without a fine index every fetch takes the BAI's ranges
    h._bai = bam.bai if fine is None else bam._bai
    return h


def local_cuda_devices() -> List[torch.device]:
    """Every CUDA device this process sees (``jax.local_devices()``'s
    counterpart); raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_devices(device=None, devices=None, dtype=None):
    """An engine's ``device`` (one) or ``devices`` (a list, repeats
    allowed; every visible CUDA device when both are None) → (the
    resolved ``torch.device`` list, the float dtype); refuses what the
    port cannot run. The CPU never touches ``torch.cuda``."""
    if device is not None and devices is not None:
        raise ValueError("pass device (one) or devices (a list), not both")
    if devices is None:
        devices = [device] if device is not None else local_cuda_devices()
    resolved = [_resolve_device(d, dtype) for d in devices]
    if not resolved:
        raise ValueError("no devices")
    if len({(d.type, dt) for d, dt in resolved}) != 1:
        raise ValueError("devices must be of one kind: %s" % (devices,))
    return [d for d, _ in resolved], resolved[0][1]


class _Warm:
    """A daemon thread running ``fn(parts)``; ``fn`` adds the seconds of
    each of its steps to ``parts``. ``join`` waits and re-raises what
    ``fn`` raised; ``wait`` only waits."""

    def __init__(self, name: str, fn) -> None:
        self.parts: Dict[str, float] = {}
        self.result = None
        self.error: Optional[BaseException] = None
        self.t0 = time.time()
        self.t1: Optional[float] = None
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        name=name, daemon=True)
        self._thread.start()

    def _run(self, fn) -> None:
        try:
            self.result = fn(self.parts)
        except BaseException as e:  # handed to whoever joins
            self.error = e
        finally:
            self.t1 = time.time()

    def wait(self) -> None:
        self._thread.join()

    def join(self):
        self.wait()
        if self.error is not None:
            raise self.error
        return self.result


def _step(parts: Dict[str, float], name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds added to ``parts[name]``."""
    t0 = time.time()
    out = fn(*args, **kwargs)
    parts[name] = parts.get(name, 0.0) + time.time() - t0
    return out


def _wake(dev: torch.device, parts: Dict[str, float]) -> None:
    """What a card's first send would do before its first copy, but
    torch's lazy CUDA init and the density upload: build (where needed)
    and ``dlopen`` both kernel libraries, load each kernel's module onto
    the card through its ``svt_warm`` (the first creates the card's
    primary context; ctypes drops the interpreter lock for the call),
    then a block of a wire's size from the pinned host allocator, left
    in its cache, and the classifier's prob_mapq table."""
    for name in KERNELS:
        _step(parts, "libs_s", _build.load, name)
    for name in KERNELS:
        _step(parts, "modules_s", _build.warm, name, dev.index)
    with torch.cuda.device(dev):
        _step(parts, "pinned_s", torch.empty, WARM_BLOCK_BYTES,
              dtype=torch.uint8, pin_memory=True)
        _step(parts, "tables_s", _prob_mapq_table, dev, torch.float32)


# each CUDA card's warm-up, started at most once per process
_WOKEN: Dict[torch.device, _Warm] = {}
_WOKEN_LOCK = threading.Lock()


class Warmup:
    """What ``warm_devices`` started for one caller: its cards' warm-ups
    (each shared by every caller in the process) and the upload of its
    samples' density tables."""

    def __init__(self, cards: Dict[torch.device, _Warm],
                 dens: Optional[_Warm]) -> None:
        self.cards = cards
        self.dens = dens

    def _all(self) -> List[_Warm]:
        return list(self.cards.values()) + (
            [self.dens] if self.dens is not None else [])

    def join(self) -> Dict[Tuple[int, torch.device], torch.Tensor]:
        """Waits for every part → the uploaded density tables, keyed as
        ``TorchEngine._dens_for`` keys them; re-raises a part's error."""
        for w in self.cards.values():
            w.join()
        return self.dens.join() if self.dens is not None else {}

    def wait(self) -> None:
        for w in self._all():
            w.wait()

    def busy_s(self) -> float:
        """Seconds during which at least one of the finished parts ran."""
        spans = sorted((w.t0, w.t1) for w in self._all() if w.t1 is not None)
        busy, end = 0.0, float("-inf")
        for t0, t1 in spans:
            busy += max(0.0, t1 - max(t0, end))
            end = max(end, t1)
        return busy

    def parts(self) -> Dict[str, Dict[str, float]]:
        """The seconds of each step: per card, and ``dens``."""
        out = {str(d): dict(w.parts) for d, w in self.cards.items()}
        if self.dens is not None:
            out["dens"] = dict(self.dens.parts)
        return out


def warm_devices(devices, samples=()) -> Warmup:
    """Starts, off the main thread, the first use of each CUDA card in
    ``devices`` (``_wake``: once per process and card, on a daemon thread
    of its own, so several cards come up side by side) and the upload of
    each of ``samples``' density tables to each card (a thread per call,
    after the cards' warm-ups), the tensors ``TorchEngine._dens_for``
    would upload; runs torch's lazy CUDA init on the calling thread
    first. Devices of another kind are left alone: a CPU run never
    touches ``torch.cuda``. Nothing is launched, so the kernels' launch
    counts do not move."""
    cards = sorted({torch.device(d) for d in devices
                    if torch.device(d).type == "cuda"}, key=str)
    if cards:
        # torch's lazy init keeps the interpreter lock: on a thread
        # beside a busy main thread it took 439 ms against 79 alone and
        # held the main thread back 362 ms, and beside a card's context
        # creation it waited in CUDA, lock held (PERF.md §6); so it
        # runs here, before the cards' threads start
        torch.cuda.init()
    warms = {}
    with _WOKEN_LOCK:
        for dev in cards:
            if dev not in _WOKEN:
                _WOKEN[dev] = _Warm("svt-warm-%s" % dev,
                                    lambda parts, d=dev: _wake(d, parts))
            warms[dev] = _WOKEN[dev]
    if not cards or not samples:
        return Warmup(warms, None)
    samples = list(samples)

    def upload(parts):
        for w in warms.values():
            w.wait()  # join() re-raises a card's error
        return {(si, dev): _step(parts, "dens_s", dens_state,
                                 s.dens_matrix(), dev, torch.float32)
                for dev in cards for si, s in enumerate(samples)}

    return Warmup(warms, _Warm("svt-warm-dens", upload))


class TorchEngine:
    """Chunked genotyping over one or more devices of one kind.

    ``device`` names one device; ``devices`` lists several (a device may
    repeat: ``[cpu] * 8`` or ``[cuda:0, cuda:0]`` run the sharded path
    on one device). With neither, the engine drives every visible CUDA
    device. Each chunk is split into contiguous shards of ``chunk_size
    // n_dev`` variants, one per device, and the chunk size is rounded
    up to a multiple of the device count; a one-device engine is the
    same path with one shard, so the JAX engine's ``force_shard`` has
    no counterpart here. With several devices the shards of a chunk
    are prepped concurrently over the prep pool, shard 0 on the
    sample's BAM handle and the others on more handles of the same
    file, as many as the pool runs at once (``_shard_views``), opened
    at the first prep and released by ``close()``."""

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
        device=None,
        dtype: Optional[torch.dtype] = None,
        devices: Optional[list] = None,
    ) -> None:
        self.devices, self.dtype = resolve_devices(device, devices, dtype)
        self.n_dev = len(self.devices)
        chunk_size = -(-chunk_size // self.n_dev) * self.n_dev
        self.samples = samples
        self.min_aligned = min_aligned
        self.split_weight = split_weight
        self.disc_weight = disc_weight
        self.max_reads = max_reads
        self.max_ci_dist = max_ci_dist
        self.chunk_size = chunk_size
        self._cuda = self.devices[0].type == "cuda"
        if self._cuda:
            require_lib()
        # the cards' first use and the density uploads, joined by the
        # first send (the CLI may have started the cards' part already)
        self._warm = (warm_devices(self.devices, samples) if self._cuda
                      else None)
        self.warm_parts: Dict[str, Dict[str, float]] = {}
        # per-device state: the f64 log-choose table (the float64 GL
        # branch only; the float32 stage takes lc from lgamma) and each
        # sample's insert densities, keyed by (sample, device)
        self._lcf: Dict[torch.device, torch.Tensor] = {}
        self._dens_cache: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        self._hw_reads = 0
        self._hw_pairs = 0
        self._prep_pool = None  # lazy; samples' and shards' prep fan-out
        self._views = None  # lazy; see _shard_views
        self._views_evidence = False  # -w export on the shard handles
        # -w evidence export: when set, called as sink(sample_idx, ev)
        # once per (chunk, sample) from the prep thread(s); ev is the
        # native chunk_evidence() tuple (shards merged), or None when
        # this chunk's prep used a non-native path (caller falls back to
        # a re-fetch)
        self.evidence_sink = None
        self._prep_workers = prep_workers  # None = env/auto
        # per-stage wall-time observability (SURVEY.md §5); chunks
        # counts engine chunks, not shards; classify_launches and
        # gl_launches count the CUDA classify and GL kernels' launches
        # (each one per shard of every chunk on the card)
        self.stats = {
            "prep_s": 0.0,   # host: fetch + layout (prep thread)
            "send_s": 0.0,   # host→device copy + step launches
            "sync_s": 0.0,   # device execution exposed at the sync point
            "reads": 0,
            "pairs": 0,
            "chunks": 0,
            "variants": 0,
            "classify_launches": 0,
            "gl_launches": 0,
            "warm_s": 0.0,  # the warm-up's own wall (warm_devices)
            "warm_wait_s": 0.0,  # the first send's wait for it
        }

    def _step(self, wire: torch.Tensor, geom, si: int, n_var: int):
        """The device step on the wire's device → [n_var,24]: the
        classifier on the wire (on CUDA the classify kernel reads it in
        place; on the CPU ``unwire`` → ``classify_compact``), then GL."""
        before = classify_kernel.LAUNCHES
        counts = classify_wire(
            wire, geom, self._dens_for(si, wire.device), n_var, self.dtype
        )
        self.stats["classify_launches"] += classify_kernel.LAUNCHES - before
        v8 = wire_rows(wire, geom, _V_U8)
        is_dup = v8[_IB["is_dup"]]
        force_null = v8[_IB["force_null"]]
        if self.dtype == torch.float32:
            before = gl_kernel.LAUNCHES
            rows = gl_kernel.genotype_rows(
                counts, is_dup, force_null,
                self.split_weight, self.disc_weight,
            )
            self.stats["gl_launches"] += gl_kernel.LAUNCHES - before
            return rows
        out = genotype_batch(
            counts, is_dup, force_null, self._lcf_for(wire.device),
            split_weight=self.split_weight, disc_weight=self.disc_weight,
        )
        ints = torch.stack([out[k].to(self.dtype) for k in INT_FIELDS], dim=1)
        flts = torch.cat(
            [out["gl"], out["sq"][:, None], out["ab"][:, None], out["counts"]],
            dim=1,
        )
        return torch.cat([ints, flts], dim=1)

    def _lcf_for(self, dev: torch.device) -> torch.Tensor:
        t = self._lcf.get(dev)
        if t is None:
            t = torch.as_tensor(
                log_choose_table(MAX_N_TABLE, use_f64=True), device=dev
            )
            self._lcf[dev] = t
        return t

    def _dens_for(self, sample_idx: int, dev: torch.device) -> torch.Tensor:
        d = self._dens_cache.get((sample_idx, dev))
        if d is None:
            d = dens_state(
                self.samples[sample_idx].dens_matrix(), dev, self.dtype
            )
            self._dens_cache[(sample_idx, dev)] = d
        return d

    def _prepare(self, bps: List[Optional[Breakpoint]]):
        """Host-only stage: fetch + layout for one chunk → per-sample
        lists of per-shard payloads. Runs on a single prep thread; the
        C++ decode inside releases the GIL and fans out over its own
        threads. Several samples or shards fan out further over the
        prep pool (``_prepare_shards``). The numpy predicate pass of
        the non-native path runs in ``_send`` instead, on the main
        thread, overlapping the next chunk's native fetch."""
        t0 = time.time()
        n_real = len(bps)
        # constant chunk geometry: pad short chunks with absent variants
        # and reuse high-water read/pair buckets
        if len(bps) < self.chunk_size:
            bps = list(bps) + [None] * (self.chunk_size - len(bps))
        outs = self._prepare_shards(bps)
        payloads = []
        for shards, n_ev, n_pair, r_w, p_w in outs:
            self._hw_reads = max(self._hw_reads, r_w)
            self._hw_pairs = max(self._hw_pairs, p_w)
            self.stats["reads"] += n_ev
            self.stats["pairs"] += n_pair
            payloads.append(shards)
        self.stats["prep_s"] += time.time() - t0
        self.stats["chunks"] += 1
        self.stats["variants"] += n_real
        return payloads

    def _prepare_shards(self, bps):
        """Every sample's chunk as ``n_dev`` contiguous shards of
        ``chunk_size // n_dev`` variants → one ``_merge_shards`` tuple
        per sample. The native arena allows one fetch in flight per BAM
        handle, so the shards run as one prep-pool job per handle: each
        sample, and each shard on a handle of its own, runs alone,
        concurrently with the others (the C++ decode drops the GIL); a
        sample that kept one handle (``_shard_views``), or two samples
        on one handle, prep one after another on it. Reads the
        high-water buckets and leaves them to the caller."""
        n_shard = self.chunk_size // self.n_dev
        jobs: Dict[int, list] = {}
        for si, views in enumerate(self._shard_views()):
            for d, view in enumerate(views):
                jobs.setdefault(id(view.bam), []).append((si, d, view))

        def run(job):
            return [
                (si, d, self._prepare_shard(
                    view, bps[d * n_shard: (d + 1) * n_shard]))
                for si, d, view in job
            ]

        # one job (one device, one sample) runs here, with no pool hop
        fan_out = self._get_prep_pool().map if len(jobs) > 1 else map
        parts = [[None] * self.n_dev for _ in self.samples]
        for done in fan_out(run, jobs.values()):
            for si, d, part in done:
                parts[si][d] = part
        return [self._merge_shards(si, p) for si, p in enumerate(parts)]

    def _merge_shards(self, si: int, parts):
        """One sample's ``_prepare_shard`` results, in shard order →
        ``(shard payloads, n_ev, n_pair, r_width, p_width)``; hands the
        shards' evidence, concatenated in shard order, to the -w sink."""
        if self.evidence_sink is not None:
            evs = [p[5] for p in parts]
            self.evidence_sink(
                si,
                None  # a non-native shard: the whole chunk re-fetches
                if any(e is None for e in evs)
                else tuple(np.concatenate(cols) for cols in zip(*evs)),
            )
        return (
            [p[0] for p in parts],
            sum(p[1] for p in parts),
            sum(p[2] for p in parts),
            max(p[3] for p in parts),
            max(p[4] for p in parts),
        )

    def _prepare_shard(self, sample: Sample, bps):
        """Fetch + layout of one shard → ``(payload_entry, n_ev, n_pair,
        r_width, p_width, evidence)``; evidence is the arena's
        ``chunk_evidence()`` when -w asked for it and the native path
        ran, else None."""
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
            # pull the arena's kept-row records BEFORE the next fetch on
            # this handle overwrites them
            ev = (
                sample.bam.chunk_evidence()
                if self.evidence_sink is not None else None
            )
            return (
                (("compact", compact), n_var), n_ev, n_pair,
                compact["cr_u16"].shape[1], compact["cp_u16"].shape[1], ev,
            )
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
            len(chunk.reads["var"]), len(chunk.pairs["var"]), None,
        )

    def _shard_views(self) -> List[List[Sample]]:
        """Per sample, the ``Sample`` each of the ``n_dev`` shards preps
        through: the sample itself and shallow copies whose ``bam`` is
        another handle on the file (``_reopen``), one handle per shard
        where the prep pool runs that many jobs per sample at once, the
        shards in contiguous runs over fewer where it does not (a handle
        that never fetches beside the others would only split the cache
        budget). Shard 0 is always the sample's own. A sample whose
        handle cannot be reopened cheaply (CRAM, the pure-Python
        decoder) keeps it for every shard, prepped serially; one device
        opens no handle. The handles open at the first prep; their -w
        evidence export follows ``evidence_sink`` (the CLI toggles the
        samples' own)."""
        if self._views is None:
            n_h = min(self.n_dev,
                      max(1, self._prep_width() // len(self.samples)))
            views = []
            for s in self.samples:
                own = [s]
                for _ in range(n_h - 1):
                    h = _reopen(s.bam)
                    if h is None:
                        break
                    view = copy.copy(s)
                    view.bam = h
                    own.append(view)
                views.append([own[d * len(own) // self.n_dev]
                              for d in range(self.n_dev)])
            self._views = views
            self._views_evidence = False
            # each handle holds a native block cache, and the cache
            # budget is split across every open one: close() drops them,
            # the finalizer covers dropped engines
            self._views_finalizer = weakref.finalize(self, views.clear)
        want = self.evidence_sink is not None
        if want != self._views_evidence:
            for views in self._views:
                for bam in {id(v.bam): v.bam for v in views
                            if v is not views[0]}.values():
                    bam.set_evidence_export(want)
            self._views_evidence = want
        return self._views

    def shard_bams(self) -> List[List]:
        """Per sample, the BAM handle each shard preps on (opening the
        shards' handles as the first prep does)."""
        return [[v.bam for v in views] for views in self._shard_views()]

    def _prep_width(self) -> int:
        """Prep jobs in flight at once: ``prep_workers``, else
        ``SVT_PREP_WORKERS``, else as many (sample, shard) jobs as the
        usable cores hold at the handles' decode fan-out. Each
        concurrent prep launches its handle's native decode threads, so
        the two knobs share the host's usable cores, not each assume
        they own them."""
        dec = max(
            (getattr(s.bam, "_threads", 1) for s in self.samples),
            default=1,
        )
        return (
            self._prep_workers
            or int(os.environ.get("SVT_PREP_WORKERS", "0"))
            or max(
                1,
                min(
                    len(self.samples) * self.n_dev,
                    len(os.sched_getaffinity(0)) // max(dec, 1),
                ),
            )
        )

    def _get_prep_pool(self):
        """Lazy prep pool: several samples on one device, or every
        sample's shards on several (SURVEY.md §3.1: the reference's
        classic.py gathers samples serially)."""
        from concurrent.futures import ThreadPoolExecutor

        if self._prep_pool is None:
            workers = self._prep_width()
            self._prep_pool = ThreadPoolExecutor(max_workers=workers)
            # the pool must not outlive the engine (close() is the
            # explicit path; the finalizer covers dropped engines)
            self._pool_finalizer = weakref.finalize(
                self, self._prep_pool.shutdown, wait=False
            )
        return self._prep_pool

    def _to_device(self, wire: np.ndarray, dev: torch.device) -> torch.Tensor:
        """One host→device copy of a shard's wire. On CUDA the wire is
        staged in a fresh pinned buffer and copied asynchronously; the
        caching host allocator keeps that buffer from reuse until the
        copy has completed, so chunks in flight never share one."""
        host = torch.from_numpy(wire)
        if not self._cuda:
            return host
        return host.pin_memory().to(dev, non_blocking=True)

    def _join_warm(self) -> None:
        """Waits for the warm-up (re-raising its error) and takes its
        density tables into ``_dens_for``'s cache."""
        t0 = time.time()
        self._dens_cache.update(self._warm.join())
        self.stats["warm_wait_s"] += time.time() - t0
        self.stats["warm_s"] += self._warm.busy_s()
        self.warm_parts = self._warm.parts()
        self._warm = None

    def _send(self, payloads):
        """Device stage: host→device copies + step launches, no sync.
        Runs on the main thread; every shard of every sample is launched
        before any is collected, so devices overlap, and the device runs
        chunk k while chunk k+1 preps and chunk k-1 collects. Each
        shard's rows are copied back into a pinned buffer behind an
        event that ``_collect`` waits on. The first send joins the
        warm-up first."""
        if self._warm is not None:
            self._join_warm()
        t0 = time.time()
        arrs = []
        for si, shards in enumerate(payloads):
            arrs.append([
                self._launch(si, dev, payload, n_var)
                for dev, (payload, n_var) in zip(self.devices, shards)
            ])
        self.stats["send_s"] += time.time() - t0
        return arrs

    def _launch(self, si: int, dev: torch.device, payload, n_var: int):
        """One shard's wire → its step on ``dev`` → ``(rows, event)``;
        the event is None on the CPU, where the rows are ready."""
        if isinstance(payload, tuple) and payload[0] == "compact":
            packed = payload[1]
        else:
            packed = compact_chunk(payload, self.min_aligned)
        wire, geom = pack_wire(packed)
        if not self._cuda:
            return self._step(self._to_device(wire, dev), geom, si, n_var), None
        with torch.cuda.device(dev):
            rows = self._step(self._to_device(wire, dev), geom, si, n_var)
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return host, done

    def _dispatch(self, bps: List[Optional[Breakpoint]]):
        """Prep + send for one chunk (the synchronous entry point)."""
        return self._send(self._prepare(bps))

    def _collect(
        self, n_bps: int, arrs, raw: bool = False
    ) -> List[List[GenotypeResult]]:
        t0 = time.time()
        per_sample = []
        for shards in arrs:
            for _rows, done in shards:
                if done is not None:
                    done.synchronize()  # sync point
            # shards are contiguous variant slices: concatenating them
            # in shard order restores the chunk's input order
            per_sample.append(
                np.concatenate([rows.numpy() for rows, _ in shards])
            )
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
        """Release host-side resources: the prep pool and the shards'
        extra BAM handles, whose block caches shrink every other open
        handle's; waits for a warm-up still running. Idempotent; the
        engine remains usable afterwards (both are rebuilt lazily if
        needed)."""
        if self._warm is not None:
            self._warm.wait()
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=False)
            self._prep_pool = None
        if self._views is not None:
            self._views_finalizer()
            self._views = None

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
