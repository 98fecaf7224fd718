"""The port's host prep per chunk, split into its parts, and cProfiled.

Counterpart of ``scripts/profile_prep.py``, which profiles the JAX
package's Python ``prepare_chunk``. Here the default path is the one
``TorchEngine`` runs: for each chunk size and shard count a
``TorchEngine([sample], chunk_size=cs, devices=...)`` (``[device] * k``,
or ``k`` distinct cards where the host has them, as
``tools/scaling_curve`` picks them) on a new BAM handle, so with an
empty block cache, preps the first chunk to warm up, then
``engine._prepare`` is timed over every chunk of the VCF: the engine's
host stage alone, the native ``prepare_compact_chunk`` of each shard,
the shards fetching concurrently, each on its own BAM handle
(``TorchEngine.shard_bams``). The device step does not run. The
first timed chunk repeats the warm-up's; on a VCF whose loci repeat
(a tiled one) every block is then cached, on distinct loci each later
chunk inflates its own (the ``blocks`` counter says which).

Each chunk's wall is split, by wrappers installed for the timed pass
and removed after it, into

- ``preamble_ms``: ``evidence/extract.py::_chunk_preamble`` plus
  ``_pack_variant_tables`` (typed variant columns, fetch windows, the
  fetch filter);
- ``fetch_ms``: every shard handle's ``fetch_chunk``, the native
  ``svt_fetch_chunk`` (inflate, decode, the predicate pass);
- ``export_ms``: the ``export(...)`` callable that fetch returns, which
  copies the arena into the padded compact matrices;
- ``other_ms``: the wall less ``parts_ms``, the three parts summed over
  the shards: the rest (buffer allocation, the engine's bookkeeping)
  while the parts run one at a time, negative once concurrent shards'
  parts add up to more than the wall.

Beside them each chunk reports ``fetches`` (``fetch_chunk`` calls),
``fetch_union_ms`` (the wall during which at least one fetch ran, so
``fetch_ms / fetch_union_ms`` is the mean number in flight) and
``max_in_flight`` (the most parts timed at once: 1 when the shards ran
one after another).

Per (chunk size, shards) it reports the median and p90 of each part over
chunks, prep variants/s, reads and pairs, the native counters drained
around the timed pass (``bamio/native.py::perf_counters``: inflate wall
and CPU seconds, decode-worker seconds, blocks inflated, block-cache
hits, inflated bytes) and the host's usable cores. Then a cProfile of
three more passes at the first (chunk size, shards), unwrapped, top 25
by cumulative time, as the JAX script prints it.

``path="python"`` reproduces the JAX script on the port's host half:
the Python ``prepare_chunk`` over chunks of each size, the last padded
with None, timed and cProfiled.

    python -m svtyper_tpu_torch.tools.profile_prep [chunk ...]   # 1024 4096

Without a BAM/VCF pair it uses bench.py's simulated sample at 1,600
distinct events (the JAX script's ``v3_n1600_d30``), cached under
``build/tools/``.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
import threading
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.bamio import native
from svtyper_tpu_torch.bamio.bam import open_bam
from svtyper_tpu_torch.evidence import extract
from svtyper_tpu_torch.evidence.extract import prepare_chunk
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.stats import Sample
from svtyper_tpu_torch.tools import common
from svtyper_tpu_torch.tools.scaling_curve import device_lists
from svtyper_tpu_torch.utils import fixture

SIZES = (1024, 4096)
SHARDS = (1, 2)
N_EVENTS = 1600
PROFILE_PASSES = 3
TOP = 25
PARTS = ("preamble_ms", "fetch_ms", "export_ms", "other_ms")


class _Split:
    """Times the parts of each ``prepare_compact_chunk`` call from
    outside: wraps ``extract._chunk_preamble`` and
    ``extract._pack_variant_tables`` (module globals, called by global
    name) and each BAM handle's ``fetch_chunk`` (an instance attribute
    shadowing the method), and the ``export`` each fetch returns (never
    re-called: a second export after the next fetch would read an
    overwritten arena). Every wrapper returns what it wrapped returned;
    the wrappers may run on several prep threads at once."""

    def __init__(self, bams):
        self.bams = bams
        self._lock = threading.Lock()
        self._reset()

    def _reset(self):
        self.ms = dict.fromkeys(PARTS[:3], 0.0)
        self.fetch_spans = []
        self.in_flight = self.max_in_flight = 0

    def _timed(self, fn, part):
        def wrapper(*args, **kwargs):
            with self._lock:
                self.in_flight += 1
                self.max_in_flight = max(self.max_in_flight, self.in_flight)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.in_flight -= 1
                    self.ms[part] += (t1 - t0) * 1e3
                    if part == "fetch_ms":
                        self.fetch_spans.append((t0, t1))
        return wrapper

    def _fetch(self, fetch):
        timed = self._timed(fetch, "fetch_ms")

        def wrapper(*args, **kwargs):
            res = timed(*args, **kwargs)
            if res is None:
                return None
            return res[:-1] + (self._timed(res[-1], "export_ms"),)
        return wrapper

    def __enter__(self):
        self._orig = (extract._chunk_preamble, extract._pack_variant_tables)
        for bam in self.bams:
            common.check("fetch_chunk" not in vars(bam),
                         "a BAM handle's fetch_chunk is already wrapped")
        extract._chunk_preamble = self._timed(self._orig[0], "preamble_ms")
        extract._pack_variant_tables = self._timed(self._orig[1],
                                                   "preamble_ms")
        for bam in self.bams:
            bam.fetch_chunk = self._fetch(bam.fetch_chunk)
        return self

    def __exit__(self, *exc):
        extract._chunk_preamble, extract._pack_variant_tables = self._orig
        for bam in self.bams:
            del bam.fetch_chunk

    def removed(self) -> bool:
        """True once every wrapper is gone again."""
        return (extract._chunk_preamble is self._orig[0]
                and extract._pack_variant_tables is self._orig[1]
                and not any("fetch_chunk" in vars(b) for b in self.bams))

    def take(self, wall_ms: float) -> dict:
        """This chunk's parts (other = wall - their sum), its fetches
        and their union; resets them."""
        parts = sum(self.ms.values())
        out = dict(self.ms, parts_ms=parts, other_ms=wall_ms - parts,
                   fetches=len(self.fetch_spans),
                   fetch_union_ms=span_union(self.fetch_spans) * 1e3,
                   max_in_flight=self.max_in_flight)
        self._reset()
        return out


def span_union(spans) -> float:
    """The length of the union of ``(start, end)`` spans."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        total += max(t1 - max(t0, end), 0.0)
        end = max(end, t1)
    return total


def chunks_of(bps, size: int) -> List[list]:
    return [bps[lo:lo + size] for lo in range(0, len(bps), size)]


def _quantiles(rows: List[dict], keys) -> Tuple[dict, dict]:
    med = {k: float(np.median([r[k] for r in rows])) for k in keys}
    p90 = {k: float(np.percentile([r[k] for r in rows], 90)) for k in keys}
    return med, p90


def _cprofile(fn, passes: int = PROFILE_PASSES) -> str:
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(passes):
        fn()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(TOP)
    return s.getvalue()


def _fresh_sample(sample, bam: str):
    """``sample``'s library statistics on a new handle of ``bam``, with
    its own empty block cache (as the CLI's ``-l`` cache gives them)."""
    return Sample.from_lib_info(open_bam(bam),
                                {sample.name: sample.to_json_obj()})


def _native_pass(sample, bps, cs, devices):
    """One (chunk size, shards) run of the engine's host stage → (its
    result, one more unwrapped pass of the same engine)."""
    engine = TorchEngine([sample], chunk_size=cs, devices=devices)
    chunks = chunks_of(bps, engine.chunk_size)
    engine._prepare(chunks[0])  # warm: decoder caches, high-water pads
    for key in engine.stats:
        engine.stats[key] = 0
    native.perf_counters()  # drain what the warm-up left
    per_chunk = []
    bams = list({id(b): b for views in engine.shard_bams()
                 for b in views}.values())
    with _Split(bams) as split:
        for chunk in chunks:
            t0 = time.perf_counter()
            engine._prepare(chunk)
            wall = (time.perf_counter() - t0) * 1e3
            per_chunk.append(dict(split.take(wall), wall_ms=wall))
    counters = native.perf_counters()
    common.check(split.removed(), "a prep wrapper was left in place")
    st = engine.stats
    common.check(st["chunks"] == len(chunks), "chunk %d: %d chunks prepped "
                 "for %d" % (cs, st["chunks"], len(chunks)))
    common.check(st["classify_launches"] == st["gl_launches"] == 0,
                 "the device step ran")
    wall_s = sum(r["wall_ms"] for r in per_chunk) / 1e3
    med, p90 = _quantiles(per_chunk, ("wall_ms",) + PARTS + (
        "parts_ms", "fetch_union_ms"))
    return {
        "path": "native", "chunk_size": engine.chunk_size,
        "shards": len(devices), "cards": len(set(devices)),
        "chunks": len(chunks),
        "variants": len(bps), "reads": st["reads"], "pairs": st["pairs"],
        "wall_s": wall_s, "prep_variants_per_s": len(bps) / wall_s,
        "median": med, "p90": p90, "native": counters,
        "usable_cores": usable_cores(), "per_chunk": per_chunk,
    }, lambda: [engine._prepare(c) for c in chunks]


def _python_pass(sample, bps, cs):
    """The JAX script's loop: ``prepare_chunk`` per chunk, padded."""
    prepare_chunk(sample, bps[:cs])  # warm

    def one_pass():
        for chunk in chunks_of(bps, cs):
            if len(chunk) < cs:
                chunk = chunk + [None] * (cs - len(chunk))
            prepare_chunk(sample, chunk)

    t0 = time.perf_counter()
    one_pass()
    dt = time.perf_counter() - t0
    return {
        "path": "python", "chunk_size": cs, "chunks": -(-len(bps) // cs),
        "variants": len(bps), "wall_s": dt,
        "prep_variants_per_s": len(bps) / dt,
        "usable_cores": usable_cores(),
    }, one_pass


def usable_cores() -> int:
    return len(os.sched_getaffinity(0))


def run(
    bam: Optional[str] = None,
    vcf: Optional[str] = None,
    sizes: Iterable[int] = SIZES,
    shards: Iterable[int] = SHARDS,
    path: str = "native",
    device=None,
    emit=common.print_json,
) -> Tuple[List[dict], str]:
    """→ (one result per (chunk size, shards), or per chunk size on the
    Python path; the cProfile text of the first one's extra passes)."""
    if path not in ("native", "python"):
        raise ValueError("path is 'native' or 'python', not %r" % (path,))
    device = common.resolve_device(device)
    emit(dict(common.header("profile_prep", device), path=path,
              usable_cores=usable_cores()))
    if bam is None:
        bam, vcf = common.default_fixture(N_EVENTS)
    sample, bps = fixture.load_sample_and_breakpoints(bam, vcf)
    if path == "python":
        runs = (_python_pass(sample, bps, cs) for cs in sizes)
    else:
        # the BAM's first fetch builds its fine index (or loads the
        # sidecar) by inflating every block into that handle's cache:
        # do it here, so that each run's new handle starts cold
        getattr(sample.bam, "_get_fineidx", lambda: None)()
        runs = (_native_pass(_fresh_sample(sample, bam), bps, cs, devices)
                for cs in sizes for _, devices in device_lists(device, shards))
    results, profile = [], None
    for res, again in runs:
        results.append(res)
        emit(res)
        if profile is None:
            profile = _cprofile(again)
    return results, profile or ""


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv

    def go():
        _, profile = run(sizes=[int(a) for a in args] or SIZES)
        print(profile, flush=True)

    return common.run_main(go)


if __name__ == "__main__":
    sys.exit(main())
