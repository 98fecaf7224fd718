"""ctypes bindings for the C++ BAM decoder (``_native/bamcore.cpp``).

The port's copy of ``svtyper_tpu/bamio/native.py``. It builds its own
``libsvtbam.so`` from its own ``_native/bamcore.cpp`` with make at first
use, into ``build/svtyper_tpu_torch/`` at the repository root (beside
the CUDA kernels, ``ops/_build.py``), and rebuilds it when the source is
newer. Processes that start together build it once: the build holds a
file lock, writes a temporary name and moves it into place. The JAX
package's library is a separate file; each is opened with ``RTLD_LOCAL``,
so the two keep separate state in one process.

Every entry point degrades to the pure-Python decoder when the build or
load fails, as the JAX package's does; :func:`require_lib` is the
refusal for callers that must not (a CUDA run, where the pure-Python
decoder would be ~100x slower without any other sign).
"""

from __future__ import annotations

import ctypes as C
import fcntl
import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from svtyper_tpu_torch.bamio.columns import ReadBatch
from svtyper_tpu_torch.ops._build import BUILD_DIR

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
_SO = os.path.join(BUILD_DIR, "libsvtbam.so")
_lock = threading.Lock()
_lib = None
_load_failed = False
_why = None  # why the library did not load, for require_lib()

# ABI contract with bamcore.cpp's svt_abi_version(): a stale .so whose
# existing entry points changed signature would bind cleanly and be
# called with the new argtypes (silent memory corruption) — the version
# check refuses it and drops to pure Python instead (advisor, r4).
# Bump IN LOCKSTEP with bamcore.cpp whenever any signature changes.
_ABI_EXPECTED = 8


class _Cols(C.Structure):
    _fields_ = [
        ("tid", C.POINTER(C.c_int32)),
        ("pos", C.POINTER(C.c_int32)),
        ("ref_end", C.POINTER(C.c_int32)),
        ("flag", C.POINTER(C.c_uint16)),
        ("mapq", C.POINTER(C.c_uint8)),
        ("tlen", C.POINTER(C.c_int32)),
        ("mate_tid", C.POINTER(C.c_int32)),
        ("mate_pos", C.POINTER(C.c_int32)),
        ("qname_hash", C.POINTER(C.c_uint64)),
        ("left_soft", C.POINTER(C.c_int32)),
        ("right_soft", C.POINTER(C.c_int32)),
        ("ref_aln_len", C.POINTER(C.c_int32)),
        ("query_len", C.POINTER(C.c_int32)),
        ("lead_clip_q", C.POINTER(C.c_int32)),
        ("lib_id", C.POINTER(C.c_int32)),
        ("has_sa", C.POINTER(C.c_uint8)),
        ("sa_tid", C.POINTER(C.c_int32)),
        ("sa_pos", C.POINTER(C.c_int32)),
        ("sa_end", C.POINTER(C.c_int32)),
        ("sa_is_reverse", C.POINTER(C.c_uint8)),
        ("sa_mapq", C.POINTER(C.c_uint8)),
        ("sa_lead_clip_q", C.POINTER(C.c_int32)),
        ("voffset", C.POINTER(C.c_uint64)),
        ("cov_a", C.POINTER(C.c_uint8)),
        ("cov_b", C.POINTER(C.c_uint8)),
        ("blk_off", C.POINTER(C.c_int64)),
        ("blk_start", C.POINTER(C.c_int32)),
        ("blk_end", C.POINTER(C.c_int32)),
    ]


def _stale() -> bool:
    cpp = os.path.join(_DIR, "bamcore.cpp")
    return not os.path.exists(_SO) or (
        os.path.exists(cpp) and os.path.getmtime(cpp) > os.path.getmtime(_SO)
    )


def _build() -> bool:
    """Build ``_SO`` if it is missing or stale; False (with ``_why``
    set) when the build fails. Holds a lock file across processes, so
    one builds while the others wait, and moves a finished build into
    place, so no process loads a half-written library."""
    global _why
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(_SO + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _stale():
                return True
            tmp = "%s.%d.tmp" % (_SO, os.getpid())
            res = subprocess.run(
                ["make", "-s", "OUT=" + tmp, tmp],
                cwd=_DIR, capture_output=True, text=True, timeout=300,
            )
            if res.returncode != 0:
                _why = "make exit %d: %s" % (
                    res.returncode, (res.stderr or res.stdout)[-2000:])
                return False
            os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        _why = "%s: %s" % (type(exc).__name__, exc)
        return False


def get_lib():
    """The loaded native library, or None (Python fallback)."""
    global _lib, _load_failed, _why
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        # rebuild when missing OR stale: loading a pre-update .so would
        # miss newly bound symbols below, raise AttributeError, and
        # silently drop every run to the pure-Python decoder
        if _stale() and not _build():
            # a rebuild failure (no compiler on a deploy host, clock-
            # scrambled mtimes after git operations) must not discard a
            # loadable — merely stale — .so: the per-symbol hasattr
            # guards below already degrade missing NEW entry points
            # gracefully, and pure Python is a large silent perf cliff
            if not os.path.exists(_SO):
                _load_failed = True
                return None
            import sys

            sys.stderr.write(
                "svtyper_tpu_torch: native rebuild failed; loading existing "
                "(possibly stale) %s\n" % _SO
            )
        try:
            lib = C.CDLL(_SO)
        except OSError as exc:
            _load_failed = True
            _why = "cannot load %s: %s" % (_SO, exc)
            import sys

            sys.stderr.write(
                "svtyper_tpu_torch: native decoder unavailable, falling "
                "back to the pure-Python BAM decoder (slower)\n"
            )
            return None
        # ABI gate BEFORE binding anything: a pre-ABI artifact (no
        # version symbol) or a mismatched version means existing entry
        # points may have changed signature under us — pure Python is
        # slow but correct; a wrong-argtypes call is neither.
        try:
            lib.svt_abi_version.restype = C.c_int32
            lib.svt_abi_version.argtypes = []
            abi = int(lib.svt_abi_version())
        except AttributeError:
            abi = -1
        if abi != _ABI_EXPECTED:
            _load_failed = True
            _why = "%s has ABI %d, expected %d" % (_SO, abi, _ABI_EXPECTED)
            import sys

            sys.stderr.write(
                "svtyper_tpu_torch: native library ABI %d != expected %d "
                "(stale %s and rebuild failed?); falling back to the "
                "pure-Python BAM decoder (slower)\n"
                % (abi, _ABI_EXPECTED, _SO)
            )
            return None
        try:
            lib.svt_open.restype = C.c_void_p
            lib.svt_open.argtypes = [C.c_char_p]
            lib.svt_close.argtypes = [C.c_void_p]
            lib.svt_error.restype = C.c_char_p
            lib.svt_error.argtypes = [C.c_void_p]
        except AttributeError:
            # not even the v1 surface: unusable artifact
            _load_failed = True
            _why = "%s lacks the v1 entry points" % _SO
            return None
        try:
            _bind_extended(lib)
        except AttributeError as exc:
            import sys

            sys.stderr.write(
                "svtyper_tpu_torch: stale native library (%s); newer entry "
                "points disabled until rebuilt\n" % exc
            )
        _lib = lib
        return _lib


def require_lib():
    """The loaded native library; raises ``RuntimeError`` with the
    reason when it did not build or load (no pure-Python fallback)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "the native BAM decoder %s did not build or load (%s); "
            "refusing the pure-Python decoder on a CUDA run"
            % (_SO, _why or "unknown reason")
        )
    return lib


def _bind_extended(lib) -> None:
    """Bind post-v1 entry points ONE SYMBOL AT A TIME: a stale .so
    missing some symbols keeps every present symbol fully bound
    (restype + argtypes), so hasattr-guarded callers never call a
    present-but-unbound function with default C conversions
    (review finding, r4)."""
    try:
            lib.svt_set_names.restype = None
            lib.svt_set_names.argtypes = [
                C.c_void_p,
                C.POINTER(C.c_char_p), C.c_int32,
                C.POINTER(C.c_char_p), C.c_int32,
            ]
    except AttributeError:
        pass
    try:
            lib.svt_fetch_many.restype = C.c_long
            lib.svt_fetch_many.argtypes = [
                C.c_void_p,
                C.c_int64,
                C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.POINTER(C.c_int64),
                C.POINTER(C.c_uint64), C.POINTER(C.c_uint64),
                # filter block: drop_flags, rg_keep, rg_to_lib, n_rg_tab,
                # cov_tid_a, cov_pos_a, cov_tid_b, cov_pos_b, min_aligned,
                # want_blocks
                C.c_int32,
                C.POINTER(C.c_uint8), C.POINTER(C.c_int32), C.c_int32,
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.c_int32, C.c_int32,
                C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.POINTER(C.c_uint64),
                C.c_int64, C.c_int64,
                C.POINTER(_Cols), C.POINTER(C.c_int32), C.POINTER(C.c_int64),
                C.POINTER(C.c_int64),
            ]
    except AttributeError:
        pass
    try:
            lib.svt_build_fineidx.restype = C.c_long
            lib.svt_build_fineidx.argtypes = [
                C.c_void_p, C.c_uint64, C.c_int32, C.c_int32,
                C.POINTER(C.c_int64), C.POINTER(C.c_uint64),
            ]
    except AttributeError:
        pass
    try:
            lib.svt_fetch_chunk.restype = C.c_long
            lib.svt_fetch_chunk.argtypes = [
                C.c_void_p, C.c_int64,
                C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.POINTER(C.c_int64),
                C.POINTER(C.c_uint64), C.POINTER(C.c_uint64),
                C.POINTER(C.c_int32),
                C.c_int32,
                C.POINTER(C.c_uint8), C.POINTER(C.c_int32), C.c_int32,
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.c_int32, C.c_int64, C.c_int32,
                # compact predicate tables (NULL → flags not computed)
                C.POINTER(C.c_int32), C.POINTER(C.c_uint8), C.c_int64,
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                C.POINTER(C.c_uint8), C.POINTER(C.c_int64),
                C.POINTER(C.c_int64),
            ]
    except AttributeError:
        pass
    try:
            lib.svt_chunk_export.restype = C.c_long
            lib.svt_chunk_export.argtypes = [
                C.c_void_p,
                C.POINTER(C.c_int32), C.POINTER(C.c_uint8), C.c_int64,
                C.POINTER(C.c_int32), C.POINTER(C.c_int16), C.POINTER(C.c_uint8),
                C.c_int64,
            ]
    except AttributeError:
        pass
    try:
            lib.svt_chunk_export_compact.restype = C.c_long
            lib.svt_chunk_export_compact.argtypes = [
                C.c_void_p,
                C.POINTER(C.c_uint16), C.POINTER(C.c_uint8), C.c_int64,
                C.POINTER(C.c_uint16), C.POINTER(C.c_int32), C.POINTER(C.c_uint8),
                C.c_int64,
            ]
    except AttributeError:
        pass
    try:
            lib.svt_decode.restype = C.c_long
            lib.svt_decode.argtypes = [
                C.c_void_p,
                C.c_uint64, C.c_uint64, C.c_int64,
                C.c_int32, C.c_int64, C.c_int64,
                C.c_int32,
                C.POINTER(C.c_char_p), C.c_int32,
                C.POINTER(C.c_char_p), C.c_int32,
                C.c_int64, C.c_int64,
                C.POINTER(_Cols),
                C.POINTER(C.c_uint64),
                C.POINTER(C.c_int64),
                C.POINTER(C.c_int64),
            ]
    except AttributeError:
        pass
    try:
            lib.svt_set_evidence.restype = None
            lib.svt_set_evidence.argtypes = [C.c_void_p, C.c_int32]
    except AttributeError:
        pass
    try:
            lib.svt_chunk_evidence_count.restype = C.c_long
            lib.svt_chunk_evidence_count.argtypes = [C.c_void_p]
    except AttributeError:
        pass
    try:
            lib.svt_chunk_export_evidence.restype = C.c_long
            lib.svt_chunk_export_evidence.argtypes = [
                C.c_void_p,
                C.POINTER(C.c_int32), C.POINTER(C.c_int32),
                C.POINTER(C.c_int32), C.POINTER(C.c_int32),
                C.POINTER(C.c_uint64),
            ]
    except AttributeError:
        pass
    try:
            lib.svt_perf.restype = None
            lib.svt_perf.argtypes = [C.POINTER(C.c_int64)]
    except AttributeError:
        pass
    try:
            lib.svt_inflate_roofline.restype = C.c_int64
            lib.svt_inflate_roofline.argtypes = [
                C.c_void_p, C.c_int64, C.c_int32,
                C.POINTER(C.c_int64), C.POINTER(C.c_int64),
            ]
    except AttributeError:
        pass


def perf_counters() -> dict:
    """Drain the native perf counters: inflate wall-seconds, blocks
    inflated, worker wall-seconds (summed across decode threads),
    block-cache hits, bytes actually inflated (cache hits excluded)."""
    lib = get_lib()
    if lib is None:
        return {"inflate_s": 0.0, "blocks": 0, "worker_s": 0.0,
                "cache_hits": 0, "inflate_bytes": 0, "inflate_cpu_s": 0.0}
    out = (C.c_int64 * 6)()
    lib.svt_perf(out)
    return {
        "inflate_s": out[0] / 1e9,
        "blocks": int(out[1]),
        "worker_s": out[2] / 1e9,
        "cache_hits": int(out[3]),
        "inflate_bytes": int(out[4]),
        "inflate_cpu_s": out[5] / 1e9,
    }


_COL_DTYPES = [
    ("tid", np.int32), ("pos", np.int32), ("ref_end", np.int32),
    ("flag", np.uint16), ("mapq", np.uint8), ("tlen", np.int32),
    ("mate_tid", np.int32), ("mate_pos", np.int32),
    ("qname_hash", np.uint64), ("left_soft", np.int32),
    ("right_soft", np.int32), ("ref_aln_len", np.int32),
    ("query_len", np.int32), ("lead_clip_q", np.int32),
    ("lib_id", np.int32), ("has_sa", np.uint8), ("sa_tid", np.int32),
    ("sa_pos", np.int32), ("sa_end", np.int32), ("sa_is_reverse", np.uint8),
    ("sa_mapq", np.uint8), ("sa_lead_clip_q", np.int32),
    ("voffset", np.uint64), ("cov_a", np.uint8), ("cov_b", np.uint8),
]


class FetchFilter:
    """In-core fetch filtering + derived features (bamcore fetch_many).

    ``rg_keep``/``rg_to_lib`` are [n_rg+1] tables (slot n_rg = no-RG
    reads); ``cov_*`` are per-REGION breakpoint coords for the §4.1
    aligned-coverage predicate (int64, tid -1 disables a side).
    """

    __slots__ = ("drop_flags", "rg_keep", "rg_to_lib", "cov_tid_a",
                 "cov_pos_a", "cov_tid_b", "cov_pos_b", "min_aligned",
                 "want_blocks")

    def __init__(
        self,
        drop_flags: int = 0,
        rg_keep: Optional[np.ndarray] = None,
        rg_to_lib: Optional[np.ndarray] = None,
        cov_tid_a: Optional[np.ndarray] = None,
        cov_pos_a: Optional[np.ndarray] = None,
        cov_tid_b: Optional[np.ndarray] = None,
        cov_pos_b: Optional[np.ndarray] = None,
        min_aligned: int = 20,
        want_blocks: bool = False,
    ) -> None:
        self.drop_flags = drop_flags
        self.rg_keep = rg_keep
        self.rg_to_lib = rg_to_lib
        self.cov_tid_a = cov_tid_a
        self.cov_pos_a = cov_pos_a
        self.cov_tid_b = cov_tid_b
        self.cov_pos_b = cov_pos_b
        self.min_aligned = min_aligned
        self.want_blocks = want_blocks

    def slice(self, q0: int, q1: int) -> "FetchFilter":
        """Per-query arrays restricted to [q0, q1) (thread partitions)."""
        out = FetchFilter(self.drop_flags, self.rg_keep, self.rg_to_lib,
                          min_aligned=self.min_aligned,
                          want_blocks=self.want_blocks)
        for f in ("cov_tid_a", "cov_pos_a", "cov_tid_b", "cov_pos_b"):
            arr = getattr(self, f)
            setattr(out, f, arr[q0:q1] if arr is not None else None)
        return out

    def slice_take(self, idx: np.ndarray) -> "FetchFilter":
        """Per-query arrays gathered by ``idx`` (region→query remap)."""
        out = FetchFilter(self.drop_flags, self.rg_keep, self.rg_to_lib,
                          min_aligned=self.min_aligned,
                          want_blocks=self.want_blocks)
        for f in ("cov_tid_a", "cov_pos_a", "cov_tid_b", "cov_pos_b"):
            arr = getattr(self, f)
            setattr(
                out, f,
                np.ascontiguousarray(arr[idx]) if arr is not None else None,
            )
        return out


def _char_pp(strings: List[str]):
    arr = (C.c_char_p * max(len(strings), 1))()
    for i, s in enumerate(strings):
        arr[i] = s.encode()
    return arr


class _BufSet:
    """Grow-only output buffers + prebuilt Cols struct for one thread."""

    __slots__ = ("cap", "bufs", "cols", "qid", "blk_off", "blk_start",
                 "blk_end")

    def __init__(self) -> None:
        self.cap = 0
        self.bufs = None
        self.cols = None
        self.qid = None
        self.blk_off = None
        self.blk_start = None
        self.blk_end = None

    def ensure(self, cap: int) -> None:
        if cap <= self.cap:
            return
        self.bufs = {name: np.empty(cap, dtype=dt) for name, dt in _COL_DTYPES}
        self.qid = np.empty(cap, dtype=np.int32)
        self.blk_off = np.empty(cap + 1, dtype=np.int64)
        self.blk_start = np.empty(cap * 2, dtype=np.int32)
        self.blk_end = np.empty(cap * 2, dtype=np.int32)
        cols = _Cols()
        for (name, _dt), (fname, ftype) in zip(_COL_DTYPES, _Cols._fields_):
            setattr(cols, fname, self.bufs[name].ctypes.data_as(ftype))
        cols.blk_off = self.blk_off.ctypes.data_as(C.POINTER(C.c_int64))
        cols.blk_start = self.blk_start.ctypes.data_as(C.POINTER(C.c_int32))
        cols.blk_end = self.blk_end.ctypes.data_as(C.POINTER(C.c_int32))
        self.cols = cols
        self.cap = cap


class NativeBam:
    """One opened BAM in the native core (compressed bytes live in C++)."""

    def __init__(self, path: str, ref_names: List[str], rg_names: List[str]):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native bamcore unavailable")
        self._lib = lib
        self._h = lib.svt_open(path.encode())
        if not self._h:
            raise IOError("svt_open failed: %s" % path)
        self._refs = _char_pp(ref_names)
        self._n_ref = len(ref_names)
        self._rgs = _char_pp(rg_names)
        self._n_rg = len(rg_names)
        lib.svt_set_names(self._h, self._refs, self._n_ref, self._rgs,
                          self._n_rg)
        # persistent grow-only buffer sets, one list per CALLING
        # thread (threading.local): transient fetch_many batches alias
        # these buffers, and the streaming CLI runs evidence collection
        # (-w, main thread) concurrently with chunk prep (prep thread)
        # on the same handle — per-thread slots make that safe with no
        # locking (review finding, r4). Within one call, threads>1
        # fans out over slots of the calling thread's own list.
        self._tls = threading.local()
        # diagnostic: total records touched by fetch_many (the scanned vs
        # emitted ratio exposes BAI linear-index skip overhead)
        self.scanned = 0

    @property
    def _bufsets(self) -> List[_BufSet]:
        bs = getattr(self._tls, "bufsets", None)
        if bs is None:
            bs = self._tls.bufsets = [_BufSet()]
        return bs

    # back-compat shims for the single-threaded decode path
    @property
    def _cap(self):
        return self._bufsets[0].cap

    @property
    def _bufs(self):
        return self._bufsets[0].bufs

    @property
    def _cols(self):
        return self._bufsets[0].cols

    @property
    def _qid(self):
        return self._bufsets[0].qid

    @property
    def _blk_off(self):
        return self._bufsets[0].blk_off

    @property
    def _blk_start(self):
        return self._bufsets[0].blk_start

    @property
    def _blk_end(self):
        return self._bufsets[0].blk_end

    def _ensure_bufs(self, cap: int) -> None:
        self._bufsets[0].ensure(cap)

    def _fetch_slice(
        self,
        bs: _BufSet,
        rt: np.ndarray,
        rs: np.ndarray,
        re_: np.ndarray,
        ro: np.ndarray,
        rb: np.ndarray,
        rn: np.ndarray,
        cap_hint: int,
        filt: Optional[FetchFilter] = None,
        copy: bool = True,
    ) -> Tuple[ReadBatch, np.ndarray]:
        """``copy=False`` returns views into this bufset's buffers —
        valid only until its next fetch; used by the threaded path where
        ReadBatch.concat immediately materializes a private copy."""
        q = len(rt)
        io_q = C.c_int64(0)
        io_r = C.c_int64(0)
        io_v = C.c_uint64(2**64 - 1)
        nrows = C.c_int64(0)
        nscan = C.c_int64(0)
        parts: List[Dict[str, np.ndarray]] = []
        qids: List[np.ndarray] = []
        cap = max(bs.cap, cap_hint, 1024)

        def i64p(a):
            return (
                a.ctypes.data_as(C.POINTER(C.c_int64))
                if a is not None
                else None
            )

        if filt is not None:
            drop_flags = filt.drop_flags
            rg_keep = (
                filt.rg_keep.ctypes.data_as(C.POINTER(C.c_uint8))
                if filt.rg_keep is not None
                else None
            )
            rg_to_lib = (
                filt.rg_to_lib.ctypes.data_as(C.POINTER(C.c_int32))
                if filt.rg_to_lib is not None
                else None
            )
            n_rg_tab = (
                len(filt.rg_to_lib) - 1 if filt.rg_to_lib is not None
                else (len(filt.rg_keep) - 1 if filt.rg_keep is not None else 0)
            )
            cta, cpa = i64p(filt.cov_tid_a), i64p(filt.cov_pos_a)
            ctb, cpb = i64p(filt.cov_tid_b), i64p(filt.cov_pos_b)
            min_aligned = filt.min_aligned
            want_blocks = 1 if filt.want_blocks else 0
        else:
            drop_flags = 0
            rg_keep = rg_to_lib = None
            n_rg_tab = 0
            cta = cpa = ctb = cpb = None
            min_aligned = 0
            want_blocks = 1
        while True:
            bs.ensure(cap)
            n = self._lib.svt_fetch_many(
                self._h, q,
                rt.ctypes.data_as(C.POINTER(C.c_int64)),
                rs.ctypes.data_as(C.POINTER(C.c_int64)),
                re_.ctypes.data_as(C.POINTER(C.c_int64)),
                ro.ctypes.data_as(C.POINTER(C.c_int64)),
                rb.ctypes.data_as(C.POINTER(C.c_uint64)),
                rn.ctypes.data_as(C.POINTER(C.c_uint64)),
                drop_flags, rg_keep, rg_to_lib, n_rg_tab,
                cta, cpa, ctb, cpb, min_aligned, want_blocks,
                C.byref(io_q), C.byref(io_r), C.byref(io_v),
                bs.cap, bs.cap * 2,
                C.byref(bs.cols),
                bs.qid.ctypes.data_as(C.POINTER(C.c_int32)),
                C.byref(nrows),
                C.byref(nscan),
            )
            self.scanned += int(nscan.value)
            if n == -1:
                raise ValueError(
                    self._lib.svt_error(self._h).decode() or "fetch error"
                )
            rows = int(nrows.value)
            # capacity-retry parts always copy: the resume loop replaces
            # the buffers (ensure grows), but equal-cap reuse would alias
            part_copy = copy or n == -2
            d = {
                name: (
                    bs.bufs[name][:rows].copy()
                    if part_copy
                    else bs.bufs[name][:rows]
                )
                for name, _ in _COL_DTYPES
            }
            if want_blocks:
                nblk = int(bs.blk_off[rows])
                d["blk_off"] = bs.blk_off[: rows + 1].copy()
                d["blk_start"] = bs.blk_start[:nblk].copy()
                d["blk_end"] = bs.blk_end[:nblk].copy()
            parts.append(d)
            qids.append(
                bs.qid[:rows].copy() if part_copy else bs.qid[:rows]
            )
            if n != -2:
                break
            cap = bs.cap * 2
        if len(parts) == 1:
            return ReadBatch.from_columns(parts[0]), qids[0]
        batch = ReadBatch.concat([ReadBatch.from_columns(p) for p in parts])
        return batch, np.concatenate(qids)

    def fetch_many(
        self,
        region_tid: np.ndarray,
        region_start: np.ndarray,
        region_end: np.ndarray,
        range_off: np.ndarray,
        range_beg: np.ndarray,
        range_end: np.ndarray,
        cap_hint: int = 1 << 16,
        threads: int = 1,
        filt: Optional[FetchFilter] = None,
        transient: bool = False,
    ) -> Tuple[ReadBatch, np.ndarray]:
        """Batched multi-region fetch → (batch, query_id per row).

        ``threads > 1`` splits the query list into contiguous slices
        decoded concurrently (the C call releases the GIL; the handle is
        read-only, each slice gets its own buffer set) and re-concatenated
        in query order — output identical to the single-thread path.

        ``transient=True`` lets the result alias this handle's reusable
        decode buffers (valid only until the next fetch on this handle) —
        callers that immediately repack rows, like evidence.extract, skip
        one full copy of every column.
        """
        rt = np.ascontiguousarray(region_tid, dtype=np.int64)
        rs = np.ascontiguousarray(region_start, dtype=np.int64)
        re_ = np.ascontiguousarray(region_end, dtype=np.int64)
        ro = np.ascontiguousarray(range_off, dtype=np.int64)
        rb = np.ascontiguousarray(range_beg, dtype=np.uint64)
        rn = np.ascontiguousarray(range_end, dtype=np.uint64)
        q = len(rt)
        if threads <= 1 or q < 2 * threads:
            return self._fetch_slice(
                self._bufsets[0], rt, rs, re_, ro, rb, rn, cap_hint, filt,
                copy=not transient,
            )
        bufsets = self._bufsets  # the CALLING thread's slot list
        while len(bufsets) < threads:
            bufsets.append(_BufSet())
        # contiguous query partitions balanced by range count
        bounds = [0]
        total = int(ro[-1])
        for t in range(1, threads):
            bounds.append(int(np.searchsorted(ro, total * t // threads)))
        bounds.append(q)

        from concurrent.futures import ThreadPoolExecutor

        def work(t: int):
            q0, q1 = bounds[t], bounds[t + 1]
            if q0 >= q1:
                return ReadBatch(0), np.zeros(0, dtype=np.int32)
            r0, r1 = int(ro[q0]), int(ro[q1])
            batch, qid = self._fetch_slice(
                bufsets[t],
                rt[q0:q1], rs[q0:q1], re_[q0:q1],
                np.ascontiguousarray(ro[q0 : q1 + 1] - ro[q0]),
                rb[r0:r1], rn[r0:r1],
                max(cap_hint // threads, 1024),
                filt.slice(q0, q1) if filt is not None else None,
                copy=not transient,
            )
            return batch, qid + q0

        with ThreadPoolExecutor(max_workers=threads) as ex:
            results = list(ex.map(work, range(threads)))
        batches = [b for b, _ in results if b.n]
        qids = [i for (b, i) in results if b.n]
        if not batches:
            return ReadBatch(0), np.zeros(0, dtype=np.int32)
        return ReadBatch.concat(batches), np.concatenate(qids)

    def fetch_chunk(
        self,
        region_tid: np.ndarray,
        region_start: np.ndarray,
        region_end: np.ndarray,
        range_off: np.ndarray,
        range_beg: np.ndarray,
        range_end: np.ndarray,
        var_of_query: np.ndarray,
        n_var: int,
        filt: "FetchFilter",
        max_reads: Optional[int] = None,
        threads: int = 1,
        vpred: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> Tuple[int, int, np.ndarray, np.ndarray]:
        """Decode + full device-chunk layout in C++ (bamcore
        svt_fetch_chunk): candidate-read selection, multi-window dedup,
        fragment pairing and max_reads capping all happen inside the
        decode pass. Returns ``(n_cand, n_pair, var_over, var_rows)``;
        copy the tables out with :meth:`chunk_export`.

        ``vpred = (v_i32 [9, n_var], v_u8 [6, n_var])`` additionally
        evaluates the compact-wire predicates at emission (GIL-free,
        inside the decode threads); copy them out with
        :meth:`chunk_export_compact`.
        """
        rt = np.ascontiguousarray(region_tid, dtype=np.int64)
        rs = np.ascontiguousarray(region_start, dtype=np.int64)
        re_ = np.ascontiguousarray(region_end, dtype=np.int64)
        ro = np.ascontiguousarray(range_off, dtype=np.int64)
        rb = np.ascontiguousarray(range_beg, dtype=np.uint64)
        rn = np.ascontiguousarray(range_end, dtype=np.uint64)
        vq = np.ascontiguousarray(var_of_query, dtype=np.int32)

        def i64p(a):
            return (
                a.ctypes.data_as(C.POINTER(C.c_int64))
                if a is not None
                else None
            )

        rg_keep = (
            filt.rg_keep.ctypes.data_as(C.POINTER(C.c_uint8))
            if filt.rg_keep is not None
            else None
        )
        rg_to_lib = (
            filt.rg_to_lib.ctypes.data_as(C.POINTER(C.c_int32))
            if filt.rg_to_lib is not None
            else None
        )
        n_rg_tab = (
            len(filt.rg_to_lib) - 1 if filt.rg_to_lib is not None
            else (len(filt.rg_keep) - 1 if filt.rg_keep is not None else 0)
        )
        n_cand = C.c_int64(0)
        n_pair = C.c_int64(0)
        nscan = C.c_int64(0)
        var_over = np.zeros(n_var, dtype=np.uint8)
        var_rows = np.zeros(n_var, dtype=np.int64)
        if vpred is not None:
            v_i32, v_u8 = vpred
            assert v_i32.flags.c_contiguous and v_u8.flags.c_contiguous
            vp_i32 = v_i32.ctypes.data_as(C.POINTER(C.c_int32))
            vp_u8 = v_u8.ctypes.data_as(C.POINTER(C.c_uint8))
            vp_stride = v_i32.shape[1]
        else:
            vp_i32 = vp_u8 = None
            vp_stride = 0
        rc = self._lib.svt_fetch_chunk(
            self._h, len(rt),
            i64p(rt), i64p(rs), i64p(re_), i64p(ro),
            rb.ctypes.data_as(C.POINTER(C.c_uint64)),
            rn.ctypes.data_as(C.POINTER(C.c_uint64)),
            vq.ctypes.data_as(C.POINTER(C.c_int32)),
            filt.drop_flags, rg_keep, rg_to_lib, n_rg_tab,
            i64p(filt.cov_tid_a), i64p(filt.cov_pos_a),
            i64p(filt.cov_tid_b), i64p(filt.cov_pos_b),
            filt.min_aligned,
            -1 if max_reads is None else int(max_reads),
            max(int(threads), 1),
            vp_i32, vp_u8, vp_stride,
            C.byref(n_cand), C.byref(n_pair),
            var_over.ctypes.data_as(C.POINTER(C.c_uint8)),
            var_rows.ctypes.data_as(C.POINTER(C.c_int64)),
            C.byref(nscan),
        )
        self.scanned += int(nscan.value)
        if rc == -1:
            raise ValueError(
                self._lib.svt_error(self._h).decode() or "fetch_chunk error"
            )
        return int(n_cand.value), int(n_pair.value), var_over, var_rows

    def chunk_export(
        self,
        r_i32: np.ndarray,
        r_u8: np.ndarray,
        p_i32: np.ndarray,
        p_i16: np.ndarray,
        p_u8: np.ndarray,
    ) -> None:
        """Copy the last fetch_chunk's tables into padded matrices
        (strides = padded row length; caller owns padding rows)."""
        assert r_i32.flags.c_contiguous and p_i32.flags.c_contiguous
        self._lib.svt_chunk_export(
            self._h,
            r_i32.ctypes.data_as(C.POINTER(C.c_int32)),
            r_u8.ctypes.data_as(C.POINTER(C.c_uint8)),
            r_i32.shape[1],
            p_i32.ctypes.data_as(C.POINTER(C.c_int32)),
            p_i16.ctypes.data_as(C.POINTER(C.c_int16)),
            p_u8.ctypes.data_as(C.POINTER(C.c_uint8)),
            p_i32.shape[1],
        )

    def chunk_export_compact(
        self,
        cr_u16: np.ndarray,
        cr_u8: np.ndarray,
        cp_u16: np.ndarray,
        cp_i32: np.ndarray,
        cp_u8: np.ndarray,
    ) -> None:
        """Copy the last fetch_chunk's compact-wire tables (requires the
        fetch to have run with ``vpred``) into padded matrices."""
        assert cr_u8.flags.c_contiguous and cp_u8.flags.c_contiguous
        rc = self._lib.svt_chunk_export_compact(
            self._h,
            cr_u16.ctypes.data_as(C.POINTER(C.c_uint16)),
            cr_u8.ctypes.data_as(C.POINTER(C.c_uint8)),
            cr_u8.shape[1],
            cp_u16.ctypes.data_as(C.POINTER(C.c_uint16)),
            cp_i32.ctypes.data_as(C.POINTER(C.c_int32)),
            cp_u8.ctypes.data_as(C.POINTER(C.c_uint8)),
            cp_u8.shape[1],
        )
        if rc == -1:
            raise ValueError(
                self._lib.svt_error(self._h).decode()
                or "chunk_export_compact error"
            )

    def set_evidence(self, on: bool) -> None:
        """Record every kept row's (tid,pos,end,flag,voffset) during
        subsequent fetch_chunk calls (the -w evidence export)."""
        if hasattr(self._lib, "svt_set_evidence"):
            self._lib.svt_set_evidence(self._h, 1 if on else 0)

    def chunk_evidence(self):
        """Rows recorded by the LAST evidence-mode fetch_chunk, or
        None when the entry points are unavailable."""
        if not hasattr(self._lib, "svt_chunk_export_evidence"):
            return None
        n = int(self._lib.svt_chunk_evidence_count(self._h))
        tid = np.empty(n, np.int32)
        pos = np.empty(n, np.int32)
        end = np.empty(n, np.int32)
        flag = np.empty(n, np.int32)
        vo = np.empty(n, np.uint64)
        if n:
            self._lib.svt_chunk_export_evidence(
                self._h,
                tid.ctypes.data_as(C.POINTER(C.c_int32)),
                pos.ctypes.data_as(C.POINTER(C.c_int32)),
                end.ctypes.data_as(C.POINTER(C.c_int32)),
                flag.ctypes.data_as(C.POINTER(C.c_int32)),
                vo.ctypes.data_as(C.POINTER(C.c_uint64)),
            )
        return tid, pos, end, flag, vo

    def inflate_roofline(
        self, max_blocks: int = -1, retain: bool = False
    ) -> Optional[dict]:
        """Single-thread bare-inflate bandwidth over this file's BGZF
        blocks (cache bypassed): the host's inflate speed-of-light for
        the cold-path bound (bench.py reports achieved/roofline).
        ``retain=True`` keeps every inflated block live — the block
        cache's true allocation pattern, i.e. the FAIR roofline
        including the kernel's first-touch page tax."""
        if not hasattr(self._lib, "svt_inflate_roofline"):
            return None
        comp = C.c_int64(0)
        ns = C.c_int64(0)
        inflated = int(
            self._lib.svt_inflate_roofline(
                self._h, max_blocks, 1 if retain else 0,
                C.byref(comp), C.byref(ns)
            )
        )
        if inflated < 0:
            return None
        secs = ns.value / 1e9
        return {
            "inflated_bytes": inflated,
            "compressed_bytes": int(comp.value),
            "wall_s": secs,
            "bytes_per_s": inflated / secs if secs > 0 else 0.0,
        }

    def build_fineidx(
        self, body_voffset: int, g_shift: int, ref_lens: List[int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One header-only pass → (slot_off[n_ref+1], vo[total_slots]).

        ``vo[slot_off[tid] + (pos >> g_shift)]`` = voffset of the first
        record overlapping that interval (UINT64_MAX where none starts
        the interval; caller backward-fills).
        """
        n_ref = len(ref_lens)
        g = 1 << g_shift
        nslots = np.asarray(
            [(L + g - 1) >> g_shift for L in ref_lens], dtype=np.int64
        )
        slot_off = np.zeros(n_ref + 1, dtype=np.int64)
        np.cumsum(nslots, out=slot_off[1:])
        vo = np.full(int(slot_off[-1]), 2**64 - 1, dtype=np.uint64)
        rc = self._lib.svt_build_fineidx(
            self._h, body_voffset, g_shift, n_ref,
            slot_off.ctypes.data_as(C.POINTER(C.c_int64)),
            vo.ctypes.data_as(C.POINTER(C.c_uint64)),
        )
        if rc == -1:
            raise ValueError(
                self._lib.svt_error(self._h).decode() or "fineidx error"
            )
        return slot_off, vo

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.svt_close(h)
            self._h = None

    def decode(
        self,
        start_voffset: int,
        stop_voffset: Optional[int] = None,
        max_records: Optional[int] = None,
        region: Optional[Tuple[int, int, int]] = None,
        keep_unmapped: bool = False,
        cap_hint: int = 4096,
    ) -> Tuple[ReadBatch, int]:
        """Mirror of ``records.decode_stream`` (same outputs)."""
        batch, seen, _ = self.decode_resumable(
            start_voffset, stop_voffset, max_records, region, keep_unmapped,
            cap_hint,
        )
        return batch, seen

    def decode_resumable(
        self,
        start_voffset: int,
        stop_voffset: Optional[int] = None,
        max_records: Optional[int] = None,
        region: Optional[Tuple[int, int, int]] = None,
        keep_unmapped: bool = False,
        cap_hint: int = 4096,
    ) -> Tuple[ReadBatch, int, Optional[int]]:
        """Like decode(), plus the next voffset (None at EOF)."""
        parts: List[Dict[str, np.ndarray]] = []
        seen_total = 0
        vo = start_voffset
        cap = max(self._cap, cap_hint, 256)
        remaining = max_records
        next_vo = C.c_uint64(0)
        while True:
            self._ensure_bufs(cap)
            seen = C.c_int64(0)
            nrows = C.c_int64(0)
            rtid, rlo, rhi = region if region is not None else (-1, 0, 0)
            n = self._lib.svt_decode(
                self._h,
                vo,
                stop_voffset if stop_voffset is not None else 2**64 - 1,
                remaining if remaining is not None else -1,
                rtid, rlo, rhi,
                1 if keep_unmapped else 0,
                self._refs, self._n_ref,
                self._rgs, self._n_rg,
                self._cap, self._cap * 2,
                C.byref(self._cols),
                C.byref(next_vo),
                C.byref(seen),
                C.byref(nrows),
            )
            if n == -1:
                raise ValueError(
                    self._lib.svt_error(self._h).decode() or "decode error"
                )
            rows = int(nrows.value)
            d = {name: self._bufs[name][:rows].copy()
                 for name, _ in _COL_DTYPES}
            nblk = int(self._blk_off[rows])
            d["blk_off"] = self._blk_off[: rows + 1].copy()
            d["blk_start"] = self._blk_start[:nblk].copy()
            d["blk_end"] = self._blk_end[:nblk].copy()
            parts.append(d)
            seen_total += int(seen.value)
            if n != -2:
                break
            vo = int(next_vo.value)
            if remaining is not None:
                remaining -= int(seen.value)
                if remaining <= 0:
                    break
            cap = self._cap * 2
        if len(parts) == 1:
            batch = ReadBatch.from_columns(parts[0])
        else:
            batch = ReadBatch.concat(
                [ReadBatch.from_columns(p) for p in parts]
            )
        final_vo = int(next_vo.value)
        return batch, seen_total, None if final_vo == 2**64 - 1 else final_vo
