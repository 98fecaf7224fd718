"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/svtyper_tpu_torch/``
at the repository root, at first use, then loaded with ctypes. A
library is rebuilt when its source is newer. There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "svtyper_tpu_torch")

# -fmad=false: no multiply-add contraction anywhere in the file, so
# every product and sum rounds on its own as PyTorch's eager ops do;
# -Xptxas -v: each kernel's registers, shared memory and spills (PTXAS)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_locks = {}  # one lock per library: two libraries build side by side
_libs = {}
# library path → ptxas's register, memory and spill lines, for each
# library this process built
PTXAS = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "svtyper_tpu_torch are built from source at first use"
    )


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` → ``BUILD_DIR/lib<name>.so`` if the
    library is missing or older than its source; returns its path."""
    return build_source(os.path.join(CSRC, name + ".cu"),
                        os.path.join(BUILD_DIR, "lib%s.so" % name))


def build_source(src: str, so: str) -> str:
    """Compile the CUDA source ``src`` with ``NVCC_FLAGS`` → the library
    ``so``, unless it exists and is newer than ``src``; returns ``so``."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    res = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        raise RuntimeError(
            "nvcc failed to build %s (exit %d):\n%s%s"
            % (src, res.returncode, res.stdout, res.stderr)
        )
    os.replace(tmp, so)
    PTXAS[so] = [ln.split(":", 1)[-1].strip() if "ptxas info" in ln
                 else ln.strip()
                 for ln in (res.stdout + res.stderr).splitlines()
                 if "Used" in ln or "spill" in ln]
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def warm(name: str, device: int) -> None:
    """Loads the kernel module of ``csrc/<name>.cu`` onto CUDA device
    ``device`` without launching it (its ``svt_warm``), creating the
    card's primary context if none exists; raises on a CUDA error."""
    fn = load(name).svt_warm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    rc = fn(device)
    if rc != 0:
        raise RuntimeError("%s: svt_warm(%d) failed: cudaError %d"
                           % (name, device, rc))
