"""Evidence classification of the compact wire: a hand-written CUDA
kernel and its plain version.

``classify_wire`` is the engine's classifier. On a CUDA wire it launches
``csrc/classify_kernel.cu``, which reads the seven matrices straight
from the shard's uint8 wire (a warp per variant segment of each table:
a 32-ary search finds its first row, 32-row tiles are loaded coalesced
and each column's rows added in row order through shared memory) and
writes the ``[n_var, 5]`` counts in one launch. On a CPU wire it runs the plain version,
``unwire`` and then ``evidence/device.py::classify_compact``, in float32
or float64. Any other device raises; there is no fallback from the
kernel to the plain version.

The kernel repeats the plain version's float32 operations in the same
order, with no multiply-add contraction, and sums each segment's rows in
row order from 0, as ``torch.segment_reduce`` does: its counts are
bit-identical to the plain version's, so the integer fields truncated
from them are too.

``wire_layout`` gives the byte offset, dtype and shape of each matrix of
a wire geometry (``gt/engine.py::pack_wire``); ``unwire`` and the kernel
both read the wire through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch

from svtyper_tpu_torch.evidence.device import _prob_mapq_table, classify_compact
from svtyper_tpu_torch.ops.gl_kernel import _check

# launches of the CUDA kernel in this process (the smoke reads it to
# show the main path went through the kernel)
LAUNCHES = 0

# the wire's matrices in extract.COMPACT_KEYS order, as the kernel takes
# them: (dtype, rows); a matrix's width is the geometry's
WIRE_MATRICES = (
    (np.dtype(np.uint16), 1),  # cr_u16: read → variant
    (np.dtype(np.uint8), 3),  # cr_u8: mapq, sa_mapq, flags
    (np.dtype(np.uint16), 1),  # cp_u16: pair → variant
    (np.dtype(np.int32), 1),  # cp_i32: ospan
    (np.dtype(np.uint8), 4),  # cp_u8: a_mapq, b_mapq, lib, flags
    (np.dtype(np.int32), 9),  # v_i32: extract.VARS_I32
    (np.dtype(np.uint8), 6),  # v_u8: extract.VARS_BOOL
)

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


@functools.lru_cache(maxsize=64)
def wire_layout(geom) -> Tuple[Tuple[int, np.dtype, tuple], ...]:
    """→ ``(byte offset, dtype, shape)`` of each matrix of a wire with
    geometry ``geom`` (``pack_wire``'s), back to back from byte 0; raises
    when a matrix would start off its element's alignment."""
    out = []
    off = 0
    for dt_str, shape in geom:
        dt = np.dtype(dt_str)
        if off % dt.itemsize:
            raise ValueError(
                "wire slice at byte %d is not aligned to %s" % (off, dt)
            )
        shape = tuple(int(s) for s in shape)
        out.append((off, dt, shape))
        off += int(np.prod(shape)) * dt.itemsize
    return tuple(out)


def wire_nbytes(geom) -> int:
    """The wire's length in bytes."""
    off, dt, shape = wire_layout(geom)[-1]
    return off + int(np.prod(shape)) * dt.itemsize


def unwire(wire: torch.Tensor, geom) -> List[torch.Tensor]:
    """One uint8 wire buffer → the seven packed matrices, as typed views
    of the buffer (uint16 matrices come back widened to int32)."""
    if wire.storage_offset() != 0:
        raise ValueError("the wire must start at its storage's first byte")
    parts = []
    for off, dt, shape in wire_layout(geom):
        nb = int(np.prod(shape)) * dt.itemsize
        arr = wire[off: off + nb].view(_VIEW[dt])
        if dt == np.uint16:
            arr = arr.to(torch.int32) & 0xFFFF
        parts.append(arr.reshape(shape))
    return parts


def wire_rows(wire: torch.Tensor, geom, key: int) -> torch.Tensor:
    """Matrix ``key`` (its index in extract.COMPACT_KEYS) of a uint8
    wire as a view, unwidened, with no device op."""
    off, dt, shape = wire_layout(geom)[key]
    nb = int(np.prod(shape)) * dt.itemsize
    return wire[off: off + nb].view(_VIEW[dt]).view(shape)


@functools.lru_cache(maxsize=64)
def _kernel_layout(geom):
    """→ (the offsets as 7 host int64, R, F, V) for the kernel; raises
    unless the geometry is the compact wire's."""
    layout = wire_layout(geom)
    if len(layout) != len(WIRE_MATRICES):
        raise ValueError("a compact wire has %d matrices, got %d"
                         % (len(WIRE_MATRICES), len(layout)))
    for (_, dt, shape), (want_dt, rows) in zip(layout, WIRE_MATRICES):
        if dt != want_dt or len(shape) != 2 or shape[0] != rows:
            raise ValueError("wire matrix %s %s, expected %s with %d rows"
                             % (dt, shape, want_dt, rows))
    r, f, v = layout[0][2][1], layout[2][2][1], layout[5][2][1]
    if layout[1][2][1] != r or layout[3][2][1] != f or layout[4][2][1] != f \
            or layout[6][2][1] != v:
        raise ValueError("wire matrices of one table differ in width")
    if wire_nbytes(geom) >= 2 ** 31:
        raise ValueError("wire of %d bytes: the kernel takes < 2 GiB"
                         % wire_nbytes(geom))
    offsets = np.asarray([off for off, _, _ in layout], dtype=np.int64)
    return offsets, r, f, v


def bind(lib: ctypes.CDLL):
    """``svt_classify_compact`` of a library built from
    ``csrc/classify_kernel.cu`` (or another version of it), with its C
    signature."""
    fn = lib.svt_classify_compact
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


@functools.lru_cache(maxsize=1)
def _entry():
    """``svt_classify_compact`` from the built library."""
    from svtyper_tpu_torch.ops._build import load

    return bind(load("classify_kernel"))


def classify_compact_cuda(
    wire: torch.Tensor, geom, dens: torch.Tensor, n_var: int, entry=None
) -> torch.Tensor:
    """Launch ``csrc/classify_kernel.cu`` on the current stream →
    counts [n_var, 5] float32, contiguous and 16-byte aligned. Takes the
    shard's uint8 wire (4-byte aligned) and ``dens`` [n_lib, W] float32,
    both contiguous on one CUDA device. ``entry`` is another build's
    bound ``svt_classify_compact`` (``tools/classify_bench.py``); the
    checkout's library by default."""
    global LAUNCHES
    dev = wire.device
    if dev.type != "cuda":
        raise ValueError("classify_compact_cuda needs CUDA tensors, got %s"
                         % dev)
    offsets, r, f, v = _kernel_layout(geom)
    # 4-byte aligned: the kernel reads the int32 matrices in place
    _check("wire", wire, torch.uint8, (wire_nbytes(geom),), dev, align=4)
    if dens.dim() != 2 or dens.shape[0] < 1 or dens.shape[1] < 1:
        raise ValueError("dens of shape %s, expected [n_lib >= 1, W >= 1]"
                         % (tuple(dens.shape),))
    _check("dens", dens, torch.float32, tuple(dens.shape), dev)
    if not 0 <= n_var <= v:
        raise ValueError("n_var %d outside the wire's %d variant columns"
                         % (n_var, v))
    counts = torch.empty((n_var, 5), dtype=torch.float32, device=dev)
    if n_var == 0:
        return counts
    table = _prob_mapq_table(dev, torch.float32)
    fn = _entry() if entry is None else entry
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            wire.data_ptr(), offsets.ctypes.data, r, f, v, n_var,
            dens.data_ptr(), dens.shape[0], dens.shape[1],
            table.data_ptr(), counts.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError("classify_kernel launch failed: cudaError %d" % rc)
    LAUNCHES += 1
    return counts


def classify_wire(
    wire: torch.Tensor, geom, dens: torch.Tensor, n_var: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """The engine's classifier → counts [n_var, 5]: the CUDA kernel for a
    CUDA wire (float32 only), ``unwire`` and the plain
    ``classify_compact`` for a CPU wire, an error for anything else."""
    kind = wire.device.type
    if kind == "cuda":
        if dtype != torch.float32:
            raise ValueError("the CUDA classify kernel is float32; got %s"
                             % dtype)
        return classify_compact_cuda(wire, geom, dens, n_var)
    if kind == "cpu":
        return classify_compact(*unwire(wire, geom), dens, n_var, dtype=dtype)
    raise ValueError("no classifier for device %s" % wire.device)
