"""The engine's classifier on the wire (``svtyper_tpu_torch.ops.
classify_kernel``) on the CPU.

- a numpy float32 model of ``csrc/classify_kernel.cu`` (its per-row
  operations in its order, each segment found by binary search and
  summed row by row from 0) is bit-identical to the plain
  ``classify_compact``, on the matrices and through the wire, on the
  synthetic chunk, the real chunk of ``test_torch_evidence.py`` and an
  adversarial chunk (empty segments, mapq 0 and 255, ``LIB_INVALID`` and
  libraries past the table, density indices outside ``[0, W)``, int32
  wrap in ``ospan - vlen``, zero denominators). The counts are compared
  bit for bit because DP/RO/AO/QR/QA are truncations of them;
- ``wire_layout`` against ``unwire``'s views, and its refusals;
- ``classify_wire`` on the CPU against JAX's ``classify_compact`` in
  float32 and float64, exactly (the fixtures' mapq avoid 1-3; see
  ``test_torch_evidence.py``);
- the CUDA entry refusing CPU tensors, the engine's
  ``classify_launches`` and its place in ``SVT_CLI_STATS``;
- one ``cuda``-marked test of the kernel against the plain version on
  the card.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svtyper_tpu.evidence.device import classify_compact as jax_classify_compact
from svtyper_tpu_torch.cli import classic as tclassic
from svtyper_tpu_torch.evidence.device import PROB_MAPQ, classify_compact
from svtyper_tpu_torch.evidence.extract import (
    COMPACT_KEYS,
    LIB_INVALID,
    VARS_BOOL,
    VARS_I32,
    compact_chunk,
)
from svtyper_tpu_torch.gt.engine import pack_wire
from svtyper_tpu_torch.ops import classify_kernel
from svtyper_tpu_torch.ops.classify_kernel import (
    _kernel_layout,
    classify_compact_cuda,
    classify_wire,
    unwire,
    wire_layout,
    wire_nbytes,
    wire_rows,
)
from svtyper_tpu_torch.parallel.synth import make_synthetic_chunk
from test_torch_evidence import real_chunk  # noqa: F401 (module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
F32 = np.float32


def kernel_model(wire: np.ndarray, geom, dens: np.ndarray, n_var: int):
    """csrc/classify_kernel.cu in numpy float32 → counts [n_var, 5].
    Each numpy operation rounds once, as each __f*_rn intrinsic does."""
    layout = wire_layout(geom)

    def mat(k):
        off, dt, shape = layout[k]
        nb = int(np.prod(shape)) * dt.itemsize
        return wire[off: off + nb].view(dt).reshape(shape)

    r_var, cr8, p_var, cp32, cp8, v32, v8 = (mat(k) for k in range(7))
    r_var, p_var, ospan = r_var[0], p_var[0], cp32[0]
    table = PROB_MAPQ.astype(F32)
    n_lib, width = dens.shape

    # read rows
    pm, spm, rf = table[cr8[0]], table[cr8[1]], cr8[2]
    prim_first = (rf & 16) != 0
    l_pm = np.where(prim_first, pm, spm)
    r_pm = np.where(prim_first, spm, pm)
    lhit = np.where((rf & 4) != 0, F32(1), F32(0))
    rhit = np.where((rf & 8) != 0, F32(1), F32(0))
    read_c = np.stack([
        np.where((rf & 1) != 0, pm, F32(0)),
        (l_pm * lhit + r_pm * rhit) * F32(0.5),
        np.where((rf & 2) != 0, pm, F32(0)),
    ], axis=1)

    # pair rows (padding rows of the trash segment read variant 0; the
    # sums below never reach them)
    pv = np.where(p_var < n_var, p_var, 0)
    vlen = v32[VARS_I32.index("vlen")][pv]
    is_del = v8[VARS_BOOL.index("is_del")][pv] != 0
    pf = cp8[3]
    p_pair = table[cp8[0]] * table[cp8[1]]
    alt = (pf & 1) != 0
    alt_rec = (pf & 2) != 0
    ref_span_c = (pf >> 2).astype(F32) * p_pair * F32(0.5)
    lib = np.where(cp8[2] == LIB_INVALID, -1, cp8[2].astype(np.int64))
    lib_safe = np.clip(lib, 0, n_lib - 1)

    def dens_at(x):
        ok = (x >= 0) & (x < width) & (lib >= 0)
        return np.where(ok, dens[lib_safe, np.clip(x, 0, width - 1)], F32(0))

    d_conc = dens_at(ospan)
    d_disc = dens_at(np.subtract(ospan, vlen, dtype=np.int32))
    denom = F32(0.95) * d_conc + F32(0.05) * d_disc
    has_denom = denom > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        p_conc = np.where(has_denom, (F32(0.95) * d_conc) / denom, F32(0))
    del_move = np.where(is_del & alt & has_denom,
                        (F32(1) - p_conc) * p_pair, F32(0))
    alt_span_c = (del_move + np.where(alt & ~is_del, p_pair, F32(0))
                  + np.where(alt_rec, p_pair, F32(0)))
    pair_c = np.stack([ref_span_c - del_move, alt_span_c], axis=1)

    # one thread per variant: binary search for its rows, sum in order
    out = np.zeros((n_var, 5), dtype=F32)
    for col, rows, var in ((0, read_c, r_var), (3, pair_c, p_var)):
        first = np.searchsorted(var, np.arange(n_var + 1), side="left")
        for v in range(n_var):
            acc = np.zeros(rows.shape[1], dtype=F32)
            for i in range(first[v], first[v + 1]):
                acc = acc + rows[i]
            out[v, col: col + rows.shape[1]] = acc
    return out


def adversarial_compact(seed: int = 3, n_var: int = 40, n_reads: int = 704,
                        n_pairs: int = 500, n_lib: int = 3, width: int = 64):
    """Compact matrices and dens [n_lib, width] float32 that reach every
    branch of the kernel: empty segments (5, 6 and the last), padding
    rows at n_var, mapq 0 and 255, LIB_INVALID and a library past the
    table, spans below 0, at and past W, int32 wrap, zero densities."""
    rng = np.random.default_rng(seed)

    def var_column(n):
        var = rng.integers(0, n_var + 1, n)
        var[(var == 5) | (var == 6) | (var == n_var - 1)] = 7
        var[-n // 10:] = n_var
        return np.sort(var).astype(np.uint16)[None]

    def mapq(n):
        return rng.choice(np.asarray([0, 4, 20, 27, 40, 60, 254, 255],
                                     dtype=np.uint8), n)

    big = np.iinfo(np.int32)
    ospan = rng.integers(-8, width + 8, n_pairs).astype(np.int32)
    ospan[::17] = big.min
    ospan[::19] = big.max
    vlen = rng.integers(-width, width, n_var).astype(np.int32)
    vlen[::7] = big.max
    vlen[::11] = big.min
    v_i32 = rng.integers(-1000, 1000, (len(VARS_I32), n_var)).astype(np.int32)
    v_i32[VARS_I32.index("vlen")] = vlen
    dens = rng.random((n_lib, width)).astype(F32) * F32(0.01)
    dens[:, ::3] = 0  # zero denominators where both lookups land here
    dens[1] = 0
    compact = {
        "cr_u16": var_column(n_reads),
        "cr_u8": np.stack([mapq(n_reads), mapq(n_reads),
                           rng.integers(0, 32, n_reads).astype(np.uint8)]),
        "cp_u16": var_column(n_pairs),
        "cp_i32": ospan[None],
        "cp_u8": np.stack([
            mapq(n_pairs), mapq(n_pairs),
            rng.choice(np.asarray([0, 1, 2, n_lib, LIB_INVALID],
                                  dtype=np.uint8), n_pairs),
            rng.integers(0, 16, n_pairs).astype(np.uint8),
        ]),
        "v_i32": v_i32,
        "v_u8": rng.integers(0, 2, (len(VARS_BOOL), n_var)).astype(np.uint8),
    }
    return compact, dens, n_var


@pytest.fixture(params=["synthetic", "real", "adversarial"])
def compact_case(request):
    """→ (compact matrices, dens float32, n_var)."""
    if request.param == "adversarial":
        return adversarial_compact()
    if request.param == "synthetic":
        chunk, dens = make_synthetic_chunk(n_var=8, frags_per_var=6)
    else:
        chunk, dens = request.getfixturevalue("real_chunk")
    return (compact_chunk(chunk, min_aligned=20), dens.astype(F32),
            chunk.n_var)


def _mats(c):
    return [torch.from_numpy(np.ascontiguousarray(c[k])) for k in COMPACT_KEYS]


@pytest.mark.parametrize("route", ["matrices", "wire"])
def test_kernel_model_matches_plain(compact_case, route):
    c, dens, n_var = compact_case
    wire, geom = pack_wire(c)
    want = kernel_model(wire, geom, dens, n_var)
    d = torch.from_numpy(dens)
    if route == "matrices":
        got = classify_compact(*_mats(c), d, n_var, dtype=torch.float32)
    else:
        got = classify_wire(torch.from_numpy(wire), geom, d, n_var,
                            torch.float32)
    assert got.dtype == torch.float32 and got.shape == (n_var, 5)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert want.any()


def test_adversarial_chunk_reaches_every_branch():
    """The adversarial chunk is what its docstring says it is."""
    c, dens, n_var = adversarial_compact()
    var = c["cp_u16"][0]
    present = set(var.tolist())
    assert {5, 6, n_var - 1}.isdisjoint(present) and n_var in present
    assert {0, 255} <= set(c["cr_u8"][0].tolist())
    assert {LIB_INVALID, dens.shape[0]} <= set(c["cp_u8"][2].tolist())
    ospan = c["cp_i32"][0]
    assert (ospan < 0).any() and (ospan >= dens.shape[1]).any()
    counts = kernel_model(*pack_wire(c), dens, n_var)
    assert (counts[[5, 6, n_var - 1]] == 0).all()
    assert (counts[:, 3] < 0).any() or (counts[:, 3] == 0).any()


def _random_mats(r=384, f=96, v=10, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "cr_u16": rng.integers(0, 65535, (1, r), dtype=np.uint16),
        "cr_u8": rng.integers(0, 255, (3, r), dtype=np.uint8),
        "cp_u16": rng.integers(0, 65535, (1, f), dtype=np.uint16),
        "cp_i32": rng.integers(-2**31, 2**31 - 1, (1, f), dtype=np.int32),
        "cp_u8": rng.integers(0, 255, (4, f), dtype=np.uint8),
        "v_i32": rng.integers(-2**31, 2**31 - 1, (9, v), dtype=np.int32),
        "v_u8": rng.integers(0, 2, (6, v), dtype=np.uint8),
    }


def test_wire_layout_matches_unwire():
    mats = _random_mats()
    wire, geom = pack_wire(mats)
    layout = wire_layout(geom)
    assert wire_nbytes(geom) == wire.nbytes
    t = torch.from_numpy(wire)
    parts = unwire(t, geom)
    for k, (off, dt, shape), part in zip(COMPACT_KEYS, layout, parts):
        assert dt == mats[k].dtype and shape == mats[k].shape, k
        assert off % dt.itemsize == 0, k
        nb = int(np.prod(shape)) * dt.itemsize
        np.testing.assert_array_equal(
            wire[off: off + nb].view(dt).reshape(shape), mats[k], err_msg=k)
        np.testing.assert_array_equal(part.numpy().astype(np.int64),
                                      mats[k].astype(np.int64), err_msg=k)
        view = wire_rows(t, geom, COMPACT_KEYS.index(k))
        assert view.data_ptr() == t.data_ptr() + off, k
        np.testing.assert_array_equal(view.numpy().view(mats[k].dtype),
                                      mats[k], err_msg=k)
    offsets, r, f, v = _kernel_layout(geom)
    assert offsets.tolist() == [off for off, _, _ in layout]
    assert (r, f, v) == (384, 96, 10)


def test_wire_layout_refuses_misaligned():
    """An odd read count puts cp_u16 off its 2-byte alignment; a width
    that is not a multiple of 4 puts cp_i32 off its 4-byte one."""
    mats = _random_mats()
    for r in (383, 382):
        bad = dict(mats, cr_u16=mats["cr_u16"][:, :r],
                   cr_u8=mats["cr_u8"][:, :r])
        wire, geom = pack_wire(bad)
        with pytest.raises(ValueError, match="not aligned"):
            wire_layout(geom)
        with pytest.raises(ValueError, match="not aligned"):
            unwire(torch.from_numpy(wire), geom)


def test_kernel_layout_refuses_other_geometries():
    mats = _random_mats()
    for bad in (
        dict(mats, cr_u16=mats["cr_u16"].astype(np.int32)),
        dict(mats, cr_u8=mats["cr_u8"][:2]),
        dict(mats, cp_i32=mats["cp_i32"][:, :48]),
        dict(mats, v_u8=mats["v_u8"][:, :8]),
    ):
        with pytest.raises(ValueError):
            _kernel_layout(pack_wire(bad)[1])


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("which", ["synthetic", "real"])
def test_classify_wire_cpu_matches_jax(request, which, dt):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "f64": (torch.float64, jnp.float64)}[dt]
    if which == "synthetic":
        chunk, dens = make_synthetic_chunk(n_var=8, frags_per_var=6)
    else:
        chunk, dens = request.getfixturevalue("real_chunk")
    c = compact_chunk(chunk, min_aligned=20)
    want = np.asarray(jax_classify_compact(
        *(jnp.asarray(c[k]) for k in COMPACT_KEYS),
        jnp.asarray(dens, dtype=jdt), chunk.n_var, dtype=jdt,
    ))
    wire, geom = pack_wire(c)
    before = classify_kernel.LAUNCHES
    got = classify_wire(torch.from_numpy(wire), geom,
                        torch.tensor(dens, dtype=tdt), chunk.n_var, tdt)
    assert classify_kernel.LAUNCHES == before  # the CPU runs the plain one
    assert got.dtype == tdt and got.shape == (chunk.n_var, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_cuda_entry_refuses_cpu_tensors():
    c, dens, n_var = adversarial_compact()
    wire, geom = pack_wire(c)
    args = (torch.from_numpy(wire), geom, torch.from_numpy(dens), n_var)
    before = classify_kernel.LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA"):
        classify_compact_cuda(*args)
    with pytest.raises(ValueError, match="no classifier"):
        classify_wire(args[0].to("meta"), geom, args[2], n_var)
    assert classify_kernel.LAUNCHES == before


def test_engine_counts_classify_launches(tmp_path, monkeypatch):
    """On the CPU the engine launches no kernel and says so in
    ``SVT_CLI_STATS``, beside the GL count."""
    stats = tmp_path / "stats.json"
    monkeypatch.setenv("SVT_CLI_STATS", str(stats))
    argv = ["-i", os.path.join(DATA, "example.vcf"),
            "-B", os.path.join(DATA, "example.sim.sorted.bam"),
            "-n", "60000", "-o", str(tmp_path / "out.vcf")]
    assert tclassic.main(argv, device="cpu") == 0
    st = json.loads(stats.read_text())
    assert st["chunks"] >= 1
    assert st["classify_launches"] == st["gl_launches"] == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The kernel against the plain version on the card (the check of
    chip_smoke.py's classify phase), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for c, dens, n_var in (
        adversarial_compact(),
        adversarial_compact(seed=4, n_var=1024, n_reads=40_000,
                            n_pairs=20_000, width=1024),
    ):
        wire, geom = pack_wire(c)
        w = torch.from_numpy(wire).cuda()
        d = torch.from_numpy(dens).cuda()
        got = classify_compact_cuda(w, geom, d, n_var)
        torch.cuda.synchronize()
        want = classify_compact(*unwire(w, geom), d, n_var,
                                dtype=torch.float32)
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.cpu().numpy().view(np.int32))
