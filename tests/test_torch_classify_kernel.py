"""The engine's classifier on the wire (``svtyper_tpu_torch.ops.
classify_kernel``) on the CPU.

- a numpy float32 model of ``csrc/classify_kernel.cu``, step for step:
  a warp per variant segment of each table, its first row found by the
  kernel's 32-ary ballot search, 32-row tiles whose lanes apply the
  kernel's per-row operations in its order, and each column's lanes
  added in order from 0, only the segment's rows. It is bit-identical to
  the plain ``classify_compact``, on the matrices and through the wire,
  on the synthetic chunk, the real chunk of ``test_torch_evidence.py``,
  an adversarial chunk (empty segments, mapq 0 and 255, ``LIB_INVALID``
  and libraries past the table, density indices outside ``[0, W)``,
  int32 wrap in ``ospan - vlen``, zero denominators) and the edge chunks
  (segments of 0, 1, 31-33, 63-65 and 2,049 rows, off the tile's
  alignment; 1, 3 and 5 variants; padding rows only). The counts are
  compared bit for bit because DP/RO/AO/QR/QA are truncations of them;
- the model's search equals ``np.searchsorted`` (left) for every
  variant of the edge chunks and of a 1,024-variant chunk's 180,000
  pair rows;
- ``wire_layout`` against ``unwire``'s views, and its refusals;
- ``classify_wire`` on the CPU against JAX's ``classify_compact`` in
  float32 and float64, exactly (the fixtures' mapq avoid 1-3; see
  ``test_torch_evidence.py``);
- the CUDA entry refusing CPU tensors, the engine's
  ``classify_launches`` and its place in ``SVT_CLI_STATS``;
- ``tools/classify_bench.py`` on the CPU: its source specs, its bound
  against a count of its own, the engine's chunks it times (the model
  bit-identical to ``classify_wire`` on them), and its refusal without
  CUDA;
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
from svtyper_tpu_torch.gt.engine import TorchEngine
from svtyper_tpu_torch.parallel.synth import make_synthetic_chunk
from svtyper_tpu_torch.tools import classify_bench, common
from svtyper_tpu_torch.utils import fixture
from svtyper_tpu_torch.utils.parity import (
    EDGE_SEGMENTS,
    adversarial_compact,
    edge_compacts,
)
from test_torch_evidence import real_chunk  # noqa: F401 (module fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
F32 = np.float32


LANES = 32  # the kernel's warp: a tile is 32 rows, one a lane
NO_VARIANT = 0x10000  # the variant of a lane past the table's end


def warp_search(a: np.ndarray, v: int) -> int:
    """The kernel's ``warp_lower_bound``, round by round: the first index
    of ``a`` (sorted) at or above ``v``, or ``len(a)``."""
    lanes = np.arange(LANES)
    lo, hi = 0, len(a)

    def ballot(q):
        ge = q >= hi
        ge[~ge] = a[q[~ge]].astype(np.int64) >= v
        return ge

    while hi - lo > LANES:
        step = (hi - lo + LANES - 1) // LANES
        ge = ballot(lo + (lanes + 1) * step - 1)
        if not ge.any():
            return hi
        b = int(np.argmax(ge))
        hi = min(lo + (b + 1) * step - 1, hi)
        lo += b * step
    ge = ballot(lo + lanes)
    return lo + int(np.argmax(ge)) if ge.any() else hi


def warp_walk(var: np.ndarray, v: int, contrib, ncols: int) -> np.ndarray:
    """One warp's walk of variant ``v``'s segment of a table: its first
    row by ``warp_search``, then tiles of 32 rows, lane l on row
    start + 32t + l; ``valid`` is the count of lanes on variant ``v`` (a
    prefix of the tile), ``contrib(rows, in_table)`` gives the 32 lanes'
    contributions [32, ncols] float32, and each column adds lanes
    0 .. valid-1 in order to its running sum, from 0. The walk ends at
    the first tile that is not all variant ``v``."""
    sums = np.zeros(ncols, dtype=F32)
    base = warp_search(var, v)
    while True:
        rows = base + np.arange(LANES)
        inside = rows < len(var)
        lane_var = np.full(LANES, NO_VARIANT, dtype=np.int64)
        lane_var[inside] = var[rows[inside]]
        mine = lane_var == v
        valid = int(mine.sum())
        assert mine[:valid].all(), "the segment's rows are not a prefix"
        if valid == 0:
            break
        c = contrib(np.where(inside, rows, 0), inside)
        for j in range(valid):
            sums = sums + c[j]  # float32 + float32: one rounding a column
        if valid < LANES:
            break
        base += LANES
    return sums


def kernel_model(wire: np.ndarray, geom, dens: np.ndarray, n_var: int):
    """csrc/classify_kernel.cu in numpy float32 → counts [n_var, 5]: for
    each variant a warp walks its read rows and one its pair rows
    (``warp_walk``), each lane computing its row's contribution with the
    kernel's per-row operations. Each numpy operation rounds once, as
    each __f*_rn intrinsic does."""
    layout = wire_layout(geom)

    def mat(k):
        off, dt, shape = layout[k]
        nb = int(np.prod(shape)) * dt.itemsize
        return wire[off: off + nb].view(dt).reshape(shape)

    r_var, cr8, p_var, cp32, cp8, v32, v8 = (mat(k) for k in range(7))
    r_var, p_var = r_var[0], p_var[0]
    table = PROB_MAPQ.astype(F32)
    n_lib, width = dens.shape

    def lanes(col, rows, inside):
        """A column's value in each lane; 0 past the table's end."""
        return np.where(inside, col[rows], 0)

    def read_contrib(rows, inside):
        rf = lanes(cr8[2], rows, inside)
        pm = table[lanes(cr8[0], rows, inside)]
        spm = table[lanes(cr8[1], rows, inside)]
        prim_first = (rf & 16) != 0
        l_pm = np.where(prim_first, pm, spm)
        r_pm = np.where(prim_first, spm, pm)
        lhit = np.where((rf & 4) != 0, F32(1), F32(0))
        rhit = np.where((rf & 8) != 0, F32(1), F32(0))
        return np.stack([
            np.where((rf & 1) != 0, pm, F32(0)),
            (l_pm * lhit + r_pm * rhit) * F32(0.5),
            np.where((rf & 2) != 0, pm, F32(0)),
        ], axis=1)

    def pair_contrib(v):
        vlen = v32[VARS_I32.index("vlen")][v]
        is_del = v8[VARS_BOOL.index("is_del")][v] != 0

        def contrib(rows, inside):
            pf = lanes(cp8[3], rows, inside)
            p_pair = (table[lanes(cp8[0], rows, inside)]
                      * table[lanes(cp8[1], rows, inside)])
            alt = (pf & 1) != 0
            alt_rec = (pf & 2) != 0
            ref_span_c = (pf >> 2).astype(F32) * p_pair * F32(0.5)
            lu8 = lanes(cp8[2], rows, inside)
            lib = np.where(lu8 == LIB_INVALID, -1, lu8.astype(np.int64))
            lib_safe = np.clip(lib, 0, n_lib - 1)
            ospan = lanes(cp32[0], rows, inside).astype(np.int32)

            def dens_at(x):
                ok = (x >= 0) & (x < width) & (lib >= 0)
                return np.where(ok, dens[lib_safe, np.clip(x, 0, width - 1)],
                                F32(0))

            d_conc = dens_at(ospan)
            d_disc = dens_at(np.subtract(ospan, vlen, dtype=np.int32))
            denom = F32(0.95) * d_conc + F32(0.05) * d_disc
            has_denom = denom > 0
            with np.errstate(divide="ignore", invalid="ignore"):
                p_conc = np.where(has_denom, (F32(0.95) * d_conc) / denom,
                                  F32(0))
            del_move = np.where(is_del & alt & has_denom,
                                (F32(1) - p_conc) * p_pair, F32(0))
            alt_span_c = (del_move + np.where(alt & ~is_del, p_pair, F32(0))
                          + np.where(alt_rec, p_pair, F32(0)))
            return np.stack([ref_span_c - del_move, alt_span_c], axis=1)

        return contrib

    out = np.zeros((n_var, 5), dtype=F32)
    for v in range(n_var):
        out[v, :3] = warp_walk(r_var, v, read_contrib, 3)
        out[v, 3:] = warp_walk(p_var, v, pair_contrib(v), 2)
    return out


EDGE = {name: (c, dens, n_var) for name, c, dens, n_var in edge_compacts()}


@pytest.fixture(params=["synthetic", "real", "adversarial",
                        *("edge: " + name for name in EDGE_SEGMENTS)])
def compact_case(request):
    """→ (compact matrices, dens float32, n_var)."""
    if request.param == "adversarial":
        return adversarial_compact()
    if request.param.startswith("edge: "):
        return EDGE[request.param[len("edge: "):]]
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
    # all zero exactly where no row is real (the padding-only edge chunk)
    real = (c["cr_u16"] < n_var).any() or (c["cp_u16"] < n_var).any()
    assert want.any() == real


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


def test_edge_chunks_are_what_they_say():
    """Each edge chunk's segments have the lengths ``EDGE_SEGMENTS``
    names, in variant order, each that starts past row 0 starting off a
    multiple of 32; padding rows follow at n_var."""
    for name, (c, dens, n_var) in EDGE.items():
        for key, lengths in zip(("cr_u16", "cp_u16"), EDGE_SEGMENTS[name]):
            var = c[key][0]
            got = np.bincount(var, minlength=n_var + 1)
            assert got[:n_var].tolist() == lengths, (name, key)
            assert 5 <= got[n_var] == len(var) - sum(lengths), (name, key)
            starts = np.cumsum([0] + lengths[:-1])
            assert (starts[starts > 0] % 32 != 0).all(), (name, key)
        assert n_var % 2 == 1  # 2·n_var warps: not a whole number of blocks
    lengths = {n for pair in EDGE_SEGMENTS.values() for t in pair for n in t}
    assert {0, 1, 31, 32, 33, 63, 64, 65} <= lengths
    assert max(lengths) > 2000


@pytest.mark.parametrize("name", list(EDGE_SEGMENTS))
def test_warp_search_matches_searchsorted(name):
    c, _, n_var = EDGE[name]
    for key in ("cr_u16", "cp_u16"):
        var = c[key][0]
        want = np.searchsorted(var, np.arange(n_var + 1), side="left")
        got = [warp_search(var, v) for v in range(n_var + 1)]
        assert got == want.tolist(), (name, key)


def test_warp_search_on_a_chunk_of_real_size():
    """~175 pair rows a variant, as a 30x sample's 1,024-variant chunk
    has, some segments empty, padding rows at n_var: several rounds."""
    rng = np.random.default_rng(11)
    n_var = 1024
    lengths = rng.poisson(175, n_var)
    lengths[rng.integers(0, n_var, 40)] = 0
    var = np.repeat(np.arange(n_var + 1),
                    np.append(lengths, 77)).astype(np.uint16)
    want = np.searchsorted(var, np.arange(n_var + 2), side="left")
    got = [warp_search(var, v) for v in range(n_var + 2)]
    assert got == want.tolist()
    assert warp_search(var[:0], 0) == 0


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


def test_classify_bench_source_specs():
    assert classify_bench.parse_source("this=") == (
        "this", classify_bench.THIS)
    assert classify_bench.parse_source("old=/a/b.cu") == ("old", "/a/b.cu")
    for bad in ("nolabel", "=x.cu", "v=/a/b.cu=X", "v==X"):
        with pytest.raises(common.ToolError, match="LABEL=PATH"):
            classify_bench.parse_source(bad)


def test_classify_bench_bound_counts_what_the_kernel_needs():
    """The bound's bytes, counted row by row: the real rows' columns the
    kernel reads, each variant's vlen, is_del and counts, each distinct
    density entry looked up, the table."""
    c, dens, n_var = adversarial_compact()
    n_lib, width = dens.shape
    vlen = c["v_i32"][VARS_I32.index("vlen")]
    reads = sum(1 for v in c["cr_u16"][0] if v < n_var)
    pairs, entries = 0, set()
    for v, ospan, lib in zip(c["cp_u16"][0], c["cp_i32"][0], c["cp_u8"][2]):
        if v >= n_var:
            continue
        pairs += 1
        disc = int(np.subtract(ospan, vlen[v], dtype=np.int32))
        for x in (int(ospan), disc):
            if 0 <= x < width and lib != LIB_INVALID:
                entries.add((min(int(lib), n_lib - 1), x))
    want = 5 * reads + 10 * pairs + 25 * n_var + 4 * len(entries) + 1024
    ms, by, nbytes = classify_bench.bound(c, n_var, dens)
    assert (nbytes, by) == (want, "bytes")
    assert ms == pytest.approx(want / 3.35e12 * 1e3)


def test_classify_bench_chunks_on_cpu():
    """The chunks the tool times are the engine's own: on the CPU, for
    each chunk of the example, the kernel model equals ``classify_wire``
    bit for bit, and ``chunk_stats`` counts its rows."""
    sample, bps = fixture.load_sample_and_breakpoints(
        os.path.join(DATA, "example.sim.sorted.bam"),
        os.path.join(DATA, "example.vcf"), num_samp=60000)
    eng = TorchEngine([sample], device="cpu", dtype=torch.float32,
                      chunk_size=4)
    dev = torch.device("cpu")
    dens = eng._dens_for(0, dev)
    n_chunks = 0
    for compact, w, geom, n_var in classify_bench.wires(eng, bps, dev):
        got = classify_wire(w, geom, dens, n_var, torch.float32)
        want = kernel_model(w.numpy(), geom, dens.numpy(), n_var)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
        st = classify_bench.chunk_stats(compact, n_var)
        assert st["reads"] == int((compact["cr_u16"] < n_var).sum())
        assert st["pairs"] == int((compact["cp_u16"] < n_var).sum()) > 0
        assert max(st["longest_segment"]) <= max(st["reads"], st["pairs"])
        n_chunks += 1
    eng.close()
    assert n_chunks == -(-len(bps) // 4) > 1


def test_classify_bench_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert classify_bench.main(["--source", "old=/nowhere.cu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


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
        *EDGE.values(),
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
