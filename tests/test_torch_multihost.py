"""The port's SVT_DIST_* multi-host mode on the CPU (gloo).

N processes of ``svtyper_tpu_torch.cli.classic.main(argv,
device="cpu")`` on localhost must write, on rank 0, output
byte-identical to one process of the port and to the JAX CLI in
float64 (the tests/test_multihost.py fixture), including the uneven
multi-round gather; ranks > 0 write nothing. Crash/resume and partial
part replay are the analogues of tests/test_checkpoint.py's multi-host
cases, through ``SVT_CRASH_AFTER_CHUNKS``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from svtyper_tpu_torch.cli import classic as tclassic
from svtyper_tpu_torch.parallel import multihost
from svtyper_tpu_torch.simulate import (
    Event,
    SimConfig,
    events_to_vcf,
    simulate_events,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = [("chr1", 6_000_000)]
TIMEOUT = 240

_MAIN = (
    "import sys; from svtyper_tpu_torch.cli.classic import main; "
    "sys.exit(main(sys.argv[1:], device='cpu'))"
)
_DIST_KEYS = ("SVT_DIST_COORD", "SVT_DIST_NPROCS", "SVT_DIST_PROCID",
              "SVT_CRASH_AFTER_CHUNKS")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    events = [
        Event(["DEL", "DUP", "INV"][i % 3], "chr1",
              200_000 + i * 250_000, 200_000 + i * 250_000 + 1200 + 83 * i,
              ["0/0", "0/1", "1/1"][i % 3], var_id="v%d" % i)
        for i in range(11)  # odd count: uneven shard slices
    ]
    bam = str(d / "mh.bam")
    simulate_events(bam, REFS, events, SimConfig(depth=25), seed=21,
                    extra_background=800)
    vcf = str(d / "mh.vcf")
    with open(vcf, "w") as fh:
        fh.write(events_to_vcf(events, REFS))
    return bam, vcf, d


def _read(p):
    with open(p, "rb") as fh:
        return fh.read()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single(bam, vcf, out, extra=()):
    """One process of the port, in this process."""
    assert tclassic.main(
        ["-i", vcf, "-B", bam, "-o", out, "-n", "20000", *extra],
        device="cpu",
    ) == 0
    return _read(out)


def _run_procs(bam, vcf, outs, extra=(), crash_after=None):
    """len(outs) ranks of the port's CLI → (return codes, stderr tails)."""
    port = _free_port()
    procs = []
    for i, out in enumerate(outs):
        env = {k: v for k, v in os.environ.items() if k not in _DIST_KEYS}
        env.update(
            PYTHONPATH=ROOT,
            OMP_NUM_THREADS="1",
            SVT_DIST_COORD="127.0.0.1:%d" % port,
            SVT_DIST_NPROCS=str(len(outs)),
            SVT_DIST_PROCID=str(i),
        )
        if crash_after is not None:
            env["SVT_CRASH_AFTER_CHUNKS"] = str(crash_after)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _MAIN, "-i", vcf, "-B", bam, "-o", out,
             "-n", "20000", *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    rcs, errs = [], []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            rcs.append(p.returncode)
            errs.append(err.decode()[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, errs


@pytest.fixture(scope="module")
def jax_reference(fixture):
    """The JAX CLI's float64 output, one process on one device."""
    bam, vcf, d = fixture
    out = str(d / "jax.vcf")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=ROOT)
    for k in _DIST_KEYS:
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-m", "svtyper_tpu.cli.classic",
         "-i", vcf, "-B", bam, "-o", out, "-n", "20000"],
        env=env, capture_output=True, timeout=TIMEOUT,
    )
    assert res.returncode == 0, res.stderr.decode()[-2000:]
    return _read(out)


@pytest.mark.parametrize(
    "n_procs,engine", [(2, "torch"), (4, "torch"), (2, "oracle")]
)
def test_multiprocess_byte_identical(fixture, jax_reference, n_procs,
                                     engine, tmp_path):
    bam, vcf, _ = fixture
    want = _single(bam, vcf, str(tmp_path / "single.vcf"))
    assert want and want == jax_reference
    outs = [str(tmp_path / ("mh_%d.vcf" % i)) for i in range(n_procs)]
    rcs, errs = _run_procs(bam, vcf, outs, ("--engine", engine))
    assert rcs == [0] * n_procs, errs
    assert _read(outs[0]) == want
    for o in outs[1:]:
        assert os.path.getsize(o) == 0  # non-zero ranks write nothing


def test_multiround_uneven_gather_byte_identical(fixture, tmp_path):
    """batch_size 5 over 11 variants and 2 ranks → slices [0,6)/[6,11)
    → 2 gather rounds on rank 0 vs 1 on rank 1: the shorter rank joins
    the second round with no rows, and rank 0's row reader stitches
    rows across (host, round) files (emission chunk 1 = vars 5-9
    straddles the host boundary)."""
    bam, vcf, _ = fixture
    args = ("--batch_size", "5")
    want = _single(bam, vcf, str(tmp_path / "single5.vcf"), args)
    outs = [str(tmp_path / ("mr_%d.vcf" % i)) for i in range(2)]
    rcs, errs = _run_procs(bam, vcf, outs, args)
    assert rcs == [0, 0], errs
    assert want and _read(outs[0]) == want
    assert os.path.getsize(outs[1]) == 0


def test_multihost_crash_resume(fixture, tmp_path):
    """A 2-rank run killed after one chunk per rank resumes from the
    spilled row parts, byte-identical to one process; spilled chunks
    are replayed, not recomputed."""
    bam, vcf, _ = fixture
    want = _single(bam, vcf, str(tmp_path / "single.vcf"))
    ck = str(tmp_path / "ck_mh")
    args = ("--batch_size", "3", "--checkpoint_dir", ck)
    outs1 = [str(tmp_path / ("crash_%d.vcf" % i)) for i in range(2)]
    rcs, errs = _run_procs(bam, vcf, outs1, args, crash_after=1)
    assert all(rc != 0 for rc in rcs), errs
    assert all("injected crash" in e for e in errs), errs
    rows = sorted(p for p in os.listdir(ck) if p.startswith("rows_"))
    assert any(p.startswith("rows_p000_") for p in rows), rows
    assert any(p.startswith("rows_p001_") for p in rows), rows
    mtimes = {p: os.path.getmtime(os.path.join(ck, p)) for p in rows}

    outs2 = [str(tmp_path / ("resume_%d.vcf" % i)) for i in range(2)]
    rcs, errs = _run_procs(bam, vcf, outs2, args)
    assert rcs == [0, 0], errs
    assert _read(outs2[0]) == want
    assert os.path.getsize(outs2[1]) == 0
    for p, m in mtimes.items():
        assert os.path.getmtime(os.path.join(ck, p)) == m, p


def test_multihost_partial_part_replay(fixture, tmp_path):
    """Rank 0's formatting replay with a middle part file missing: the
    gathered-row cursor must advance past replayed chunks."""
    bam, vcf, _ = fixture
    want = _single(bam, vcf, str(tmp_path / "single.vcf"))
    ck = str(tmp_path / "ck_pp")
    args = ("--batch_size", "3", "--checkpoint_dir", ck)
    outs1 = [str(tmp_path / ("full_%d.vcf" % i)) for i in range(2)]
    rcs, errs = _run_procs(bam, vcf, outs1, args)
    assert rcs == [0, 0], errs
    assert _read(outs1[0]) == want
    parts = sorted(p for p in os.listdir(ck) if p.endswith(".vcfpart"))
    assert len(parts) >= 3, parts
    os.unlink(os.path.join(ck, parts[1]))
    outs2 = [str(tmp_path / ("partial_%d.vcf" % i)) for i in range(2)]
    rcs, errs = _run_procs(bam, vcf, outs2, args)
    assert rcs == [0, 0], errs
    assert _read(outs2[0]) == want


def test_num_shards_refused_under_dist(fixture, tmp_path, monkeypatch):
    """--num_shards is manual sharding: refused before any process group
    is joined."""
    bam, vcf, _ = fixture
    monkeypatch.setenv("SVT_DIST_COORD", "127.0.0.1:%d" % _free_port())
    monkeypatch.setenv("SVT_DIST_NPROCS", "2")
    with pytest.raises(ValueError, match="num_shards"):
        tclassic.main(["-i", vcf, "-B", bam, "-o", str(tmp_path / "o.vcf"),
                       "-n", "20000", "--num_shards", "2"], device="cpu")


def test_single_process_fallbacks():
    """Unconfigured: initialize_from_env is (0, 1) and allgather_rows
    the identity, with no process group."""
    import torch.distributed as dist

    assert multihost.initialize_from_env() == (0, 1)
    assert not dist.is_initialized()
    rows = np.arange(12, dtype=np.float64).reshape(2, 1, 6)
    (got,) = multihost.allgather_rows(rows)
    assert got is rows
    multihost.destroy()  # no group: a no-op
