"""The output contract, checked against a real hall-lab/svtyper checkout
in one command.

Counterpart of ``scripts/run_reference_parity.sh``, with its three
lanes:

(a) the reference's bundled ``data/example.vcf`` and
    ``data/NA12878.target_loci.sorted.bam``, when the checkout has them;
(b) this repo's ``data/example.vcf`` and ``data/example.sim.sorted.bam``;
(c) the ``-l`` library JSON: the two schemas must agree key for key, so
    the caches are interchangeable (SURVEY.md §3.4).

The reference runs in a child process, ``python -m svtyper.classic``
with ``PYTHONPATH=<checkout>``: a real svtyper is Python 2-era code that
this process must not import. "Ours" in every lane is the port's CLI,
``classic.main``:

- ``cpu``: float64 on the CPU, and ``oracle``: ``--engine oracle``;
  both judged by ``tools/parity_diff.py``'s exact rule (GT, GL, GQ, SQ
  and QUAL as printed, the FORMAT header order). These are the lanes the
  JAX script runs on the CPU with ``JAX_ENABLE_X64``.
- ``cuda``, on a CUDA run only: the card's float32 CLI with the hand GL
  kernel, judged by the card's contract (PERF.md §2): the FORMAT header
  order as above, every integer field identical, GL/SQ/AB/QUAL within
  one unit of the last printed digit (``utils/parity.py::golden_diff``
  on the records). The kernel must run once per chunk.

``--mock`` builds a fake checkout whose ``svtyper/classic.py`` runs the
port's own oracle CLI, with jax and the JAX package refused, and gives
it the repo's example as its bundled data, so the whole chain (checkout,
reference run, every lane, the diffs, the exit code) runs without a
real svtyper. With no checkout named the locations that the shell
script probes are tried (read from its probe loop, so the two lists
cannot drift apart); with none found it prints "reference unavailable"
and exits 0, as the script does.

    python -m svtyper_tpu_torch.tools.reference_parity [REF | --mock] [workdir]

Exit code 0 when every lane passes, 1 otherwise. The default workdir is
``build/tools/reference_parity/``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from typing import List, Optional

from svtyper_tpu_torch.tools import common, parity_diff
from svtyper_tpu_torch.utils.parity import golden_diff

DATA = os.path.join(common.ROOT, "data")
SCRIPT = os.path.join(common.ROOT, "scripts", "run_reference_parity.sh")
WORKDIR = os.path.join(common.CACHE, "reference_parity")
REF_TIMEOUT_S = 3600

MOCK_CLASSIC = '''\
import sys

sys.path.insert(0, %(root)r)
from svtyper_tpu_torch.tools import RefuseJax

sys.meta_path.insert(0, RefuseJax())
from svtyper_tpu_torch.cli.classic import main as _main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return _main(argv + ["--engine", "oracle"], device="cpu")


if __name__ == "__main__":
    sys.exit(main())
'''


def probe_locations() -> List[str]:
    """The checkout locations the shell script tries, in its order."""
    try:
        with open(SCRIPT) as fh:
            for line in fh:
                m = re.match(r"\s*for cand in (.+); do\s*$", line)
                if m:
                    return m.group(1).split()
    except OSError:
        pass
    return []


def find_reference() -> Optional[str]:
    for cand in probe_locations():
        if (os.path.exists(os.path.join(cand, "svtyper", "classic.py"))
                or os.path.exists(os.path.join(cand, "setup.py"))):
            return cand
    return None


def _has_classic(ref: str) -> bool:
    return any("classic.py" in files for _, _, files in os.walk(ref))


def make_mock(path: str) -> str:
    """The fake checkout at ``path`` → ``path``."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(os.path.join(path, "svtyper"))
    os.makedirs(os.path.join(path, "data"))
    open(os.path.join(path, "svtyper", "__init__.py"), "w").close()
    with open(os.path.join(path, "svtyper", "classic.py"), "w") as fh:
        fh.write(MOCK_CLASSIC % {"root": common.ROOT})
    shutil.copy(os.path.join(DATA, "example.vcf"),
                os.path.join(path, "data", "example.vcf"))
    for ext in ("", ".bai"):
        shutil.copy(
            os.path.join(DATA, "example.sim.sorted.bam" + ext),
            os.path.join(path, "data", "NA12878.target_loci.sorted.bam" + ext))
    return path


def _lib_args(lib):
    """``-l lib`` for a run that must write ``lib``: an existing file is
    removed first, since the CLI reads an ``-l`` file that exists."""
    if lib is None:
        return []
    if os.path.exists(lib):
        os.remove(lib)
    return ["-l", lib]


def run_reference(ref: str, vcf: str, bam: str, out: str,
                  lib: Optional[str] = None) -> bool:
    res = subprocess.run(
        [sys.executable, "-m", "svtyper.classic", "-i", vcf, "-B", bam,
         "-o", out, *_lib_args(lib)],
        env=dict(os.environ, PYTHONPATH=ref), capture_output=True,
        text=True, timeout=REF_TIMEOUT_S,
    )
    if res.returncode != 0:
        print("reference svtyper exited %d:\n%s"
              % (res.returncode, res.stderr[-3000:]), flush=True)
    return res.returncode == 0


def run_ours(flavour: str, device: str, vcf: str, bam: str, out: str,
             lib: Optional[str], workdir: str) -> dict:
    """The port's CLI in this process → its run's facts."""
    from svtyper_tpu_torch.cli import classic

    argv = ["-i", vcf, "-B", bam, "-o", out, *_lib_args(lib)]
    if flavour == "oracle":
        argv += ["--engine", "oracle"]
    if flavour != "cuda":
        return {"rc": classic.main(argv, device="cpu")}
    stats = os.path.join(workdir, "stats_%s.json" % os.path.basename(out))
    os.environ["SVT_CLI_STATS"] = stats
    try:
        rc = classic.main(argv, device=device)
    finally:
        os.environ.pop("SVT_CLI_STATS", None)
    with open(stats) as fh:
        st = json.load(fh)
    common.check(st["classify_launches"] == st["gl_launches"] == st["chunks"]
                 > 0, "%s: %d classify and %d GL launches for %d chunks"
                 % (out, st["classify_launches"], st["gl_launches"],
                    st["chunks"]))
    return {"rc": rc, "chunks": st["chunks"], "gl_launches": st["gl_launches"]}


def card_diff(ref_out: str, ours_out: str, label: str) -> int:
    """The card's contract → 0 on a pass, 1 otherwise."""
    _, _, ref_h = parity_diff.load(ref_out)
    _, _, ours_h = parity_diff.load(ours_out)
    header_fails = parity_diff.diff_headers(ref_h, ours_h, label)

    def body(path):
        with open(path) as fh:
            return "".join(l for l in fh if not l.startswith("#"))

    identical, errors = golden_diff(body(ours_out), body(ref_out))
    n = body(ref_out).count("\n")
    ok = not errors and header_fails == 0
    print("%-16s %d records: %s" % (
        label, n, "PASS (%d byte-identical, the rest within one unit of the "
        "last printed digit)" % identical if ok else "; ".join(errors[:10])),
        flush=True)
    return 0 if ok else 1


def _shape(obj):
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__


def compare_lib(ref_lib: str, ours_lib: str, label: str) -> int:
    with open(ref_lib) as a, open(ours_lib) as b:
        sa, sb = _shape(json.load(a)), _shape(json.load(b))
    if sa == sb:
        print("PASS lib-json %s: schemas identical" % label, flush=True)
        return 0
    print("FAIL lib-json %s: schema mismatch" % label)
    print(" reference:", json.dumps(sa)[:400])
    print(" ours:     ", json.dumps(sb)[:400], flush=True)
    return 1


def run(
    ref: Optional[str] = None,
    workdir: Optional[str] = None,
    device=None,
    mock: bool = False,
    emit=common.print_json,
) -> dict:
    """Every lane → ``{"ok", "reference", "lanes": [...]}``; ``ok`` is
    True with no lanes when no reference is found."""
    device = common.resolve_device(device)
    emit(common.header("reference_parity", device))
    workdir = workdir or WORKDIR
    os.makedirs(workdir, exist_ok=True)
    if mock:
        ref = make_mock(os.path.join(workdir, "mockref"))
        print("MOCK MODE: the port's oracle CLI standing in as the "
              "reference binary", flush=True)
    elif ref is None:
        ref = find_reference()
    if ref is None or not os.path.exists(ref) or not _has_classic(ref):
        common.note("reference unavailable: no svtyper checkout found\n"
                    "usage: python -m svtyper_tpu_torch.tools."
                    "reference_parity /path/to/hall-lab-svtyper [workdir]")
        return {"ok": True, "reference": None, "lanes": []}
    print("reference: %s\nworkdir:   %s" % (ref, workdir), flush=True)
    flavours = ["cpu", "oracle"] + (["cuda"] if common.is_cuda(device) else [])
    lanes = []

    def lane(name, vcf, bam, lib):
        ref_out = os.path.join(workdir, "ref_%s.vcf" % name)
        ref_lib = os.path.join(workdir, "ref_%s.json" % name) if lib else None
        ref_ok = run_reference(ref, vcf, bam, ref_out, ref_lib)
        for fl in flavours:
            out = os.path.join(workdir, "ours_%s_%s.vcf" % (fl, name))
            ours_lib = (os.path.join(workdir, "ours_%s_%s.json" % (fl, name))
                        if lib else None)
            facts = run_ours(fl, device, vcf, bam, out, ours_lib, workdir)
            label = "%s/%s" % (name, fl)
            if not (ref_ok and facts["rc"] == 0):
                rc = 1
            elif lib:
                rc = compare_lib(ref_lib, ours_lib, label)
            elif fl == "cuda":
                rc = card_diff(ref_out, out, label)
            else:
                rc = parity_diff.main([ref_out, out, label])
            lanes.append(dict(facts, lane=name, flavour=fl, ok=rc == 0,
                              rule="schema" if lib else
                              "card" if fl == "cuda" else "exact"))

    ref_vcf = os.path.join(ref, "data", "example.vcf")
    ref_bam = os.path.join(ref, "data", "NA12878.target_loci.sorted.bam")
    if os.path.isfile(ref_vcf) and os.path.isfile(ref_bam):
        print("== reference bundled data ==", flush=True)
        lane("bundled", ref_vcf, ref_bam, lib=False)
    else:
        print("note: reference data/ not found; skipping bundled-data lane")
    ex_vcf = os.path.join(DATA, "example.vcf")
    ex_bam = os.path.join(DATA, "example.sim.sorted.bam")
    print("== synthesized regression fixture ==", flush=True)
    lane("sim", ex_vcf, ex_bam, lib=False)
    print("== -l lib-stats JSON schema ==", flush=True)
    lane("lib", ex_vcf, ex_bam, lib=True)
    ok = all(l["ok"] for l in lanes)
    print("\nPARITY: %s" % ("all lanes passed" if ok else
                            "mismatches found — see %s" % workdir),
          flush=True)
    out = {"ok": ok, "reference": ref, "mock": mock, "lanes": lanes}
    emit(out)
    return out


def main(argv=None, device=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    mock = bool(args) and args[0] == "--mock"
    ref = args[0] if args and not mock else None
    result = {}
    rc = common.run_main(lambda: result.update(
        run(ref, args[1] if len(args) > 1 else None, device=device,
            mock=mock)))
    return rc or (0 if result["ok"] else 1)


if __name__ == "__main__":
    sys.exit(main())
