"""What the tools share: device choice without fallback, the run header,
the cached simulated fixture, memory samples and the flat-memory rule."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from svtyper_tpu_torch.utils import fixture

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, "build", "tools")
NATIVE = "native libsvtbam.so"  # fixture.decoder_name() of the C++ decoder
DRIFT_LIMIT = 0.10


class ToolError(RuntimeError):
    """A failed check: the tool's command exits non-zero."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise ToolError(msg)


def print_json(obj) -> None:
    print(json.dumps(obj), flush=True)


def note(msg: str) -> None:
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def resolve_device(device) -> str:
    """The device a tool runs on: CUDA unless the caller names one; no
    CUDA device and none named is an error, never a CPU run."""
    if device is not None:
        return str(device)
    if not torch.cuda.is_available():
        raise ToolError(
            "no CUDA device (torch.cuda.is_available() is False); the CPU "
            "runs only when a caller passes device='cpu'"
        )
    return "cuda"


def is_cuda(device: str) -> bool:
    return torch.device(device).type == "cuda"


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def header(tool: str, device: str, reads_bam: bool = True) -> dict:
    """The run's first line: tool, device, card and BAM decoder. On CUDA
    a tool that reads a BAM refuses the pure-Python decoder, which runs
    about 100x slower without any other sign."""
    dec = fixture.decoder_name()
    out = {"tool": tool, "device": device, "decoder": dec}
    if is_cuda(device):
        out["card"] = nvidia_smi_line()
        out["cuda_devices"] = torch.cuda.device_count()
        check(not reads_bam or dec == NATIVE,
              "the %s BAM decoder loaded on a CUDA run" % dec)
    return out


def default_fixture(n_events: int, depth: float = 30.0) -> Tuple[str, str]:
    """bench.py's simulated sample at ``n_events`` (``utils/fixture``),
    simulated once and cached under ``build/tools/``."""
    d = os.path.join(CACHE, "wgs_n%d_d%g" % (n_events, depth))
    bam, vcf = os.path.join(d, "wgs.bam"), os.path.join(d, "wgs.vcf")
    done = os.path.join(d, "done")
    if not os.path.exists(done):
        note("simulating %d events at %gx into %s" % (n_events, depth, d))
        fixture.simulate_wgs(d, n_events, depth=depth)
        open(done, "w").close()
    return bam, vcf


def rss_mb(pid="self") -> float:
    """Resident set of a process in MiB (0 once it is gone)."""
    try:
        with open("/proc/%s/status" % pid) as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def drift(vals: Sequence[float]) -> Tuple[Optional[float], Optional[float], float]:
    """``scripts/soak_1m.py``'s flat-memory rule → (head, tail, drift):
    the median of the first quarter of the samples against the median of
    the last quarter. Fewer than four samples are too few to judge:
    drift 0, head and tail the last sample (None when there is none)."""
    v = np.asarray(vals, dtype=np.float64)
    if len(v) < 4:
        last = float(v[-1]) if len(v) else None
        return last, last, 0.0
    q = max(1, len(v) // 4)
    head, tail = float(np.median(v[:q])), float(np.median(v[-q:]))
    return head, tail, (tail - head) / head if head else 0.0


def run_main(fn: Callable[[], object]) -> int:
    """A tool's command: 0, or 1 with the failure on stderr."""
    try:
        fn()
    except ToolError as e:
        note("FAIL: %s" % e)
        return 1
    return 0
