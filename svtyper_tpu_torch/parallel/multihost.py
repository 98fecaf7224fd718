"""Multi-host orchestration: contiguous variant sharding + the row gather.

Counterpart of ``svtyper_tpu.parallel.multihost`` on
``torch.distributed``: one process per host, host *i* genotypes the
contiguous variant slice ``shard_slices(n, n_hosts)[i]`` against its
local BAM copy, results travel as fixed-width float64 record rows
through an all-gather, and host 0 writes the single ordered VCF. The
slice map is a pure function of (n, n_hosts), so any shard is
idempotently re-runnable.

The process group is gloo on GPU machines too: the gathered rows are
host arrays (the engine has already brought them back through pinned
buffers), and gloo, unlike NCCL, lets two ranks share one card.
"""

from __future__ import annotations

from datetime import timedelta
from typing import List, Optional, Tuple

import numpy as np
import torch

# a rank that dies leaves its peers blocked in a collective; they give up
# after this long instead of hanging
TIMEOUT = timedelta(seconds=120)


def shard_slices(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) per shard; sizes differ by at most 1."""
    base, extra = divmod(n, n_shards)
    out = []
    lo = 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def initialize_from_env(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the gloo process group at ``coordinator`` (``host:port``,
    served by rank 0); returns (process_id, num_processes).

    No-ops to (0, 1) when unconfigured so single-host runs need no flags.
    """
    if coordinator is None and num_processes is None:
        return 0, 1
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method="tcp://" + coordinator,
        world_size=num_processes,
        rank=process_id,
        timeout=TIMEOUT,
    )
    return dist.get_rank(), dist.get_world_size()


def allgather_rows(rows: np.ndarray) -> List[np.ndarray]:
    """Cross-host gather of this host's fixed-width float64 result rows.

    Shards differ in length, so lengths are all-gathered first and every
    shard pads to the max (at least one row) before the row gather.
    Returns one unpadded array per process, in rank order. Without a
    process group it is the identity.
    """
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [rows]
    world = dist.get_world_size()
    n_mine = torch.tensor([rows.shape[0]], dtype=torch.int64)
    ns = [torch.zeros_like(n_mine) for _ in range(world)]
    dist.all_gather(ns, n_mine)
    ns = [int(n.item()) for n in ns]
    padded = torch.zeros((max(max(ns), 1),) + rows.shape[1:],
                         dtype=torch.float64)
    padded[: rows.shape[0]] = torch.from_numpy(
        np.ascontiguousarray(rows, dtype=np.float64)
    )
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    return [g[:n].numpy() for g, n in zip(gathered, ns)]


def destroy() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
