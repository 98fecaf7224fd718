"""Contiguous variant sharding for ``--num_shards``.

Only ``shard_slices`` of ``svtyper_tpu.parallel.multihost`` is ported:
the multi-host gather (``jax.distributed``) is not part of the port yet.
"""

from __future__ import annotations

from typing import List, Tuple


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
