"""Scale-out: the sharded full-column step over a list of devices
(``mesh``), contiguous variant sharding, the multi-host gather and the
ordered merge (``multihost``), the synthetic chunk (``synth``), the
entry points of ``__graft_entry__.py`` (``dryrun``)."""

from svtyper_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_sharded_step,
    stack_shards,
)
from svtyper_tpu_torch.parallel.multihost import (  # noqa: F401
    merge_ordered,
    shard_slices,
)
