"""Scale-out: contiguous variant sharding and the multi-host gather
(``multihost``), the multi-device dryrun (``dryrun``)."""
