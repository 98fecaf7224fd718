"""Variant sharding (``multihost.shard_slices``)."""
