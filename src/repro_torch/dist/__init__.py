"""Placement rules the store reads (``shard_cuts``); no mesh yet."""

from repro_torch.dist.sharding import param_spec, shard_cuts

__all__ = ["param_spec", "shard_cuts"]
