"""Single-device distribution: placement rules and gradient compression."""

from repro_torch.dist import compression
from repro_torch.dist.sharding import param_spec, shard, shard_cuts

__all__ = ["compression", "param_spec", "shard", "shard_cuts"]
