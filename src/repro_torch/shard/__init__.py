"""Sharded DynGraph backend: the graph itself partitioned across shards,
with halo (ghost-region) exchange of boundary property values
(counterpart of ``repro.shard``).  Registered as backend
``"dist_sharded"``."""
from repro_torch.shard.engine import LocalShard, ShardedEngine, ShardGraph

__all__ = ["ShardedEngine", "ShardGraph", "LocalShard"]
