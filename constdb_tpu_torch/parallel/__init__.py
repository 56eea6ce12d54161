"""Process-level parallelism of the port: the hash-shard worker pool, and
the multi-device merge (the rep x kv step over torch.distributed and the
device list of the kv range-partitioned engine)."""

from .host_pool import HostShardPool
from .sharded import (engine_mesh, make_mesh, shard_batch_arrays,
                      sharded_merge_step)

__all__ = ["HostShardPool", "engine_mesh", "make_mesh",
           "shard_batch_arrays", "sharded_merge_step"]
