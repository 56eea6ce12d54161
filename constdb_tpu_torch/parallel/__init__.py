"""Process-level parallelism of the port: the hash-shard worker pool."""

from .host_pool import HostShardPool

__all__ = ["HostShardPool"]
