"""Persistence: the snapshot file format, its writer and loader, and the
catch-up chunker."""

from .snapshot import (NodeMeta, ReplicaRecord, SectionDemux,
                       SnapshotLoader, SnapshotWriter, batch_chunks,
                       dump_keyspace, iter_keyspace_chunks, load_snapshot,
                       write_snapshot_file)

__all__ = ["NodeMeta", "ReplicaRecord", "SectionDemux", "SnapshotLoader",
           "SnapshotWriter", "batch_chunks", "dump_keyspace",
           "iter_keyspace_chunks", "load_snapshot", "write_snapshot_file"]
