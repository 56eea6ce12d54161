"""constdb_tpu_torch: the PyTorch/CUDA port of constdb-tpu.

A second package beside `constdb_tpu/` (the JAX reference, unchanged).
It runs the snapshot catch-up merge, `TorchMergeEngine.merge_many` then
`flush`, on one NVIDIA H100, with hand-written CUDA kernels for the
aligned replica fold and the counter-sum re-derivation, from in-memory
batches or from snapshot files; and a peer's replication stream through
the node (RESP parse, coalesced micro-batches merged in place on the
card, barriers through the per-key op path).  It imports torch, numpy
and the standard library only: never jax, never `constdb_tpu`.  JAX-free
modules of the reference, and the C++ sources of its staging tables,
CRC64 and RESP/intake/wire scanners, are kept here as copies.

Layer map:
  server/    the node's data plane: Node, the command table, repl-log,
             events, reply cache, overload governor, tracking (copies)
  replica/   coalescing replication applier, REPLBATCH wire codec,
             membership, encode cache (copies)
  resp/      RESP messages and codec (copy; the native parser always)
  crdt/      CRDT conflict-resolution semantics (copy)
  store/     columnar keyspace (copy)
  utils/     staging tables (native C++ tier, pure-Python oracle), the
             g++ build of native/, varint, checksum, compressed
             container, HLC, device resolution
  native/    C++ staging tables, CRC64, RESP/intake/wire scanners and
             their CPython binding
  engine/    MergeEngine boundary: CPU reference + TorchMergeEngine
  ops/       bulk scatter ops, plain folds, CUDA kernel wrappers
  csrc/      CUDA C++ kernels (sm_90a)
  persist/   snapshot file format, writer, loader; catch-up chunker
  convert    reference state carried across as numpy/lists
  workload   catch-up, stream and tensor workloads, the R-file
             catch-up, the replication replays, oracles
"""

__version__ = "0.1.0"
