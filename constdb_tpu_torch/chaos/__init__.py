"""Convergence-under-chaos certification harness.

Every hot path in this build has a faster variant negotiated by
capability bits — coalesced apply, serve coalescing/sharding, delta
resync, resident device planes, the REPLBATCH wire — and each ships with
a differential suite pinning byte-identity on CLEAN runs.  This package
is the production-readiness gate on top: it certifies that all of those
paths still CONVERGE under partitions, frame reordering, duplicated
delivery, mid-stream and mid-frame connection kills, process crashes
(cold and warm), clock jitter, and mixed-version peers — at once, on
every capability-matrix cell.

Shape of the harness:

  * `plane.FaultPlane` — a seeded fault plane wrapping EVERY inter-node
    transport (ServerApp.peer_connector: replica links are always the
    dialing side of their stream, so wrapping dials covers the mesh).
    It splits each direction into protocol frames (raw FULLSYNC/
    DELTASYNC payload windows stay atomic with their headers) and
    applies scripted or seeded faults per directed edge: partitions
    (full/asymmetric), delay, reorder, duplication, mid-frame
    truncation + kill, targeted REPLBATCH payload corruption.
  * `cluster.ChaosCluster` — node lifecycle: per-cell engine/capability
    configs, deterministic per-node HLC clocks with scripted jitter
    (`ChaosClock`), and the crash primitives (`restart_cold` /
    `restart_warm`, `kill9`, `checkpoint_crash`).
  * `oracle` — the invariant oracle: an op JOURNAL tapping every node's
    origin stream (ReplLog.on_append) feeds a CPU-engine reference
    export every node must match byte-identically; a continuous MONITOR
    pins per-link watermark/beacon monotonicity while faults are live;
    post-convergence checks pin digest-matrix agreement, no-resurrection
    of retired keys/members, GC drain, and fault accounting (INFO
    demotion/refusal/reconnect counters vs the faults actually
    injected).
  * `scenario` — the Scenario DSL: seed + node specs + a scripted
    fault/op schedule.  A scenario's decision stream (ops, targets,
    fault choices, backoff jitter) is a pure function of its seed, so
    any failure replays from the printed seed; `certify_scenario` is
    the acceptance schedule (partition + reorder + duplicate +
    mid-stream kill + clock jitter + one mixed-version peer) and
    `matrix_cells` enumerates the capability sweep it must pass on.

  * `resource` — the RESOURCE-fault cells: a memory-capped
    node under a firehose (shed-at-the-edge with exact -OOM replies,
    replication intake admitted, convergence preserved), a
    stalled-reader client cut at the outbuf cap, and a stalled-reader
    peer recovering through the repl-window pause -> ring eviction ->
    certified resync path.  The fault plane grew a transport-sound
    `stall` primitive for these (a peer that stops reading is a fault
    TCP produces daily).

  * `cluster_cells` / `tracking_cells` — slot migration under faults
    and the near-cache's zero-stale law under faults.

The port's copy of the reference's harness, over the port's server,
op log, serve shards, cluster mode and near-cache client.  Its card
cells ("torch", "torch-resident") run every fast-path node on a
TorchMergeEngine on `Cell.device` (CUDA by default, raising without a
card); the mixed-version peer and every oracle node run the port's
CpuMergeEngine.

CLI: `python -m constdb_tpu_torch.chaos [--seed N] [--cells a,b,...]
[--all] [--soak] [--resource] [--ops N] [--list] [--device cuda|cpu]`.
"""

from .plane import FaultPlane
from .cluster import ChaosClock, ChaosCluster, NodeSpec
from .oracle import InvariantMonitor, OpJournal
from .resource import run_resource_scenario
from .scenario import (Cell, Scenario, certify_scenario, matrix_cells,
                       run_scenario, smoke_cells, soak_scenario)

__all__ = ["FaultPlane", "ChaosClock", "ChaosCluster", "NodeSpec",
           "InvariantMonitor", "OpJournal", "Cell", "Scenario",
           "certify_scenario", "matrix_cells", "run_scenario",
           "run_resource_scenario", "smoke_cells", "soak_scenario"]
