"""Server core (the port's copy): node state, command dispatch, repl-log,
event bus.

The data plane of a constdb node (capability parity with reference
src/server.rs, src/cmd.rs).  Compute-heavy bulk merges are delegated to
engine/ (the MergeEngine boundary); this package is the single-writer
command executor around it.  The IO loop is not ported yet.
"""

from .node import Node
from .repl_log import ReplLog
from .events import EventBus, EVENT_REPLICATED, EVENT_REPLICA_ACKED, EVENT_DELETED

__all__ = [
    "Node", "ReplLog", "EventBus",
    "EVENT_REPLICATED", "EVENT_REPLICA_ACKED", "EVENT_DELETED",
]
