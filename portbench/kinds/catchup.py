"""The receive side of a full resync, back to back: traffic kind "catchup".

Set-up makes the configuration's R replica snapshots from the seed, cuts
them into the program's chunks and runs one whole catch-up to warm every
shape.  Each catch-up of the window then is what the node does when it
rejoins: `Node.reset_for_full_resync()`, the replicas' chunks
(interleaved) through `Node.merge_batches` in groups of `group`, then
`Node.ensure_flushed()` and a device synchronize.  A new catch-up starts
while less than the window's seconds have passed.  A traced run traces
the catch-ups of its first `trace_seconds` and reads its host and program
metrics from the rest.

The check compares the node's keyspace after the last catch-up with the
reference's join of the same snapshots.
"""

from __future__ import annotations

import gc
import time

from .. import feed, gen
from ..reference import join


class Kind:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.group = int(ctx.traffic["group"])

    def setup(self) -> None:
        ctx = self.ctx
        ctx.log_setup("imports")
        self.snap = gen.snapshots(self.cfg, ctx.seed)
        self.n_keys = len(self.snap["keys"])
        batches = feed.replica_batches(self.snap)
        self.chunks = feed.interleaved_chunks(batches,
                                              int(self.cfg["chunk_keys"]))
        del batches
        ctx.freeze_inputs()
        ctx.log_setup("inputs")
        self.node = ctx.make_node()
        ctx.instrument(self.node)
        self.catchup()
        ctx.log_setup("warm-up catch-up")

    def catchup(self) -> None:
        node, chunks, g = self.node, self.chunks, self.group
        label = self.ctx.label
        with label("catchup"):
            with label("node.reset_for_full_resync"):
                node.reset_for_full_resync()
            # the wiped keyspace is cyclic garbage (its bytes lists point
            # back at it): free it here, on the catch-up's time, rather
            # than let it pile up until the collector's next full pass
            with label("gc.collect"):
                gc.collect()
            for i in range(0, len(chunks), g):
                with label("node.merge_batches"):
                    node.merge_batches(chunks[i:i + g])
            with label("node.ensure_flushed"):
                node.ensure_flushed()
            with label("device.synchronize"):
                self.ctx.sync()

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        ends, mark = [], None
        while time.perf_counter() - t0 < seconds:
            self.catchup()
            ends.append(time.perf_counter() - t0)
            if self.ctx.trace_tick(ends[-1]):
                mark = len(ends)
        wall = time.perf_counter() - t0
        n = len(ends)
        self.ctx.log("[portbench] catch-ups end at (s): " +
                     " ".join(f"{t:.3f}" for t in ends))
        rec = {"wall_s": wall, "catchups": n, "keys": n * self.n_keys,
               "keys_held": self.node.ks.keys.n}
        if mark is not None and mark < n:
            rec["untraced"] = dict(rec, wall_s=wall - ends[mark - 1],
                                   catchups=n - mark,
                                   keys=(n - mark) * self.n_keys)
        return rec

    def node_state(self):
        return self.node

    def release(self) -> None:
        self.node = None
        self.chunks = None

    def reference(self) -> dict:
        return join.snapshot_join(self.snap)
