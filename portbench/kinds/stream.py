"""Peers' replication streams through the node: traffic kind "stream".

Set-up preloads the node with one catch-up of the configuration's
snapshots (the resident planes and the barriers' flushes then work at the
size a deployed node holds), and makes every peer's frame stock from the
seed: its operations and their RESP bytes (gen.py, vectorised).  Each
peer has its own origin, seed, parser (`make_parser()`) and
`CoalescingApplier` with the node's default batch and latency bounds, as
a node's pull loops hold them.

The window feeds the peers' bytes round-robin, `slice_bytes` at a time
(one read of a pull loop: replica/link.py reads 64 KiB), every parsed
frame into its peer's applier (barriers go through
`Node.apply_replicated`, batches land through `Node.merge_stream_batch`),
and, as the pull loop does when its parser runs dry, lands what the
slice left pending; until the window's seconds have passed.  Then every
applier flushes, the node flushes and the device synchronizes.  A peer whose stock runs out
fails the run: the stock must outlast the window.

A traced run traces the window's first `trace_seconds` and reads its
host metrics (time inside the node's landing entries, visibility) from
the rest.  The check replays exactly the frames that were parsed,
warm-up included, on top of the preloaded snapshot's join.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import feed, gen
from ..reference import compare, join, replay


class _Peer:
    __slots__ = ("origin", "ops", "data", "end", "pos", "parser", "applier",
                 "pending_ts")


def _sampled_applier(base):
    """The applier with a call after each of its flushes (a traced run's
    visibility samples land there)."""
    class Sampled(base):
        __slots__ = ("on_land",)

        def flush(self) -> None:
            super().flush()
            self.on_land()
    return Sampled


class Kind:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.mix = ctx.traffic
        self.slice = int(self.mix["slice_bytes"])
        self.lat: list = []
        self.spent = {"land_s": 0.0, "barrier_s": 0.0}

    def setup(self) -> None:
        from constdb_tpu_torch.replica.coalesce import CoalescingApplier
        from constdb_tpu_torch.replica.manager import ReplicaMeta
        from constdb_tpu_torch.resp.codec import make_parser

        ctx, mix = self.ctx, self.mix
        ctx.log_setup("imports")
        self.snap = gen.snapshots(self.cfg, ctx.seed)

        def make(p):
            peer = _Peer()
            peer.origin = int(mix["first_origin"]) + p
            peer.ops = gen.peer_ops(mix, int(mix["frames_per_peer"]),
                                    [ctx.seed, p])
            peer.data, peer.end = gen.encode_frames(peer.ops, mix,
                                                    peer.origin)
            peer.pos = 0
            peer.pending_ts = []
            return peer
        # one thread a peer: the stock's numpy work runs outside the GIL
        n = int(mix["peers"])
        with ThreadPoolExecutor(max(1, min(n, os.cpu_count() or 1))) as ex:
            self.peers = list(ex.map(make, range(n)))
        ctx.freeze_inputs()
        ctx.log_setup("inputs and frame stock")
        chunks = feed.interleaved_chunks(feed.replica_batches(self.snap),
                                         int(self.cfg["chunk_keys"]))
        node = self.node = ctx.make_node()
        g = int(self.cfg["merge_group"])
        with ctx.label("preload"):
            for i in range(0, len(chunks), g):
                node.merge_batches(chunks[i:i + g])
            node.ensure_flushed()
            ctx.sync()
        del chunks
        ctx.log_setup("preload")
        applier_cls = _sampled_applier(CoalescingApplier) if ctx.trace \
            else CoalescingApplier
        for peer in self.peers:
            peer.parser = make_parser()
            peer.applier = applier_cls(
                node, ReplicaMeta(f"peer{peer.origin}:0",
                                  node_id=peer.origin))
        ctx.instrument(node)
        if ctx.trace:
            self._time_layers()
        for _ in range(int(mix["warmup_slices"])):
            for peer in self.peers:
                self._feed(peer)
        self._land_all()
        ctx.log_setup("warm-up slices")

    def _time_layers(self) -> None:
        """Traced run: host seconds inside the node's two landing entries,
        and visibility samples (intake -> landed, every 64th frame of each
        peer, as bench.py replay_stream samples them)."""
        node, label, spent = self.node, self.ctx.label, self.spent

        def timed(name, key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    with label(name):
                        return fn(*a, **kw)
                finally:
                    spent[key] += time.perf_counter() - t0
            return run

        node.merge_stream_batch = timed("node.merge_stream_batch", "land_s",
                                        node.merge_stream_batch)
        node.apply_replicated = timed("node.apply_replicated", "barrier_s",
                                      node.apply_replicated)
        for peer in self.peers:
            peer.applier.on_land = self._landed(peer)

    def _landed(self, peer):
        def landed():
            if peer.pending_ts:
                t = time.perf_counter()
                self.lat.extend(t - x for x in peer.pending_ts)
                peer.pending_ts.clear()
        return landed

    def _feed(self, peer, sample: bool = False) -> None:
        chunk = peer.data[peer.pos:peer.pos + self.slice]
        if not chunk:
            raise RuntimeError(f"peer {peer.origin}'s frame stock ran out "
                               "before the window closed")
        i = int(np.searchsorted(peer.end, peer.pos, side="right"))
        peer.pos += len(chunk)
        parser, apply = peer.parser, peer.applier.apply
        parser.feed(chunk)
        applier = peer.applier
        if not sample:
            while (msg := parser.next_msg()) is not None:
                apply(msg.items)
        else:
            now = time.perf_counter
            while (msg := parser.next_msg()) is not None:
                apply(msg.items)
                if not i & 63:
                    if applier.pending:
                        peer.pending_ts.append(now())
                    else:
                        self.lat.append(0.0)
                i += 1
        # the pull loop's rule: a parser with no complete frame left means
        # the stream is idle, and what is pending lands before the next read
        if applier.pending:
            applier.flush()

    def _land_all(self) -> None:
        with self.ctx.label("land_all"):
            for peer in self.peers:
                peer.applier.flush()
            self.node.ensure_flushed()
            self.ctx.sync()

    def _fed(self) -> list:
        """Frames parsed (and so applied) per peer."""
        return [int(np.searchsorted(p.end, p.pos, side="right"))
                for p in self.peers]

    def window(self, seconds: float) -> dict:
        label, sample = self.ctx.label, self.ctx.trace
        before = sum(self._fed())
        self.lat.clear()
        self.spent.update(land_s=0.0, barrier_s=0.0)
        t0 = time.perf_counter()
        mark = None
        running = True
        while running:
            for peer in self.peers:
                with label("intake.slice"):
                    self._feed(peer, sample)
                elapsed = time.perf_counter() - t0
                if self.ctx.trace_tick(elapsed):
                    # the untraced part starts: its own accounts
                    mark = (time.perf_counter(), sum(self._fed()))
                    self.lat.clear()
                    self.spent.update(land_s=0.0, barrier_s=0.0)
                    for p in self.peers:
                        p.pending_ts.clear()
                if elapsed >= seconds:
                    running = False
                    break
        self._land_all()
        end = time.perf_counter()
        fed = sum(self._fed())
        rec = {"wall_s": end - t0, "frames": fed - before,
               "keys_held": self.node.ks.keys.n}
        if mark is not None:
            rec["untraced"] = dict(rec, wall_s=end - mark[0],
                                   frames=fed - mark[1],
                                   latencies=list(self.lat), **self.spent)
        else:
            rec.update(latencies=list(self.lat), **self.spent)
        return rec

    def node_state(self):
        return self.node

    def release(self) -> None:
        self.node = None
        for peer in self.peers:
            peer.parser = peer.applier = None

    def reference(self) -> dict:
        fed = [(p.origin, {k: v[:n] for k, v in p.ops.items()})
               for p, n in zip(self.peers, self._fed())]
        return compare.concat(join.snapshot_join(self.snap),
                              replay.stream_replay(fed, self.mix))
