"""CUT-ORDERING corpus: the consistency-cut bug, minimized.

The shipped bug (replica/link.py _send_delta): the digest was awaited
BEFORE the replication watermark was captured.  Writes landing during
the await advanced the watermark past the digested state — the
(watermark, digest) pair described a cut no replica could ever converge
to.  The fix captures watermarks + records FIRST, then awaits every
derived export.
"""


class _Link:
    def __init__(self, node, app):
        self.node = node
        self.app = app

    async def send_delta_bad(self, writer):
        """Pre-fix shape: export awaited before the capture."""
        digest = await self._local_digest(self.node)   # CUT-ORDERING fires
        repl_last = self.node.repl_log.last_uuid       # capture, too late
        records = self.node.replicas.records()
        return digest, repl_last, records

    async def send_delta_fixed(self, writer):
        """Post-fix shape: watermarks first, digest after."""
        repl_last = self.node.repl_log.last_uuid       # capture FIRST
        records = self.node.replicas.records()
        digest = await self._local_digest(self.node)   # stays clean
        return digest, repl_last, records

    async def export_branchy_bad(self):
        """Capture on ONE path only: the some-path semantics — the
        else-free branch reaches the export uncaptured."""
        repl_last = 0
        if self.app.fast_path:
            repl_last = self.node.repl_log.landed_last_uuid
        counts = await self.node.serve_plane.key_count()  # fires
        return repl_last, counts

    async def export_branchy_fixed(self):
        """Capture dominates the export: every path is covered."""
        repl_last = self.node.repl_log.landed_last_uuid
        if not self.app.fast_path:
            return repl_last, None
        counts = await self.node.serve_plane.key_count()  # stays clean
        return repl_last, counts

    async def _local_digest(self, node):
        return node
