"""AWAIT-ATOMICITY corpus: the quiesce done-callback race.

The shipped bug (server/serve_shards.py quiesce()): awaiting a resolved
future returns BEFORE its queued done-callbacks run, so the quiesce
path's snapshot of the pending-ack list, taken before the awaits, no
longer described reality when it was used to decide the final drain —
acks enqueued by the still-queued callbacks were dropped.  The fix
drains inline after each await and re-reads the pending state.
"""


class _Plane:
    def __init__(self):
        self._inflight = []
        self._ack_pend = []

    async def quiesce_bad(self):
        """Pre-fix shape: pending snapshot taken before the awaits."""
        pend = list(self._ack_pend)        # cached shared read
        for fut in list(self._inflight):
            await fut                       # done-callbacks still queued
        if pend:                            # AWAIT-ATOMICITY fires: stale
            self._ack_pend = []
            self._drain(pend)

    async def quiesce_fixed(self):
        """Post-fix shape: drain inline, re-read after the awaits."""
        for fut in list(self._inflight):
            await fut
            self._on_serve_ack(fut)         # run what the callback would
        pend = list(self._ack_pend)         # fresh read — stays clean
        if pend:
            self._ack_pend = []
            self._drain(pend)

    def _on_serve_ack(self, fut):
        self._ack_pend.append(fut)

    def _drain(self, pend):
        return len(pend)
