"""AWAIT-ATOMICITY corpus: the close-window race, minimized.

The shipped bug (server/io.py close()): the shutdown path snapshotted
the live link set, then awaited the listener teardown — during which a
connection accepted just before the listener closed could still reach
_upgrade_to_replica and register a FRESH link.  The sweep then walked
the stale snapshot, missing the newcomer: a zombie stream pumping
replication frames into a dead node.  The fix re-reads the link set
after the await (a second sweep).
"""


class _App:
    def __init__(self, listener):
        self._links = set()
        self._listener = listener

    async def close_bad(self):
        """Pre-fix shape: snapshot, await, sweep the snapshot."""
        links = list(self._links)          # cached shared read
        self._listener.close()
        await self._listener.wait_closed()  # upgrades can register here
        for lk in links:                    # AWAIT-ATOMICITY fires: stale
            lk.stop()
            self._links.discard(lk)

    async def close_fixed(self):
        """Post-fix shape: re-read after every await (second sweep)."""
        for lk in list(self._links):
            lk.stop()
        self._listener.close()
        await self._listener.wait_closed()
        for lk in list(self._links):        # fresh read — stays clean
            lk.stop()
            self._links.discard(lk)

    async def sweep_pinned(self):
        """A DELIBERATE pre-await snapshot, declared as such."""
        # lint: pin[doomed] — links registered after the cutoff belong
        # to the next epoch and are swept by the next cycle
        doomed = list(self._links)
        await self._listener.wait_closed()
        for lk in doomed:                   # pinned — stays clean
            lk.stop()
            self._links.discard(lk)
