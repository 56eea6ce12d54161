"""Event bus: wakes replica pushers when there is new work.

Capability parity with the reference's broadcast-based producer/consumer
(reference src/server.rs:477-545: EventsProducer over tokio::sync::broadcast,
consumers filter by bitmask).  Redesigned for the asyncio runtime: each
consumer owns an asyncio.Event; `trigger` sets the events of every consumer
whose mask matches.  Consumers that are slow simply coalesce wakeups (the
reference's lagged-broadcast behavior), so the bus never grows unbounded.
"""

from __future__ import annotations

import asyncio
from typing import Optional

EVENT_REPLICATED = 1       # a new entry hit the repl_log
EVENT_REPLICA_ACKED = 2    # a peer advanced an ack watermark
EVENT_DELETED = 4          # a key-level tombstone was recorded
EVENT_PULL_LANDED = 8      # a peer-stream batch landed (pull watermark
#                            advanced): push loops wake to REPLACK once
#                            per covering batch instead of per heartbeat


class EventsConsumer:
    __slots__ = ("mask", "_ev", "_bus")

    def __init__(self, bus: "EventBus", mask: int):
        self.mask = mask
        self._ev = asyncio.Event()
        self._bus = bus

    async def wait(self, timeout: Optional[float] = None) -> bool:
        """True if woken by an event, False on timeout."""
        try:
            await asyncio.wait_for(self._ev.wait(), timeout)
        except asyncio.TimeoutError:
            return False
        self._ev.clear()
        return True

    def close(self) -> None:
        self._bus._consumers.discard(self)


class EventBus:
    def __init__(self) -> None:
        self._consumers: set[EventsConsumer] = set()
        self.last_replicated_uuid = 0

    def new_consumer(self, mask: int = EVENT_REPLICATED) -> EventsConsumer:
        c = EventsConsumer(self, mask)
        self._consumers.add(c)
        return c

    def trigger(self, kind: int, uuid: int = 0) -> None:
        if kind == EVENT_REPLICATED and uuid:
            self.last_replicated_uuid = uuid
        for c in self._consumers:
            if c.mask & kind:
                c._ev.set()
