"""LOCK-DISCIPLINE corpus: both lock flavors crossed with the wrong
execution world.

* A thread lock (`_crc_lock`-style) held across an `await` parks the
  lock for as many scheduler turns as the loop pleases — merge workers
  contending on it stall, and re-entry through the same coroutine path
  self-deadlocks.
* An asyncio lock (`_stream_lock`-style) held across blocking sync
  calls wedges the loop AND every waiter queued on the lock; spill IO
  belongs in run_in_executor (replica/link.py _stream_file is the
  reference shape).
"""

import asyncio
import threading


class _WarmCache:
    def __init__(self):
        self._crc_lock = threading.Lock()
        self._stream_lock = asyncio.Lock()
        self._warm = {}

    async def crc_window_bad(self):
        with self._crc_lock:
            crcs = dict(self._warm)
            await self._publish(crcs)   # LOCK-DISCIPLINE fires: await
        return crcs                     # under a thread lock

    async def crc_window_fixed(self):
        with self._crc_lock:            # sync body: snapshot + release
            crcs = dict(self._warm)
        await self._publish(crcs)       # stays clean
        return crcs

    async def stream_window_bad(self, path):
        async with self._stream_lock:
            f = open(path, "rb")        # LOCK-DISCIPLINE fires: blocking
            data = f.read()             # IO while holding the loop lock
            fut = self._spill(data)
            return fut.result()         # LOCK-DISCIPLINE fires: .result()

    async def stream_window_fixed(self, path):
        loop = asyncio.get_running_loop()
        async with self._stream_lock:   # awaits under an asyncio lock
            data = await loop.run_in_executor(None, self._read, path)
        return data                     # are the sanctioned shape

    async def _publish(self, crcs):
        return crcs

    def _spill(self, data):
        return data

    def _read(self, path):
        return path
