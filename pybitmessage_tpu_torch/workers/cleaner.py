"""Housekeeping task (copy of ``pybitmessage_tpu.workers.cleaner``;
reference: class_singleCleaner.py).

Every cycle: flush the inventory RAM cache to SQL; periodically purge
expired inventory, stale pubkeys, resend overdue messages, clean
knownnodes, and expire download requests.
"""

from __future__ import annotations

import asyncio
import logging
import time

logger = logging.getLogger("pybitmessage_tpu_torch.cleaner")

FLUSH_INTERVAL = 300
DEEP_CLEAN_INTERVAL = 7200


class Cleaner:
    def __init__(self, *, inventory, store, knownnodes, sender, pool,
                 shutdown: asyncio.Event):
        self.inventory = inventory
        self.store = store
        self.knownnodes = knownnodes
        self.sender = sender
        self.pool = pool
        self.shutdown = shutdown
        self._task: asyncio.Task | None = None
        self._last_deep_clean = 0.0

    def start(self) -> asyncio.Task:
        self._task = asyncio.create_task(self._run())
        return self._task

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while not self.shutdown.is_set():
            await asyncio.sleep(FLUSH_INTERVAL)
            try:
                await self.run_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("cleaner cycle failed")

    async def run_once(self) -> None:
        # storage work stays off the event loop (the inventory and the
        # database take their own locks, so a worker thread is safe): at
        # retention scale a flush/TTL-purge cycle is hundreds of ms, and
        # inline it would stall every connection read loop
        await asyncio.to_thread(self.inventory.flush)
        if time.time() - self._last_deep_clean >= DEEP_CLEAN_INTERVAL:
            self._last_deep_clean = time.time()
            await asyncio.to_thread(self.inventory.clean)
            purged = await asyncio.to_thread(self.store.purge_stale_pubkeys)
            dropped = self.knownnodes.cleanup()
            await asyncio.to_thread(self.knownnodes.save)
            self.pool.ctx.global_tracker.expire()
            await self.sender.resend_stale()
            logger.info("deep clean: %d pubkeys purged, %d peers dropped",
                        purged, dropped)
