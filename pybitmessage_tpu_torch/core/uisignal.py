"""UI event fan-out: the reference's UISignalQueue command vocabulary
(copy of ``pybitmessage_tpu.core.uisignal``).

The reference decouples core from frontends through a queue of
``(command, data)`` tuples drained by each UI (bitmessageqt/
uisignaler.py:8-60 re-emits them as Qt signals; class_smtpDeliver.py
consumes the same stream).  Commands used here (same names, so any
frontend written against the reference vocabulary maps 1:1):

- ``writeNewAddressToTable``      (label, address, stream)
- ``displayNewInboxMessage``      (msgid, to, from, subject, body)
- ``displayNewSentMessage``       (to, fromLabel, from, subject, body, ack)
- ``updateSentItemStatusByAckdata`` (ackdata, status_text)
- ``updateNetworkStatusTab``      (connected_count,)
- ``updateStatusBar``             (text,)

asyncio re-design: instead of one global queue with exactly-one
consumer, a synchronous fan-out to any number of subscribers — each
frontend gets every event without stealing them from the others.
Events carry a monotonically increasing sequence number so
out-of-process frontends can long-poll ``waitForEvents`` over the API
with a cursor instead of refresh-polling (the uisignaler.py contract,
event-driven end to end).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable

logger = logging.getLogger("pybitmessage_tpu_torch.ui")


class UISignaler:
    """Synchronous multi-subscriber event bus for UI-facing events."""

    def __init__(self):
        self._subs: list[Callable[[str, tuple], None]] = []
        #: id of the most recent event; the long-poll cursor space
        self.seq = 0
        #: ring of recent (seq, command, data) (TUIs render history on
        #: attach; API long-pollers catch up after a missed window)
        self.recent: list[tuple[int, str, tuple]] = []
        self.max_recent = 200
        self._waiters: list[asyncio.Future] = []

    def subscribe(self, callback: Callable[[str, tuple], None]) -> None:
        self._subs.append(callback)

    def unsubscribe(self, callback) -> None:
        try:
            self._subs.remove(callback)
        except ValueError:
            pass

    def emit(self, command: str, data: tuple = ()) -> None:
        self.seq += 1
        self.recent.append((self.seq, command, data))
        if len(self.recent) > self.max_recent:
            del self.recent[:len(self.recent) - self.max_recent]
        # wake long-pollers before the synchronous subscribers so an
        # exception in one of those can't strand a waiting frontend
        for fut in self._waiters:
            if not fut.done():
                fut.set_result(True)
        self._waiters.clear()
        for cb in list(self._subs):
            try:
                cb(command, data)
            except Exception:
                logger.exception("UI subscriber failed on %s", command)

    async def wait_for_events(self, since: int, timeout: float
                              ) -> list[tuple[int, str, tuple]]:
        """Events with seq > ``since``; blocks up to ``timeout`` seconds
        when none are buffered yet (the API waitForEvents long-poll)."""
        events = [e for e in self.recent if e[0] > since]
        if events or timeout <= 0:
            return events
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            pass
        finally:
            if fut in self._waiters:
                self._waiters.remove(fut)
        return [e for e in self.recent if e[0] > since]
