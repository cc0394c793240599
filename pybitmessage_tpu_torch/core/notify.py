"""apinotify: exec a user-configured program on node events (copy of
``pybitmessage_tpu.core.notify``).

Reference: ``apinotifypath`` (src/api.py:263-275, bitmessagemain.py:
127-130, class_objectProcessor.py:678-684) — the configured executable
is spawned with the event name as its single argument; the reference's
own test harness uses it to learn the API came up ("apiEnabled").
Events emitted here: startingUp, apiEnabled, newMessage, newSentMessage,
newAddress.
"""

from __future__ import annotations

import asyncio
import logging

logger = logging.getLogger("pybitmessage_tpu_torch.notify")

#: UISignal command -> apinotify event name
_EVENT_MAP = {
    "displayNewInboxMessage": "newMessage",
    "displayNewSentMessage": "newSentMessage",
    "writeNewAddressToTable": "newAddress",
}


class ApiNotifier:
    """Subscribes to the node's UISignaler and execs the hook."""

    def __init__(self, node, path: str):
        self.node = node
        self.path = path
        self.fired: list[str] = []  # observability / tests
        #: hook runs in flight: the loop holds tasks weakly
        self._tasks: set[asyncio.Task] = set()

    def start(self) -> None:
        self.node.ui.subscribe(self._on_event)
        self.notify("startingUp")

    def stop(self) -> None:
        self.node.ui.unsubscribe(self._on_event)

    def _on_event(self, command: str, data: tuple) -> None:
        event = _EVENT_MAP.get(command)
        if event:
            self.notify(event)

    def notify(self, event: str) -> None:
        self.fired.append(event)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no running loop (sync-context callers)
        task = loop.create_task(self._spawn(event))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _spawn(self, event: str) -> None:
        try:
            proc = await asyncio.create_subprocess_exec(
                self.path, event,
                stdout=asyncio.subprocess.DEVNULL,
                stderr=asyncio.subprocess.DEVNULL)
            await proc.wait()
        except Exception:
            logger.warning("apinotify hook %r failed for %s",
                           self.path, event, exc_info=True)
