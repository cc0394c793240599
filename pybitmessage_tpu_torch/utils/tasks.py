"""Fire-and-forget asyncio task spawning that survives GC (copy of
``pybitmessage_tpu.utils.tasks``).

The event loop keeps only a weak reference to tasks, so a task created
and immediately dropped can be collected before it runs (asyncio docs,
``loop.create_task``).  ``spawn`` anchors each task in a module-level
set until it completes — the same pattern ``network/connection.py``
uses for its ``_verify_tasks``.
"""

from __future__ import annotations

import asyncio
from typing import Coroutine

_background_tasks: set[asyncio.Task] = set()


def spawn(coro: Coroutine) -> asyncio.Task:
    """Schedule *coro* on the running loop, holding a strong reference
    until it finishes."""
    task = asyncio.get_running_loop().create_task(coro)
    _background_tasks.add(task)
    task.add_done_callback(_background_tasks.discard)
    return task
