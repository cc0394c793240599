"""Shared node state and the connection pool (copy of
``pybitmessage_tpu.network.pool``, cut to object acceptance).

:class:`NodeContext` carries what the object checks need: the
inventory, the streams this node accepts, the batch PoW verifier (set
to the node's network-minimum difficulty), and the watermarked queue
validated objects leave through.  :class:`ConnectionPool` here holds no
connections: :meth:`~ConnectionPool.object_received` queues a new
object for the processor, and :meth:`~ConnectionPool.announce_object`
has no peer to tell, as in the JAX pool with no connections; both call
their optional hook.  The socket protocol comes with the network slice
and calls the same acceptance function, ``connection.accept_object``.
"""

from __future__ import annotations

from typing import Callable

from ..utils.queues import WatermarkQueue


class NodeContext:
    """Shared state every connection needs."""

    def __init__(self, *, inventory, pow_verifier, streams=(1,)):
        self.inventory = inventory
        self.streams = tuple(streams)
        #: validated objects flow out here: (hash, header, payload).
        #: Crossing HIGH pauses the readers until the processor drains
        #: it back under LOW
        self.object_queue = WatermarkQueue()
        #: the BatchVerifier every incoming object's PoW goes through
        self.pow_verifier = pow_verifier


class ConnectionPool:
    """The pool's object hand-off, with no connections."""

    def __init__(self, ctx: NodeContext):
        self.ctx = ctx
        #: ``(h, stream, local)`` for every announced object
        self.on_announce: Callable | None = None
        #: new objects accepted
        self.objects_received = 0

    def object_received(self, h: bytes, header, payload: bytes) -> None:
        """A new valid object arrived: queue it for processing."""
        self.objects_received += 1
        self.ctx.object_queue.put_nowait((h, header, payload))

    def announce_object(self, h: bytes, stream: int = 1,
                        local: bool = True) -> None:
        """Advertise a locally generated or relayed object: no peer to
        tell, so only the hook hears of it."""
        if self.on_announce is not None:
            self.on_announce(h, stream, local)
