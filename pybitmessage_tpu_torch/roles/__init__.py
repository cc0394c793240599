"""Composable node roles (twin of ``pybitmessage_tpu.roles``).

The node runs fused in one process (``all``, the default) or split into
``edge`` processes (sockets, framing, the PoW check on the card, a
dedupe cache) and stream-sharded ``relay`` processes (storage, the
processor and the sender), joined by the length-prefixed role IPC
channel of :mod:`.ipc`, whose frames are the JAX package's byte for
byte.  The light-client tier: an edge's ``ClientPlane`` (with its
``SubscriptionIndex``) serves store-nothing ``LightClient``s
(``role=client``) over the frames of :mod:`.subscription`.
"""

from .registry import ROLES, RoleSpec, get_role, parse_role_streams
from .streams import shard_owner, stream_for_address, stream_for_ripe

__all__ = [
    "ROLES", "RoleSpec", "get_role", "parse_role_streams",
    "shard_owner", "stream_for_address", "stream_for_ripe",
    "EdgeCache", "EdgeRuntime", "RelayRuntime",
    "ClientPlane", "SubscriptionIndex", "LightClient",
]


def __getattr__(name):  # PEP 562: the runtimes import lazily
    if name in ("EdgeCache", "EdgeRuntime"):
        from . import edge
        return getattr(edge, name)
    if name == "RelayRuntime":
        from .relay import RelayRuntime
        return RelayRuntime
    if name in ("ClientPlane", "SubscriptionIndex"):
        from . import subscription
        return getattr(subscription, name)
    if name == "LightClient":
        from .client import LightClient
        return LightClient
    raise AttributeError(name)
