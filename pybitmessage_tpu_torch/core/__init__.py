"""The node of the port: storage, keys, the send worker and the object
processor wired to the card's PoW, verify and ECDH services."""

from .node import Node  # noqa: F401
