"""Extended message-type registry (copy of
``pybitmessage_tpu.models.messagetypes``; reference src/messagetypes/).

Encoding-3 payloads are msgpack maps whose ``""`` key names the type;
the reference dispatches by module name under a whitelist of enabled
types (messagetypes/__init__.py:8-32, whitelist ``["message"]`` — its
``vote`` type ships disabled).  Re-design: explicit class registry with
a decorator instead of module-path reflection; same whitelist default.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("pybitmessage_tpu_torch.models")

#: enabled type names (reference MsgBase whitelist)
WHITELIST = {"message"}

_REGISTRY: dict[str, type] = {}


class MessageTypeError(ValueError):
    pass


def register(cls: type) -> type:
    """Class decorator: make an extended message type constructible."""
    _REGISTRY[cls.name] = cls
    return cls


class MsgType:
    """Base extended message type: validates + normalizes one map."""

    name = ""
    #: required keys beyond the "" discriminator
    required: tuple[str, ...] = ()

    def __init__(self, obj: dict):
        for key in self.required:
            if key not in obj:
                raise MessageTypeError(
                    "%s missing required field %r" % (self.name, key))
        self.data = self.normalize(obj)

    def normalize(self, obj: dict) -> dict:
        return obj


@register
class Message(MsgType):
    """The only type enabled by default (messagetypes/message.py)."""

    name = "message"
    required = ("subject", "body")

    def normalize(self, obj: dict) -> dict:
        return {"subject": str(obj.get("subject", "")),
                "body": str(obj.get("body", ""))}


@register
class Vote(MsgType):
    """Present but NOT whitelisted — mirrors the reference's disabled
    vote.py stub; constructing one raises unless enabled."""

    name = "vote"
    required = ("msgid", "vote")


def construct(obj) -> MsgType:
    """Instantiate the registered type for a decoded msgpack map
    (reference constructObject)."""
    if not isinstance(obj, dict):
        raise MessageTypeError("extended payload is not a map")
    name = obj.get("")
    if not isinstance(name, str) or name not in WHITELIST:
        raise MessageTypeError("extended type %r not enabled" % (name,))
    cls = _REGISTRY.get(name)
    if cls is None:
        raise MessageTypeError("no handler for extended type %r" % name)
    return cls(obj)
