"""JSON-RPC / XML-RPC API of the port (copy of ``pybitmessage_tpu.api``),
speaking the reference's command vocabulary.

Reference: src/api.py — numbered APIError codes 0-27, HTTP basic auth
on 127.0.0.1:8442.
"""

from .commands import APIError, CommandHandler  # noqa: F401
from .server import APIServer  # noqa: F401
