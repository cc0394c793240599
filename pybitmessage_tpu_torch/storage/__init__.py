"""Persistence of the port: the SQLite message store, the three
inventory backends of the JAX package (the SQLite ``Inventory``, the
one-file-per-object ``FilesystemInventory`` and the slab store
``SlabStore``), in its formats, and the write-behind buffer."""

from .db import Database  # noqa: F401
from .fs_inventory import FilesystemInventory  # noqa: F401
from .inventory import Inventory  # noqa: F401
from .slabstore import SlabStore  # noqa: F401
