"""Filesystem inventory backend: one file per object (copy of
``pybitmessage_tpu.storage.fs_inventory``, the same file format).

An object lives in ``<root>/<hash-hex>.obj``: a 20-byte header
``type(4) stream(4) expires(8) taglen(4)`` (big-endian), the tag, then
the payload.  The directory is the index, read once at start.  Every
write is durable when ``add`` returns (written to ``.tmp``, then
renamed), so ``flush`` has nothing to do.

Interface-compatible with :class:`storage.inventory.Inventory`
(``inventorystorage = filesystem``), but without ``attach_digest``:
as in the JAX package, a node on this backend reconciles with no sync
digest.
"""

from __future__ import annotations

import struct
import threading
import time
from pathlib import Path
from typing import Iterable

from ..models.constants import EXPIRES_GRACE
from .inventory import InventoryItem

#: metadata header: type(4) stream(4) expires(8) taglen(4) tag(32 max)
_HEADER = struct.Struct(">LLQ L")


class FilesystemInventory:
    """Dict-like object store keyed by 32-byte inventory hash."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        #: hash -> (stream, expires) index built once at startup
        self._index: dict[bytes, tuple[int, int]] = {}
        self.lookups = 0
        for f in self.root.glob("*.obj"):
            try:
                h = bytes.fromhex(f.stem)
                with open(f, "rb") as fh:
                    t, s, e, n = _HEADER.unpack(fh.read(_HEADER.size))
                self._index[h] = (s, e)
            except (ValueError, struct.error, OSError):
                continue

    def _path(self, hash_: bytes) -> Path:
        return self.root / (hash_.hex() + ".obj")

    # -- dict-like -----------------------------------------------------------

    def __contains__(self, hash_: bytes) -> bool:
        with self._lock:
            self.lookups += 1
            return hash_ in self._index

    def __getitem__(self, hash_: bytes) -> InventoryItem:
        with self._lock:
            if hash_ not in self._index:
                raise KeyError(hash_.hex())
            data = self._path(hash_).read_bytes()
        t, s, e, n = _HEADER.unpack_from(data)
        tag = data[_HEADER.size:_HEADER.size + n]
        payload = data[_HEADER.size + n:]
        return InventoryItem(t, s, payload, e, tag)

    def __setitem__(self, hash_: bytes, item: InventoryItem) -> None:
        blob = _HEADER.pack(item.type, item.stream, item.expires,
                            len(item.tag)) + item.tag + item.payload
        with self._lock:
            tmp = self._path(hash_).with_suffix(".tmp")
            tmp.write_bytes(blob)
            tmp.replace(self._path(hash_))
            self._index[hash_] = (item.stream, item.expires)

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def add(self, hash_: bytes, type_: int, stream: int, payload: bytes,
            expires: int, tag: bytes = b"") -> None:
        self[hash_] = InventoryItem(type_, stream, payload, expires, tag)

    # -- queries -------------------------------------------------------------

    def by_type_and_tag(self, object_type: int,
                        tag: bytes | None = None) -> list[InventoryItem]:
        out = []
        with self._lock:
            hashes = list(self._index)
        for h in hashes:
            try:
                item = self[h]
            except KeyError:
                continue
            if item.type == object_type and (tag is None or
                                             item.tag == tag):
                out.append(item)
        return out

    def unexpired_hashes_by_stream(self, stream: int) -> list[bytes]:
        now = int(time.time())
        with self._lock:
            return [h for h, (s, e) in self._index.items()
                    if s == stream and e > now]

    def flush(self) -> None:
        """No-op: every write is already durable on disk."""

    def clean(self) -> None:
        cutoff = int(time.time()) - EXPIRES_GRACE
        with self._lock:
            stale = [h for h, (s, e) in self._index.items() if e < cutoff]
            for h in stale:
                try:
                    self._path(h).unlink(missing_ok=True)
                except OSError:
                    pass
                del self._index[h]

    def hashes(self) -> Iterable[bytes]:
        with self._lock:
            return list(self._index)
