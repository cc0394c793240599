"""Random-order tracking dict for anonymized object downloads (copy of
``pybitmessage_tpu.utils.randomtracking``).

Semantics of the reference's RandomTrackingDict
(src/randomtrackingdict.py:13-132): dict-like storage whose
``random_keys(count)`` returns up to ``count`` randomly-chosen keys,
excluding keys already handed out within the last ``pending_timeout``
seconds and capping the in-flight window at ``max_pending`` — so
download order never betrays receive order while requests aren't
duplicated.  Deleting a key (object arrived) frees its window slot.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Generic, Iterator, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class RandomTrackingDict(Generic[K, V]):
    #: max keys handed out concurrently (reference maxPending = 10)
    max_pending = 10
    #: seconds before a handed-out key becomes eligible again
    pending_timeout = 60

    def __init__(self, rng: random.Random | None = None) -> None:
        #: draws the keys handed out (the module's generator by default)
        self._rng = rng if rng is not None else random
        self._dict: dict[K, V] = {}
        self._pending: dict[K, float] = {}  # key -> expiry time
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._dict)

    def __contains__(self, key: K) -> bool:
        return key in self._dict

    def __getitem__(self, key: K) -> V:
        return self._dict[key]

    def __setitem__(self, key: K, value: V) -> None:
        with self._lock:
            self._dict[key] = value

    def __delitem__(self, key: K) -> None:
        with self._lock:
            del self._dict[key]
            self._pending.pop(key, None)

    def pop(self, key: K, *default):
        with self._lock:
            self._pending.pop(key, None)
            return self._dict.pop(key, *default)

    def keys(self) -> list[K]:
        with self._lock:
            return list(self._dict)

    def __iter__(self) -> Iterator[K]:
        return iter(self.keys())

    def random_keys(self, count: int = 1) -> list[K]:
        """Up to ``count`` random keys outside the pending window."""
        with self._lock:
            now = time.time()
            for k in [k for k, exp in self._pending.items() if exp <= now]:
                del self._pending[k]
            free_slots = self.max_pending - len(self._pending)
            if free_slots <= 0:
                return []
            eligible = [k for k in self._dict if k not in self._pending]
            if not eligible:
                return []
            chosen = self._rng.sample(
                eligible, min(count, free_slots, len(eligible)))
            expiry = now + self.pending_timeout
            for k in chosen:
                self._pending[k] = expiry
            return chosen
