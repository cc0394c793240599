"""Dandelion stem/fluff privacy routing state (copy of
``pybitmessage_tpu.network.dandelion``).

Reference: src/network/dandelion.py — locally-generated (or stem-relayed)
objects first travel a "stem" of single-peer hops, then "fluff" into
normal flooding after a Poisson timeout, defeating origin triangulation.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

MAX_STEMS = 2
#: fluff after 10 + Exp(mean 30) seconds (reference dandelion.py:43-50)
FLUFF_TRIGGER_FIXED_DELAY = 10
FLUFF_TRIGGER_MEAN_DELAY = 30
#: re-shuffle stem routes every 10 minutes (dandelion.py:182-196)
REASSIGN_INTERVAL = 600


@dataclass
class Stem:
    child: Any  # the connection this hash stems to (None = fluff now)
    stream: int
    timeout: float


class Dandelion:
    def __init__(self, enabled: bool = True, stem_probability: int = 90):
        self.enabled = enabled
        #: percent chance a new object enters stem phase (default.ini:36)
        self.stem_probability = stem_probability if enabled else 0
        self._lock = threading.RLock()
        self._hash_map: dict[bytes, Stem] = {}
        self._stems: list[Any] = []       # our stem child connections
        self._node_map: dict[Any, Any] = {}  # upstream -> assigned child
        self._last_reassign = time.time()

    def _timeout(self) -> float:
        return time.time() + FLUFF_TRIGGER_FIXED_DELAY + \
            random.expovariate(1.0 / FLUFF_TRIGGER_MEAN_DELAY)

    # -- stem topology -------------------------------------------------------

    def maybe_add_stem(self, connection) -> None:
        with self._lock:
            if len(self._stems) < MAX_STEMS and connection not in self._stems:
                self._stems.append(connection)

    def remove_connection(self, connection) -> None:
        with self._lock:
            if connection in self._stems:
                self._stems.remove(connection)
            self._node_map = {k: v for k, v in self._node_map.items()
                              if v is not connection and k is not connection}
            for h, stem in list(self._hash_map.items()):
                if stem.child is connection:
                    # fluff immediately: stem broke
                    self._hash_map[h] = Stem(None, stem.stream, 0)

    def stem_for(self, source) -> Optional[Any]:
        """Pick (and persist) the stem child for an upstream source."""
        with self._lock:
            if not self._stems:
                return None
            if source not in self._node_map:
                self._node_map[source] = random.choice(self._stems)
            return self._node_map[source]

    # -- per-object state ----------------------------------------------------

    def add_hash(self, hash_: bytes, stream: int = 1, source=None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._hash_map[hash_] = Stem(
                self.stem_for(source), stream, self._timeout())

    def in_stem_phase(self, hash_: bytes) -> bool:
        with self._lock:
            return hash_ in self._hash_map

    def child_for(self, hash_: bytes):
        with self._lock:
            stem = self._hash_map.get(hash_)
            return stem.child if stem else None

    def expire_fluffed(self) -> list[tuple[bytes, int]]:
        """Hashes whose stem timer ran out — flood them now."""
        now = time.time()
        with self._lock:
            out = [(h, s.stream) for h, s in self._hash_map.items()
                   if s.timeout <= now or s.child is None]
            for h, _ in out:
                del self._hash_map[h]
            return out

    def maybe_reassign(self, connections: list) -> None:
        with self._lock:
            if time.time() - self._last_reassign < REASSIGN_INTERVAL:
                return
            self._last_reassign = time.time()
            candidates = [c for c in connections
                          if getattr(c, "services", 0) & 8]  # NODE_DANDELION
            random.shuffle(candidates)
            self._stems = candidates[:MAX_STEMS]
            self._node_map.clear()
