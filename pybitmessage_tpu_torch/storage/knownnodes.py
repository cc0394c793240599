"""Known-nodes peer database with ratings and JSON persistence (copy of
``pybitmessage_tpu.storage.knownnodes``: the same ``knownnodes.json``,
so a ``data_dir`` opens in either package).

Reference: src/knownnodes.py — per-stream ``{Peer: {lastseen, rating,
self}}`` with ±0.1 rating steps clamped to [-1, 1], JSON file
persistence, a cap per stream.
"""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass
from pathlib import Path

DEFAULT_MAX_NODES = 20000
#: forget a node if not seen for 28 days (knownnodes.py:208-267)
STALE_SECONDS = 28 * 24 * 3600
#: or if older than 3 hours with a hopeless rating
PROBATION_SECONDS = 3 * 3600
FORGET_RATING = -0.5

#: bootstrap servers (reference: knownnodes.py:39-49)
DEFAULT_NODES = [
    ("bootstrap8080.bitmessage.org", 8080),
    ("bootstrap8444.bitmessage.org", 8444),
]


@dataclass(frozen=True, order=True)
class Peer:
    host: str
    port: int


class KnownNodes:
    """Thread-safe per-stream peer table."""

    def __init__(self, path: str | Path | None = None,
                 max_nodes: int = DEFAULT_MAX_NODES):
        self._lock = threading.RLock()
        #: peers first seen since the last addr-gossip flush (the
        #: reference's addrQueue feed, addrthread.py)
        self.newly_added: list = []
        self._path = Path(path) if path else None
        self._streams: dict[int, dict[Peer, dict]] = {1: {}}
        self.max_nodes = max_nodes
        if self._path and self._path.exists():
            try:
                self.load()
            except (ValueError, KeyError, TypeError, OSError):
                # A damaged peers cache must not stop the node from
                # booting; start fresh (reference tolerates legacy or
                # bad files, knownnodes.py:81-92).
                self._streams = {1: {}}

    # -- persistence ---------------------------------------------------------

    def load(self) -> None:
        with self._lock, open(self._path) as f:
            self._streams = {1: {}}
            for entry in json.load(f):
                peer = Peer(entry["peer"]["host"], int(entry["peer"]["port"]))
                info = {
                    "lastseen": int(entry["info"].get("lastseen", 0)),
                    "rating": float(entry["info"].get("rating", 0.0)),
                    "self": bool(entry["info"].get("self", False)),
                }
                self._streams.setdefault(int(entry["stream"]), {})[peer] = info

    def save(self) -> None:
        if not self._path:
            return
        with self._lock:
            out = [
                {"stream": stream,
                 "peer": {"host": p.host, "port": p.port},
                 "info": info}
                for stream, peers in self._streams.items()
                for p, info in peers.items()
            ]
            tmp = self._path.with_suffix(".tmp")
            with open(tmp, "w") as f:
                json.dump(out, f, indent=2)
            tmp.replace(self._path)

    # -- mutation ------------------------------------------------------------

    def add(self, peer: Peer, stream: int = 1, *, lastseen: int | None = None,
            is_self: bool = False) -> bool:
        """Record a peer sighting; returns False when table is full."""
        with self._lock:
            peers = self._streams.setdefault(stream, {})
            if peer in peers:
                peers[peer]["lastseen"] = int(lastseen or time.time())
                if is_self:     # an endpoint first learned via addr
                    peers[peer]["self"] = True
                return True
            if len(peers) >= self.max_nodes:
                return False
            peers[peer] = {
                "lastseen": int(lastseen or time.time()),
                "rating": 0.0,
                "self": is_self,
            }
            self.newly_added.append((peer, stream))
            return True

    def seed_defaults(self, stream: int = 1) -> None:
        for host, port in DEFAULT_NODES:
            self.add(Peer(host, port), stream)

    def increase_rating(self, peer: Peer, stream: int = 1) -> None:
        self._bump(peer, stream, +0.1)

    def decrease_rating(self, peer: Peer, stream: int = 1) -> None:
        self._bump(peer, stream, -0.1)

    def _bump(self, peer: Peer, stream: int, delta: float) -> None:
        with self._lock:
            info = self._streams.get(stream, {}).get(peer)
            if info is not None:
                info["rating"] = max(-1.0, min(1.0, info["rating"] + delta))

    # -- queries -------------------------------------------------------------

    def get(self, peer: Peer, stream: int = 1) -> dict | None:
        with self._lock:
            return self._streams.get(stream, {}).get(peer)

    def peers(self, stream: int = 1) -> list[Peer]:
        with self._lock:
            return list(self._streams.get(stream, {}))

    def count(self, stream: int = 1) -> int:
        with self._lock:
            return len(self._streams.get(stream, {}))

    def choose(self, stream: int = 1, rng: random.Random | None = None):
        """Rating-weighted random choice (reference:
        connectionchooser.py:74 — accept with p = 0.05/(1-rating))."""
        rng = rng or random
        with self._lock:
            peers = self._streams.get(stream, {})
            if not peers:
                return None
            candidates = list(peers.items())
            for _ in range(50):
                peer, info = rng.choice(candidates)
                rating = info["rating"]
                if rating > 1:
                    rating = 1
                try:
                    if 0.05 / (1.0 - rating) > rng.random():
                        return peer
                except ZeroDivisionError:
                    return peer
            return peer

    # -- lifecycle -----------------------------------------------------------

    def cleanup(self, now: float | None = None) -> int:
        """Apply the forget policy; returns number of dropped peers."""
        now = now or time.time()
        dropped = 0
        with self._lock:
            for stream, peers in self._streams.items():
                doomed = [
                    p for p, info in peers.items()
                    if (now - info["lastseen"] > STALE_SECONDS)
                    or (now - info["lastseen"] > PROBATION_SECONDS
                        and info["rating"] <= FORGET_RATING)
                ]
                for p in doomed:
                    del peers[p]
                dropped += len(doomed)
        return dropped
