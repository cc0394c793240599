"""Relay replica sets: the edge-side failover unit (copy of
``pybitmessage_tpu.roles.replica``).

Several relays declaring the same stream shard form that stream's
replica set.  Replication is active-active fan-to-all: an edge
enqueues every accepted record on every member link of the owning set,
and the relay's hash dedupe absorbs the duplication.

Each member is ranked by a three-rung health ladder (worst rung wins):

====  =========  ====================================================
rung  verdict    trigger
====  =========  ====================================================
2     ok         connected, breaker closed, ack/RTT within bounds
1     degraded   PING RTT EWMA or oldest-un-acked-frame age past the
                 degraded thresholds: serving, but slow
0     down       disconnected or ``role.ipc`` breaker open
====  =========  ====================================================

A ``down`` member's queued and un-acked records are re-routed to its
healthy siblings (zero loss), and FETCH traffic prefers the healthiest
member.  Exported as ``role_replica_health{stream,replica}``.
"""

from __future__ import annotations

from ..observability import REGISTRY
from ..observability.metrics import peer_bucket_label
from .streams import shard_members

HEALTH_OK = 2
HEALTH_DEGRADED = 1
HEALTH_DOWN = 0

#: PING round-trip EWMA past this is a degraded member, seconds
RTT_DEGRADED = 1.0
#: oldest un-acked OBJECTS frame older than this is a degraded
#: member, seconds (the relay is alive but not keeping up)
ACK_LAG_DEGRADED = 5.0

REPLICA_HEALTH = REGISTRY.gauge(
    "role_replica_health",
    "Per-replica health ladder rung (2 ok / 1 degraded / 0 down) "
    "for each stream's relay replica set",
    ("stream", "replica"))

FAILOVERS = REGISTRY.counter(
    "role_replica_failover_total",
    "Records shifted from a down replica-set member to a healthy "
    "sibling (re-routed, never lost)")


class ReplicaSet:
    """One stream's member links, ranked by the health ladder."""

    def __init__(self, stream: int, members: list):
        self.stream = stream
        self.members = list(members)

    def healthy(self) -> list:
        """Members currently above ``down``, healthiest first."""
        ranked = [(m.health(), i, m)
                  for i, m in enumerate(self.members)]
        ranked.sort(key=lambda t: (-t[0], t[1]))
        return [m for rung, _, m in ranked if rung > HEALTH_DOWN]

    def primary(self):
        """The healthiest member (control traffic: FETCH, PING), or
        the first member when the whole set is down (its outbox still
        banks records for the reconnect)."""
        healthy = self.healthy()
        if healthy:
            return healthy[0]
        return self.members[0] if self.members else None

    def fan(self, record: bytes) -> int:
        """Enqueue one encoded record on every member; returns the
        member count (0 = no route known yet)."""
        for member in self.members:
            member.enqueue(record)
        return len(self.members)

    def export_health(self) -> None:
        """Refresh the ``role_replica_health`` gauge for this set."""
        stream = str(self.stream)
        for member in self.members:
            REPLICA_HEALTH.labels(
                stream=stream,
                replica=peer_bucket_label("role.ipc", member.addr),
            ).set(member.health())

    def snapshot(self) -> dict:
        return {
            "stream": self.stream,
            "members": [{
                "relay": m.addr,
                "health": m.health(),
                "rttMs": round(m.rtt * 1000, 1)
                if m.rtt is not None else None,
                "ackLagS": round(m.ack_lag(), 3),
            } for m in self.members],
        }


def build_replica_sets(links: list, streams) -> dict:
    """``{stream: ReplicaSet}`` over the links' learned shard maps —
    rebuilt whenever any link's ``HELLO_ACK``/``SHARD_UPDATE`` changes
    its owned set.  ``streams`` is the edge's accepted set; streams a
    relay owns beyond it are included so re-routes always have a
    table entry."""
    universe = set(streams)
    for link in links:
        universe.update(link.relay_streams)
    table = {lk: lk.relay_streams for lk in links}
    return {s: ReplicaSet(s, shard_members(s, table))
            for s in sorted(universe)}
