"""Role registry: which subsystems each node role composes (copy of
``pybitmessage_tpu.roles.registry``: the four specs as data).

==========  ============================================================
``all``     the fused single-process node, the default
``edge``    listener sockets (``SO_REUSEPORT``-shared), framing, the
            PoW check of every received object through the node's
            ``BatchVerifier`` and a dedupe cache; accepted objects go to
            their stream's relay over the role IPC channel
``relay``   inventory authority for its stream shard, the processor and
            the sender; serves the role IPC channel and does not open
            the shared P2P listener (edges own the port)
``client``  stores and forwards nothing: no inventory, no relay links,
            no P2P listener; syncs filter digests from one edge's
            subscription plane, trial-decrypts on its own engine and
            delegates PoW through the edge
==========  ============================================================
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class RoleSpec:
    """What one role runs (consulted by ``Node.__init__``)."""

    name: str
    #: opens the shared P2P listener
    listens_p2p: bool = True
    #: owns an authoritative object store (relay/all); edges keep a
    #: bounded dedupe/serve cache instead
    owns_storage: bool = True
    #: runs the set-reconciliation sync
    runs_sync: bool = True
    #: runs the ObjectProcessor/Sender pipeline (needs identity keys)
    processes_objects: bool = True
    #: forwards accepted objects over role IPC instead of processing
    forwards_ingest: bool = False
    #: serves the role IPC channel for edge hand-offs
    serves_ipc: bool = False
    #: shares the P2P listen socket across processes
    reuse_port: bool = False
    extras: dict = field(default_factory=dict)


ROLES: dict[str, RoleSpec] = {
    "all": RoleSpec("all"),
    "edge": RoleSpec("edge", owns_storage=False, runs_sync=False,
                     processes_objects=False, forwards_ingest=True,
                     reuse_port=True),
    "relay": RoleSpec("relay", listens_p2p=False, serves_ipc=True),
    "client": RoleSpec("client", listens_p2p=False, owns_storage=False,
                       runs_sync=False, processes_objects=False),
}


def get_role(name: str) -> RoleSpec:
    try:
        return ROLES[name]
    except KeyError:
        raise ValueError("unknown node role %r (one of %s)"
                         % (name, "/".join(sorted(ROLES))))


def parse_role_streams(spec: str) -> tuple[int, ...]:
    """Parse the ``rolestreams`` setting: a comma list of stream numbers
    -> sorted unique tuple.  Empty spec -> empty tuple (the caller falls
    back to the default stream).  Raises ``ValueError`` on junk."""
    out = set()
    for entry in str(spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        value = int(entry)          # ValueError on junk
        if not 1 <= value <= 2 ** 32 - 1:
            raise ValueError("stream %d out of range" % value)
        out.add(value)
    return tuple(sorted(out))
