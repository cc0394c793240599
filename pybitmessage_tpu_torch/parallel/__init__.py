"""Multi-device PoW search (twin of ``pybitmessage_tpu.parallel``).

The nonce range is partitioned over the shards of a
:class:`~.mesh.DeviceMesh` (cards, several streams of one card, or CPU
devices for the plain versions), and the lowest shard with a hit wins.
``pow_pallas_sharded`` runs the card's kernels on every shard and is the
dispatcher's multi-device tier; ``pow_sharded`` is the twin of the JAX
XLA tier in plain torch.  The JAX ``_compat`` shim (the spelling of
``shard_map`` across JAX versions) has no twin: nothing here is traced.
"""

from .mesh import DeviceMesh, make_mesh  # noqa: F401
from .pow_sharded import (  # noqa: F401
    get_sharded_batch_search, get_sharded_search, make_sharded_batch_search,
    make_sharded_search, sharded_solve, sharded_solve_batch,
)
from .pow_pallas_sharded import (  # noqa: F401
    make_pallas_sharded_batch_search, make_pallas_sharded_search,
    pallas_sharded_solve, pallas_sharded_solve_batch,
)
