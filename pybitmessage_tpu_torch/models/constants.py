"""Protocol constants (copy of ``pybitmessage_tpu.models.constants``,
trimmed to what the node and the socket protocol use).

Reference: src/protocol.py:22-56, src/network/constants.py:7-17,
src/defaults.py:5-24.  These are network consensus values — changing them
breaks interop.
"""

MAGIC = 0xE9BEB4D9
PROTOCOL_VERSION = 3

# service flags advertised in version messages
NODE_NETWORK = 1
NODE_SSL = 2
NODE_DANDELION = 8
# set-reconciliation inventory sync — peers without the bit stay on
# classic inv flooding
NODE_SYNC = 16
# wire trace-context propagation: sync rounds and object pushes carry a
# 32-byte trace trailer so lifecycle timelines stitch across nodes —
# peers without the bit see nothing
NODE_TRACE = 32

# object types
OBJECT_GETPUBKEY = 0
OBJECT_PUBKEY = 1
OBJECT_MSG = 2
OBJECT_BROADCAST = 3
OBJECT_ONIONPEER = 0x746F72  # "tor"

# limits (src/network/constants.py)
ADDRESS_ALIVE = 10800            # seconds a peer address is considered live
MAX_ADDR_COUNT = 1000            # addresses per addr packet
MAX_MESSAGE_SIZE = 1600100       # bytes per wire message
MAX_OBJECT_PAYLOAD_SIZE = 2**18  # bytes per object payload
MAX_INV_COUNT = 50000            # inv vectors per inv packet
MAX_OBJECT_COUNT = 50000
MAX_TIME_OFFSET = 3600           # max peer clock skew

# object TTL bounds (src/network/bmobject.py:46-49)
MAX_TTL = 28 * 24 * 60 * 60      # 28 days
MIN_TTL_SLACK = 3600             # objects may be expired up to 1h
EXPIRES_GRACE = 3 * 3600         # keep up to 3h past expiry in inventory

# PoW consensus parameters (src/defaults.py:20-24)
DEFAULT_NONCE_TRIALS_PER_BYTE = 1000
DEFAULT_EXTRA_BYTES = 1000
#: sanity cap against absurd demanded difficulty (src/defaults.py:5-7)
RIDICULOUS_DIFFICULTY = 20000000

ONION_PREFIX = b"\xfd\x87\xd8\x7e\xeb\x43"
