"""PoW consensus constants (copy of ``pybitmessage_tpu.models.constants``).

Network consensus values (reference src/defaults.py:20-24): changing
them breaks interop.
"""

DEFAULT_NONCE_TRIALS_PER_BYTE = 1000
DEFAULT_EXTRA_BYTES = 1000
#: sanity cap against absurd demanded difficulty (src/defaults.py:5-7)
RIDICULOUS_DIFFICULTY = 20000000
