"""Protocol constants and PoW target math (host-only copies)."""
