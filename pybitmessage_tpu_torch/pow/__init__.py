"""PoW send path of the port: pipeline, dispatcher and coalescing service."""
