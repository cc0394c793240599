"""Persistence of the port: the SQLite message store and inventory, in
the JAX package's schema, and the write-behind buffer."""
