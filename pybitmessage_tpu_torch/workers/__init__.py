"""Node workers of the port: the keystore, the send worker, the
object processor and its crypto pool, and the cleaner."""
