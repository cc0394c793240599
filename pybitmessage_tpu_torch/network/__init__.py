"""Object acceptance of the port: the node context, a connection pool
cut to the processor hand-off and announcements, and the object checks
a connection runs on every received object."""
