"""The socket protocol of the port: framed peer connections
(``connection.BMConnection``), the connection pool with its dial,
inv, download and maintenance loops (``pool``), the wire codecs
(``messages``), the download trackers, dandelion routing, rate buckets
and pooled receive buffers."""
