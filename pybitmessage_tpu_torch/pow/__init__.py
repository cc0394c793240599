"""PoW of the port: the send path (pipeline, dispatcher, coalescing
service) and the batched verification of received objects
(``verify_service``)."""
