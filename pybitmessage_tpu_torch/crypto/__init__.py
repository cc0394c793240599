"""Receive-side crypto of the port: batch ECDSA verification and ECIES
trial decryption (``batch.BatchCryptoEngine``) over the secp256k1
kernels on the card (``gpu.CudaSecp``), with the host-side pieces they
need (``fallback``, ``keys``, ``signing``, ``ecies``)."""
