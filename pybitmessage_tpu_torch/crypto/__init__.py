"""Receive-side crypto of the port: batch ECDSA verification and ECIES
trial decryption (``batch.BatchCryptoEngine``, behind the negative
``screen``) over the secp256k1 kernels on the card (``gpu.CudaSecp``),
bulk key derivation for the address grinders (``keys.priv_to_pub_many``),
and the host-side pure-Python pieces (``fallback``, ``keys``,
``signing``, ``ecies``)."""
