"""Device layer of the port: int64 SHA-512 in torch, the CUDA nonce-search
kernels (``sha512_cuda``) and their host loops, the secp256k1 limb
arithmetic in torch (``secp256k1``) and its CUDA kernels
(``secp256k1_cuda``); kernel sources in ``csrc/``, built by ``_build``."""
