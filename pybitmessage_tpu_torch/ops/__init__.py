"""Device layer of the port: int64 SHA-512 in torch, the CUDA nonce-search
kernels (``sha512_cuda``, sources in ``csrc/``) and their host loops."""
