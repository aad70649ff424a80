"""Hand-written Hopper kernels of the port and their wrappers.

``block_gemm`` wraps the CUDA C++ kernel in ``csrc/block_gemm.cu`` (built
on first CUDA use by ``_build``), ``ops`` holds the public names of the
JAX package's ``repro/kernels/ops.py`` on top of it, and ``ref`` the plain
PyTorch oracles. Importing any of them needs no CUDA toolkit."""
