"""Hand-written Hopper kernels of the port and their wrappers.

``block_gemm``, ``trsm``, ``rmsnorm`` and ``flash_attention`` each wrap
one CUDA C++ kernel in ``csrc/`` (built on first CUDA use by ``_build``)
beside its plain PyTorch version and a launch counter; ``ops`` holds the
public names of the JAX package's ``repro/kernels/ops.py`` on top of
them, ``ref`` the plain PyTorch oracles and ``bench`` the per-kernel
benchmark. Importing any of them needs no CUDA toolkit."""
