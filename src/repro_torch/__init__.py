"""repro_torch — the PyTorch/CUDA port of ``repro`` (parallel selected
inversion with tree-based restricted collectives), run on one NVIDIA
Hopper card. The JAX package ``repro`` stays the reference; this package
imports neither it nor JAX."""
__version__ = "0.1.0"
