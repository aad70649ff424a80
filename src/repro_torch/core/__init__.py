"""repro_torch.core — the selected-inversion stack of the port: host
analysis (copies of the JAX package's numpy modules), the overlapped
sweep on a single-card virtual mesh (``pselinv_dist``) and the session
API (``engine``). Submodules are imported on use, so the host modules
load without touching the device code."""
