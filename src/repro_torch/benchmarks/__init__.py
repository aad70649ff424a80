"""repro_torch.benchmarks — the port's twin of the JAX package's
``benchmarks/``: the paper's Table 1 and Figs 4–9 on the host model, the
kernels beside their plain versions, the tree collectives over rank
processes and the selected-inversion bench on the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu]

Every row prints as ``name,us_per_call,derived``."""
