"""repro_torch.examples — the port's twins of the JAX package's
``examples/`` that need no LM stack, each run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``quickstart``, ``pselinv_engine``, ``pselinv_serve`` and
``tree_gradient_sync``; by default on the card."""
