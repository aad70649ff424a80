"""repro_torch.tools — command-line twins of the JAX package's
``tools/``: ``python -m repro_torch.tools.plan_lint`` (PlanLint over a
structure corpus) and ``python -m repro_torch.tools.exec_lint`` (the
executed-communication verifier over the same corpus), neither needing a
card or JAX."""
