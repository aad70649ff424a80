"""repro_torch.tools — command-line twins of the JAX package's
``tools/``: ``python -m repro_torch.tools.plan_lint`` (PlanLint over a
structure corpus), ``.exec_lint`` (the executed-communication verifier
over the same corpus, ``--baseline`` for the size lint), neither needing
a card or JAX; ``.record_bench`` (the port's bench history,
``BENCH_pselinv_torch.json``), ``.obs_report`` (a traced solve and its
per-round replay as one Chrome trace) and ``.serve_bench`` (the serving
harness), on the card unless given ``--device cpu``."""
