"""Host seconds a value set of the prepare's ``upload`` step (the copy of
the value shards to the card), from the program's counters
``selinv_prepare_seconds_total{step="upload"}`` over
``selinv_prepare_calls_total`` (``repro_torch.obs.registry``)."""
UNIT = "s"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "host prep"
MOVES = "setup_s"


def read(run):
    try:
        from repro_torch.obs.registry import REGISTRY
    except ImportError:
        return None
    seconds = REGISTRY.get("selinv_prepare_seconds_total")
    calls = REGISTRY.get("selinv_prepare_calls_total")
    if seconds is None or calls is None or not calls.value:
        return None
    got = dict(seconds.children()).get(("upload",))
    return None if got is None else got.value / calls.value
