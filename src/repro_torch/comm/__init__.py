"""repro_torch.comm — the paper's tree-based restricted collectives over
``torch.distributed`` point-to-point rounds (``p2p``), the port of
``repro.comm``. Importing it starts no process and joins no group."""
from .treecomm import (tree_broadcast, tree_reduce, tree_allreduce,
                       subset_broadcast, subset_reduce, batched_rounds)
from .hierarchical import hierarchical_allreduce, cross_pod_tree_allreduce

__all__ = [
    "tree_broadcast", "tree_reduce", "tree_allreduce",
    "subset_broadcast", "subset_reduce", "batched_rounds",
    "hierarchical_allreduce", "cross_pod_tree_allreduce",
]
