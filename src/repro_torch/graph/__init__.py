"""Graph substrate: static CSR, the diff-CSR dynamic graph, update batches."""
from repro_torch.graph.csr import (CSR, INF_W, INT, build_csr, grid_graph,
                                   rmat_graph, row_searchsorted,
                                   uniform_graph)
from repro_torch.graph.diffcsr import (DynGraph, compact, from_csr, is_edge,
                                       merge, update_csr_add, update_csr_del)
from repro_torch.graph.updates import UpdateBatch, UpdateStream, random_updates

__all__ = [
    "CSR", "INF_W", "INT", "build_csr", "grid_graph", "rmat_graph",
    "row_searchsorted", "uniform_graph", "DynGraph", "compact", "from_csr",
    "is_edge", "merge", "update_csr_add", "update_csr_del", "UpdateBatch",
    "UpdateStream", "random_updates",
]
