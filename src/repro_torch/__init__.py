"""repro_torch — the PyTorch/CUDA port of ``repro`` (StarPlat-Dynamic).

The package mirrors ``repro``'s module layout and names; it imports
torch, numpy and scipy, and nothing of JAX or ``repro``.  Entry points
run on the card unless ``device="cpu"`` is asked for.  Backends:
``torch`` (plain tensor reference), ``cuda`` (hand-written Hopper
kernels, ``csrc/``, fused) and ``cuda_chained`` (the same engine on the
per-op kernel chain).  Algorithms: ``repro_torch.algos.sssp`` and
``repro_torch.algos.pagerank``.  LM serving of attention + MLP models:
``repro_torch.models`` and ``repro_torch.launch.serve`` (backends
``cuda``, with the flash-attention kernel, and ``torch``).
"""
from repro_torch.api import GraphSession, bind_graph, props_from_numpy
from repro_torch.core.registry import (available_backends, make_engine,
                                       register_engine)
from repro_torch.graph import (CSR, UpdateBatch, UpdateStream, build_csr,
                               random_updates, rmat_graph)

__all__ = [
    "GraphSession", "bind_graph", "props_from_numpy", "available_backends",
    "make_engine", "register_engine", "CSR", "UpdateBatch", "UpdateStream",
    "build_csr", "random_updates", "rmat_graph",
]
