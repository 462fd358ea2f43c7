"""repro_torch — the PyTorch/CUDA port of ``repro`` (StarPlat-Dynamic).

The package mirrors ``repro``'s module layout and names; it imports
torch, numpy and scipy, and nothing of JAX or ``repro``.  Entry points
run on the card unless ``device="cpu"`` is asked for.  Backends:
``torch`` (plain tensor reference), ``cuda`` (hand-written Hopper
kernels, ``csrc/``, fused) and ``cuda_chained`` (the same engine on the
per-op kernel chain).  Algorithms: the paper's DSL programs
(``repro_torch.compile(dsl_programs.path("sssp" | "pagerank" | "tc"))``
→ ``bind`` → ``Session``, with checkpoints and ``restore_session``), and
hand-staged ``repro_torch.algos.{sssp,pagerank,triangles}`` through
``bind_graph``.  LM serving of attention + MLP models:
``repro_torch.models`` and ``repro_torch.launch.serve`` (backends
``cuda``, with the flash-attention kernel, and ``torch``).  Runtime and
serving: ``bind_graph(..., failover=True)`` (``cuda → cuda_chained →
torch``), the chaos seams of ``repro_torch.runtime.faults``, and the
multi-tenant ``repro_torch.serve.SessionPool``.  The distributed backends
``dist`` and ``dist_sharded`` (``num_shards=P`` stacked on one device,
or one shard a ``torch.distributed`` rank).
"""
from repro_torch import dsl_programs
from repro_torch.api import (CompiledProgram, GraphSession, Session,
                             SessionResult, bind_graph, compile,
                             props_from_numpy, restore_session)
from repro_torch.core.registry import (available_backends, make_engine,
                                       register_engine)
from repro_torch.graph import (CSR, UpdateBatch, UpdateStream, build_csr,
                               random_updates, rmat_graph)

__all__ = [
    "api", "serve", "compile", "CompiledProgram", "Session",
    "SessionResult", "PropertyView", "restore_session", "dsl_programs",
    "GraphSession", "bind_graph", "props_from_numpy", "available_backends",
    "make_engine", "register_engine", "SessionPool", "AdmissionError",
    "PoolOverflowError", "KernelFailure", "DivergenceError",
    "PoolSaturatedError", "SessionHealth", "PoolHealth", "CSR",
    "UpdateBatch", "UpdateStream", "build_csr", "random_updates",
    "rmat_graph",
]

# loaded on first use (PEP 562), as repro's are: the serving layer and the
# runtime's names
_LAZY = {
    "PropertyView": "repro_torch.api", "AdmissionError": "repro_torch.api",
    "PoolOverflowError": "repro_torch.api",
    "KernelFailure": "repro_torch.api", "DivergenceError": "repro_torch.api",
    "SessionHealth": "repro_torch.api", "SessionPool": "repro_torch.serve",
    "PoolSaturatedError": "repro_torch.runtime",
    "PoolHealth": "repro_torch.runtime",
}


def __getattr__(name):
    import importlib
    if name in ("api", "serve"):
        return importlib.import_module(f"repro_torch.{name}")
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
