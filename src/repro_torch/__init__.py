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
multi-tenant ``repro_torch.serve.SessionPool``.
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
    "compile", "CompiledProgram", "Session", "SessionResult",
    "restore_session", "dsl_programs", "GraphSession", "bind_graph",
    "props_from_numpy", "available_backends",
    "make_engine", "register_engine", "CSR", "UpdateBatch", "UpdateStream",
    "build_csr", "random_updates", "rmat_graph",
]
