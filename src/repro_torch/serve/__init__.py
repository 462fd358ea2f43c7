"""repro_torch.serve — the multi-tenant serving layer (counterpart of
``repro.serve``).

One process, one engine per backend and graph scale, many live graph
sessions: :class:`SessionPool` multiplexes independent tenants over
shared engines, batches same-shape ΔG applies into single vmapped
mega-calls (on ``cuda``: one batched merge launch a group; bit-exact vs
solo ``apply``), bounds its request queue with typed backpressure, and
spills idle sessions to disk through the checkpoint path.
"""
from repro_torch.serve.batch import (BATCH_MODES, MegaBatcher, group_key,
                                     next_pow2, tree_index, tree_stack)
from repro_torch.serve.pool import OVERLOAD_POLICIES, SessionPool

__all__ = [
    "SessionPool", "MegaBatcher", "group_key", "tree_stack", "tree_index",
    "next_pow2", "BATCH_MODES", "OVERLOAD_POLICIES",
]
