"""Dynamic Triangle Counting — paper Fig. 19, staged against the engine
(counterpart of ``repro.algos.triangles``).

TC assumes a symmetrized (undirected) graph, as in the paper's evaluation.

staticTC   : node-iterator  Σ_v Σ_{u∈N(v),u<v} Σ_{w∈N(v),w>v} edge(u,w)
Incremental: per added edge (v1,v2), wedges through v3∈N(v1), with the
             count1/2 + count2/4 + count3/6 multiplicity dedup.
Decremental: same enumeration on the *pre-deletion* graph, subtracted.

Counts are int32 0-d tensors, as the reference's are.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import Engine
from repro_torch.graph.updates import UpdateStream

I64 = torch.int32      # the reference's name and width (``jnp.int32``)


def _zero(engine: Engine) -> torch.Tensor:
    return torch.zeros((), dtype=I64, device=engine.device)


def static_tc(engine: Engine, g) -> torch.Tensor:
    def pair_fn(x, y, z, z_ok, ctx):
        # lane edge is (v=x, u=y); z=w enumerates N(v).
        valid = z_ok & (y < x) & (z > x)
        tri = valid & ctx.is_edge(y, z)
        return tri.to(I64)

    return engine.count_wedges(g, pair_fn, lane_flags={},
                               out_example=_zero(engine))


def _delta_counts(engine: Engine, g, flag_name: str, lane_flags):
    """Shared incremental/decremental wedge count (paper's count1/2/3)."""
    def pair_fn(x, y, z, z_ok, ctx):
        lane_new = ctx.lane_flag(flag_name)        # (v1,v2) is an update edge
        valid = z_ok & lane_new & (z != x) & (z != y)
        e1_new = ctx.nbr_flag(flag_name)           # (v1,v3) modified?
        tri = valid & ctx.is_edge(y, z)
        e2_new = ctx.edge_flag(flag_name, y, z)    # (v2,v3) modified?
        new_edges = 1 + e1_new.to(I64) + e2_new.to(I64)
        c1 = (tri & (new_edges == 1)).to(I64)
        c2 = (tri & (new_edges == 2)).to(I64)
        c3 = (tri & (new_edges == 3)).to(I64)
        return (c1, c2, c3)

    zeros = (_zero(engine),) * 3
    c1, c2, c3 = engine.count_wedges(g, pair_fn, lane_flags=lane_flags,
                                     out_example=zeros)
    return c1 // 2 + c2 // 4 + c3 // 6


def stream_step(engine: Engine, g, batch, count):
    """One ΔG batch of dynamic TC; the carry is the running count."""
    # --- decremental: count on the pre-deletion graph, then delete --------
    del_flags = engine.batch_edge_flags(g, batch.del_src, batch.del_dst,
                                        batch.del_mask)
    count = count - _delta_counts(engine, g, "mod", {"mod": del_flags})
    g = engine.update_del(g, batch)

    # --- incremental: add edges, flag them, count on the new graph --------
    g = engine.update_add(g, batch)
    add_flags = engine.batch_edge_flags(g, batch.add_src, batch.add_dst,
                                        batch.add_mask)
    count = count + _delta_counts(engine, g, "mod", {"mod": add_flags})
    return g, count


def dyn_tc(engine: Engine, g, stream: UpdateStream, batch_size: int,
           count=None):
    if count is None:
        count = static_tc(engine, g)
    for batch in stream.batches(batch_size, device=engine.device):
        g, count = stream_step(engine, g, batch, count)
    return g, count


def dyn_tc_stream(engine: Engine, g, stream: UpdateStream, batch_size: int,
                  count=None, **kw):
    """dyn_tc through the engine's stream executor."""
    if count is None:
        count = static_tc(engine, g)
    count = torch.as_tensor(count, dtype=I64, device=engine.device)
    return engine.run_stream(g, stream, batch_size, stream_step, count, **kw)
