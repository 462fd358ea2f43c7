"""Dynamic SSSP — paper Fig. 21, staged against the engine interface
(counterpart of ``repro.algos.sssp``).

staticSSSP   : Bellman-Ford-style fixedPoint over modified frontier.
Incremental  : same sweep seeded from activeOnAdd vertices.
Decremental  : phase 1 parent-subtree invalidation, phase 2 push-repair.
dyn_sssp     : the Batch / OnDelete / OnAdd driver (paper Fig. 3).
"""
from __future__ import annotations

import torch

from repro_torch.core import device_loop
from repro_torch.core.engine import Engine, Props
from repro_torch.core.ir import EdgeSweep, Reduce
from repro_torch.graph.csr import INF_W, INT
from repro_torch.graph.updates import UpdateStream
from repro_torch.tensors import set_drop

NO_PARENT = -1


def _relax_sweep() -> EdgeSweep:
    """forall v filter(modified): forall nbr:
       <nbr.dist, nbr.modified_nxt, nbr.parent> = <Min(nbr.dist, v.dist+w), True, v>"""
    def edge_fn(s, d, w):
        cand = s["dist"] + w
        elig = s["modified"] & (s["dist"] < INF_W)
        return {"dist": (cand, elig)}

    def post_fn(p, red, hit):
        better = hit["dist"] & (red["dist"] < p["dist"])
        return {
            **p,
            "dist": torch.where(better, red["dist"], p["dist"]),
            "parent": torch.where(better, red["parent"], p["parent"]),
            "modified": better,           # modified = modified_nxt
        }

    return EdgeSweep(edge_fn=edge_fn,
                     reduces={"dist": Reduce("min"),
                              "parent": Reduce("argmin", of="dist")},
                     post_fn=post_fn,
                     gather_form={"dist": (
                         lambda p: torch.where(
                             p["modified"] & (p["dist"] < INF_W),
                             p["dist"], INF_W).to(INT), True)},
                     frontier="modified")


def init_props(engine: Engine, source: int) -> Props:
    iota = torch.arange(engine.n_pad, dtype=INT, device=engine.device)
    return {
        "dist": torch.where(iota == source, 0, INF_W).to(INT),
        "parent": engine.full(NO_PARENT, INT),
        "modified": iota == source,
    }


def _until_quiet(engine: Engine, g, props: Props, max_iter: int) -> Props:
    return engine.fixed_point(
        g, _relax_sweep(), props,
        cond_fn=lambda p, it, col: col.any(p["modified"]), max_iter=max_iter)


def static_sssp(engine: Engine, g, source: int,
                max_iter: int = 1 << 30) -> Props:
    return _until_quiet(engine, g, init_props(engine, source), max_iter)


def incremental(engine: Engine, g, props: Props,
                max_iter: int = 1 << 30) -> Props:
    """props['modified'] seeds the affected frontier (activeOnAdd)."""
    return _until_quiet(engine, g, props, max_iter)


def _phase1(p: Props) -> Props:
    """Invalidate the shortest-path subtree below deleted tree edges by
    chasing parent pointers to a fixed point (the decremental pre-phase):
    the reference's ``lax.while_loop`` through ``device_loop``."""
    def body(state):
        _, p = state
        par = p["parent"].clamp(0, p["parent"].shape[0] - 1)
        hitp = (p["parent"] >= 0) & p["modified"][par] & ~p["modified"]
        return hitp.any(), {
            **p,
            "dist": torch.where(hitp, INF_W, p["dist"]),
            "parent": torch.where(hitp, NO_PARENT, p["parent"]),
            "modified": p["modified"] | hitp,
        }

    return device_loop.while_loop(lambda s: s[0], body, (True, p))[1]


def decremental(engine: Engine, g, props: Props,
                max_iter: int = 1 << 30) -> Props:
    props = engine.vertex_map(g, _phase1, props)
    # Phase 2: push relaxation seeded at the repair BOUNDARY (finite-dist
    # vertices with an edge into the invalidated set); the surviving
    # labels are valid upper bounds, so it converges to the true
    # distances.
    finite = props["dist"] < INF_W
    if hasattr(engine, "src_flags_from_dst"):
        boundary = engine.src_flags_from_dst(
            g.g if hasattr(g, "g") else g, props["modified"]) & finite
    else:
        boundary = finite            # dense seed (still correct)
    return _until_quiet(engine, g, {**props, "modified": boundary}, max_iter)


# ---------------------------------------------------------------------------
# Dynamic driver (paper Fig. 3): Batch { OnDelete; updateCSRDel; Decremental;
#                                        OnAdd; updateCSRAdd; Incremental }
# ---------------------------------------------------------------------------

def stream_step(engine: Engine, g, batch, props: Props):
    """One ΔG batch: the paper's Fig. 3 loop body, engine-neutral —
    ``Engine.run_stream`` drives it batch by batch."""
    n = engine.n_pad

    def on_delete(p: Props) -> Props:
        tree_edge = (p["parent"][batch.del_dst.clamp(0, n - 1)]
                     == batch.del_src) & batch.del_mask
        tgt = torch.where(tree_edge, batch.del_dst, n)
        return {**p,
                "dist": set_drop(p["dist"], tgt, INF_W),
                "parent": set_drop(p["parent"], tgt, NO_PARENT),
                "modified": set_drop(p["modified"], tgt, True)}

    props = {**props, "modified": torch.zeros_like(props["modified"])}
    props = engine.vertex_map(g, on_delete, props)
    g = engine.update_del(g, batch)
    props = decremental(engine, g, props)

    g = engine.update_add(g, batch)

    def on_add(p: Props) -> Props:
        src_d = p["dist"][batch.add_src.clamp(0, n - 1)]
        dst_d = p["dist"][batch.add_dst.clamp(0, n - 1)]
        improves = (dst_d > src_d + batch.add_w) & batch.add_mask
        tgt = torch.where(improves, batch.add_src, n)
        return {**p, "modified": set_drop(p["modified"], tgt, True)}

    props = {**props, "modified": torch.zeros_like(props["modified"])}
    props = engine.vertex_map(g, on_add, props)
    props = incremental(engine, g, props)
    return g, props


def dyn_sssp(engine: Engine, g, source: int, stream: UpdateStream,
             batch_size: int, props: Props | None = None):
    if props is None:
        props = static_sssp(engine, g, source)
    for batch in stream.batches(batch_size, device=engine.device):
        g, props = stream_step(engine, g, batch, props)
    return g, props


def dyn_sssp_stream(engine: Engine, g, source: int, stream: UpdateStream,
                    batch_size: int, props: Props | None = None, **kw):
    """dyn_sssp through the engine's stream executor."""
    if props is None:
        props = static_sssp(engine, g, source)
    return engine.run_stream(g, stream, batch_size, stream_step, props, **kw)
