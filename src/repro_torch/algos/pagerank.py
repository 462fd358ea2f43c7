"""Dynamic PageRank — paper Fig. 20, staged against the engine interface
(counterpart of ``repro.algos.pagerank``).

The dynamic variant re-iterates PR only over the ``modified`` set, where
``modified`` is BFS-propagated (propagateNodeFlags) from the endpoints of
the update batch to everything reachable — the paper's affected-subgraph
detection.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.engine import Engine, Props
from repro_torch.core.ir import EdgeSweep, Reduce
from repro_torch.graph.csr import INT
from repro_torch.graph.updates import UpdateStream
from repro_torch.tensors import set_drop

F32 = torch.float32


def _pr_sweep(n_real: int, delta: float) -> EdgeSweep:
    def edge_fn(s, d, w):
        contrib = s["pr"] * s["inv_outdeg"]
        elig = d["modified"]
        return {"acc": (contrib, elig)}

    def post_fn(p, red, hit):
        val = (1.0 - delta) / n_real + delta * red["acc"]
        active = p["modified"] & p["real"]
        return {
            **p,
            "pr": torch.where(active, val, p["pr"]),
            "_absdiff": torch.where(active, (val - p["pr"]).abs(), 0.0),
        }

    return EdgeSweep(edge_fn=edge_fn, reduces={"acc": Reduce("sum")},
                     post_fn=post_fn,
                     gather_form={"acc": (
                         lambda p: p["pr"] * p["inv_outdeg"], False)})


def _iterate(engine: Engine, g, props: Props, beta: float, delta: float,
             max_iter: int) -> Props:
    sw = _pr_sweep(engine.n_real, delta)
    props = dict(props)
    props["_absdiff"] = engine.full(0.0, F32)

    def cond_fn(p, it, col):
        return (it == 0) | (col.sum(p["_absdiff"]) > beta)

    props = engine.fixed_point(g, sw, props, cond_fn, max_iter)
    props.pop("_absdiff")
    return props


def init_props(engine: Engine) -> Props:
    n = engine.n_real
    real = torch.arange(engine.n_pad, dtype=INT, device=engine.device) < n
    return {
        "pr": torch.where(real, 1.0 / n, 0.0).to(F32),
        "real": real,
        "modified": real,
        "inv_outdeg": engine.full(0.0, F32),
    }


def _with_degrees(engine: Engine, g, props: Props) -> Props:
    deg = engine.out_degrees(g).to(F32)
    return {**props, "inv_outdeg": torch.where(deg > 0, 1.0 / deg, 0.0)}


def static_pr(engine: Engine, g, beta: float = 1e-3, delta: float = 0.85,
              max_iter: int = 100) -> Props:
    props = init_props(engine)
    props = _with_degrees(engine, g, props)
    return _iterate(engine, g, props, beta, delta, max_iter)


def _seed(engine: Engine, src, dst, mask):
    """A vertex map flagging both endpoints of the batch's active lanes."""
    n = engine.n_pad

    def fn(p: Props) -> Props:
        m = set_drop(torch.zeros_like(p["modified"]),
                     torch.where(mask, dst, n), True)
        return {**p, "modified": set_drop(m, torch.where(mask, src, n),
                                          True)}

    return fn


@functools.lru_cache(maxsize=None)
def make_stream_step(beta: float = 1e-3, delta: float = 0.85,
                     max_iter: int = 100):
    """The per-ΔG-batch body with the PR knobs bound, for
    ``Engine.run_stream``.  lru_cached so repeated calls with the same
    knobs return one step object."""

    def stream_step(engine: Engine, g, batch, props: Props):
        # Both endpoints seed the affected set: the destination's in-edge
        # set changed, and the source's out-degree changed (which rescales
        # its contribution to *all* of its out-neighbors).
        # --- decremental half ----------------------------------------------
        props = engine.vertex_map(g, _seed(engine, batch.del_src,
                                           batch.del_dst, batch.del_mask),
                                  props)
        props = engine.propagate_flags(g, props, "modified")
        g = engine.update_del(g, batch)
        props = _with_degrees(engine, g, props)
        props = _iterate(engine, g, props, beta, delta, max_iter)

        # --- incremental half ----------------------------------------------
        props = engine.vertex_map(g, _seed(engine, batch.add_src,
                                           batch.add_dst, batch.add_mask),
                                  props)
        props = engine.propagate_flags(g, props, "modified")  # paper order:
        g = engine.update_add(g, batch)                       # flags first,
        props = _with_degrees(engine, g, props)               # then CSR add
        props = _iterate(engine, g, props, beta, delta, max_iter)
        return g, props

    return stream_step


def dyn_pr(engine: Engine, g, stream: UpdateStream, batch_size: int,
           beta: float = 1e-3, delta: float = 0.85, max_iter: int = 100,
           props: Props | None = None):
    if props is None:
        props = static_pr(engine, g, beta, delta, max_iter)
    step = make_stream_step(beta, delta, max_iter)
    for batch in stream.batches(batch_size, device=engine.device):
        g, props = step(engine, g, batch, props)
    return g, props


def dyn_pr_stream(engine: Engine, g, stream: UpdateStream, batch_size: int,
                  beta: float = 1e-3, delta: float = 0.85,
                  max_iter: int = 100, props: Props | None = None, **kw):
    """dyn_pr through the engine's stream executor."""
    if props is None:
        props = static_pr(engine, g, beta, delta, max_iter)
    step = make_stream_step(beta, delta, max_iter)
    return engine.run_stream(g, stream, batch_size, step, props, **kw)
