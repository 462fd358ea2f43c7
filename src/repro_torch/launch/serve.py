"""Batched greedy decoding (counterpart of ``repro/launch/serve.py``): the
serving-side end-to-end path of a language model of any registered arch.

PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \\
    --reduced --f32 --device cpu

Prefill runs the prompts through ``Model.prefill_step`` (the static full
recomputation; its attention goes through the flash kernel on the
``cuda`` backend), then ``--gen`` greedy tokens come from
``Model.serve_step`` over the cache (the attention layers' k and v, the
recurrent layers' states), one token a step.  Weights and
prompts come from one ``torch.Generator`` seeded with ``--seed`` on the
model's device.  A vlm or audio arch also gets the reference's source
stand-in (``source``: ones of (B, image tokens or encoder frames, D)),
in prefill and in every decode step.

``--graph`` serves graph sessions instead (the reference's
``serve_graphs``): one ``SessionPool`` of ``--tenants`` live graphs on
an RMAT graph of scale ``--scale``, one ΔG batch per tenant per tick,
drained through the batched mega-call (``--batch-mode``):

PYTHONPATH=src python -m repro_torch.launch.serve --graph --tenants 8 \
    --ticks 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.archs import REGISTRY, get_arch
from repro_torch.configs.reduced import reduced
from repro_torch.models.layers import BACKENDS
from repro_torch.models.model import Model
from repro_torch.models.transformer import layer_specs
from repro_torch.tensors import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(args):
    """(model with seeded random weights, (B, P) prompts)."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    model = Model(cfg, dtype=torch.float32 if args.f32 else torch.bfloat16,
                  device=dev, backend=args.backend)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    return model, prompts


def source(cfg, batch: int, device):
    """The reference launcher's ``src`` stand-in: ones of (B, n_img_tokens,
    D) for a vlm, (B, enc_seq, D) for an audio arch, else None."""
    length = {"vlm": cfg.n_img_tokens, "audio": cfg.enc_seq}.get(cfg.family)
    if length is None:
        return None
    return torch.ones((batch, length, cfg.d_model), dtype=torch.float32,
                      device=device)


def prefill(model: Model, prompts, total: int, src=None):
    """Last-position logits and the cache, each attention layer's k and v
    padded to ``total`` positions (a recurrent layer's state has no
    position axis and stays as it is)."""
    logits, caches = model.prefill_step(prompts, src)
    pad = total - prompts.shape[1]
    caches = [{n: F.pad(x, (0, 0, 0, pad)) for n, x in c.items()}
              if spec["mixer"] in ("attn", "attn_local") else c
              for c, spec in zip(caches, layer_specs(model.cfg))]
    return logits, caches


def decode(model: Model, logits, caches, start: int, gen: int, src=None,
           long_mode: bool = False):
    """``gen`` greedy tokens (B, gen) int64: the first from the prefill's
    logits, each next one from ``serve_step`` at position start + i."""
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, caches = model.serve_step(caches, tok, start + i, src,
                                          long_mode)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def serve(args) -> dict:
    if args.graph:
        return serve_graphs(args)
    if args.backend not in BACKENDS:
        raise ValueError(f"--backend {args.backend!r} serves graphs only; "
                         f"the LM backends are {BACKENDS}")
    model, prompts = build(args)
    dev, cfg = model.device, model.cfg
    B, P, G = args.batch, args.prompt_len, args.gen
    src = source(cfg, B, dev)

    # ---- prefill (static recomputation over the prompt) -------------------
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(model, prompts, P + G, src)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    # ---- incremental decode ------------------------------------------------
    t0 = time.perf_counter()
    toks = decode(model, logits, caches, P, G, src)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = toks.cpu().numpy()
    tps = B * (G - 1) / max(t_decode, 1e-9)
    print(f"[serve] arch={cfg.name} B={B} prompt={P} gen={G} "
          f"backend={model.backend} device={dev}")
    print(f"[serve] prefill {t_prefill*1e3:.1f} ms "
          f"({B * P / max(t_prefill, 1e-9):.0f} tok/s)")
    print(f"[serve] decode  {t_decode*1e3:.1f} ms "
          f"({tps:.0f} tok/s, {t_decode / max(G - 1, 1) * 1e3:.1f} ms/step)")
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError("decoded a token outside the vocabulary")
    return {"tokens": toks, "logits": logits, "prefill_s": t_prefill,
            "decode_s": t_decode}


GRAPH_BACKENDS = ("cuda", "cuda_chained", "torch", "frontier")


def serve_graphs(args) -> dict:
    """The graph-session serving loop: one pool, ``--tenants`` live
    graphs, one ΔG batch per tenant per tick, drained through the
    batched mega-call.  Prints the per-tick p50/p99 (the first tick,
    which builds the kernels, is left out when there are more) and the
    pool's counters; returns the stats snapshot."""
    from repro_torch.core import registry
    from repro_torch.graph.csr import build_csr, rmat_graph
    from repro_torch.graph.updates import random_updates
    from repro_torch.serve import SessionPool

    if args.backend not in GRAPH_BACKENDS:
        raise ValueError(f"--graph --backend must be one of "
                         f"{GRAPH_BACKENDS}, got {args.backend!r}")
    dev = resolve_device(args.device)
    n, edges, w = rmat_graph(args.scale, 8, seed=args.seed)
    keep = edges[:, 0] != edges[:, 1]
    csr = build_csr(n, edges[keep], w[keep], device=dev)
    pool = SessionPool(backend=args.backend, batch_mode=args.batch_mode,
                       max_pending=4 * args.tenants, device=dev)
    streams = [random_updates(csr, 30, seed=args.seed + 1 + t)
               for t in range(args.tenants)]
    for t in range(args.tenants):
        pool.bind(f"t{t}", csr)
    print(f"[serve] graph pool: backend={args.backend} "
          f"mode={args.batch_mode} tenants={args.tenants} "
          f"n={csr.n} edges={csr.num_edges} device={dev}")

    ticks = []
    for i in range(args.ticks):
        reqs = [(f"t{t}",
                 streams[t].batch(i % streams[t].num_batches(args.batch_size),
                                  args.batch_size, device=dev))
                for t in range(args.tenants)]
        _sync(dev)
        t0 = time.perf_counter()
        pool.apply_many(reqs)
        _sync(dev)
        ticks.append(time.perf_counter() - t0)
    warm = np.asarray(ticks[1:]) if len(ticks) > 1 else np.asarray(ticks)
    p50, p99 = np.percentile(warm, [50, 99])
    stats = pool.stats()
    print(f"[serve] tick p50 {p50 * 1e3:.2f} ms  p99 {p99 * 1e3:.2f} ms  "
          f"({p50 / args.tenants * 1e6:.0f} us/session)")
    print(f"[serve] mega_calls={stats['mega_calls']} "
          f"mega_sessions={stats['mega_sessions']} "
          f"sequential_fallbacks={stats['sequential_fallbacks']} "
          f"applied={stats['applied']}")
    registry.clear_shared_engines()
    return {"p50_s": float(p50), "p99_s": float(p99), "stats": stats,
            "ticks_s": ticks}


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-7b", choices=list(REGISTRY))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--backend", default="cuda",
                    choices=sorted(set(BACKENDS) | set(GRAPH_BACKENDS)),
                    help="LM: cuda | torch; --graph: cuda | cuda_chained "
                         "| torch")
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); 'cpu' "
                         "runs the plain versions on the CPU")
    # --graph mode: a multi-tenant graph-session pool instead of LM decode
    ap.add_argument("--graph", action="store_true",
                    help="serve a pool of graph sessions instead of decode")
    ap.add_argument("--batch-mode", default="vmap",
                    choices=("vmap", "scan", "off"))
    ap.add_argument("--tenants", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--scale", type=int, default=9,
                    help="rmat graph scale (log2 nodes)")
    return ap


def main():
    serve(parser().parse_args())


if __name__ == "__main__":
    main()
