"""Fault-tolerant training loop (counterpart of ``repro/launch/train.py``).

PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
    --reduced --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt --device cpu

The reference's loop and CLI: the deterministic data pipeline
(``repro_torch.data.pipeline``: batches a pure function of seed and
step), ``Model.train_step`` (rematerialised units, the chunked
cross-entropy, the arch's optimizer), step-granular atomic checkpoints
of ``(params, opt_state)`` in the reference's tree (each unit position's
leaves stacked over the repeat axis, dict keys sorted; bf16 leaves as
``ckpt/checkpoint.py`` stores them) with resume from the latest one, an
injected failure (``--fail-at``) and the elastic restart loop
(``--elastic``, ``launch/elastic.run_elastic``).  A float32 run of
``repro`` (``--f32``) resumes here from its checkpoint.

Added: ``--backend {cuda,torch}`` (``cuda``: attention through the flash
kernel and its hand-written backward) and ``--device`` (the card unless
``--device cpu``; raises where there is none).  ``--mesh``
and ``--model-parallel`` shard the reference's step over a device mesh;
here they raise (ROADMAP Queue 1 item 14f).  Weights come from a
``torch.Generator`` seeded with ``--seed`` on the model's device, so they
are not the reference's (its ``jax.random`` draws); the data is.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.archs import REGISTRY, get_arch
from repro_torch.configs.reduced import reduced
from repro_torch.data.pipeline import DataConfig, SyntheticSource, iterate
from repro_torch.models.layers import BACKENDS
from repro_torch.models.model import (Model, load_params, opt_state_from_jax,
                                      opt_state_to_jax, params_to_jax)
from repro_torch.tensors import resolve_device


def build(args):
    """(config, model with seeded random weights)."""
    if args.mesh or args.model_parallel != 1:
        raise NotImplementedError("--mesh / --model-parallel shard the step "
                                  "over a device mesh: ROADMAP Queue 1 item "
                                  "14f (sharding), not ported")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    model = Model(cfg, dtype=torch.float32 if args.f32 else torch.bfloat16,
                  device=dev, backend=args.backend, lr=args.lr)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    return cfg, model


def step_fn(model: Model, state, step: int, batch: dict):
    """One training step on a host batch (numpy arrays)."""
    batch = {k: torch.from_numpy(v).to(model.device, non_blocking=True)
             for k, v in batch.items()}
    return model.train_step(state, step, batch)


def _save(args, step: int, model: Model, state, next_step: int) -> None:
    ckpt.save(args.ckpt, step, (params_to_jax(model),
                                opt_state_to_jax(model, state)),
              extra={"step": next_step})


def train(args) -> dict:
    cfg, model = build(args)
    data = SyntheticSource(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    state = model.init_opt()
    start = ckpt.latest_step(args.ckpt) if args.ckpt else None
    if start is not None:
        example = (params_to_jax(model), opt_state_to_jax(model, state))
        (params, state_tree), extra = ckpt.restore(args.ckpt, start, example)
        load_params(model, params)
        state = opt_state_from_jax(model, state_tree)
        step0 = int(extra.get("step", start))
        print(f"[train] resumed from step {step0}")
    else:
        step0 = 0

    losses = []
    t0 = time.time()
    it = iterate(data, start_step=step0)
    for step, batch in it:
        if step >= args.steps:
            break
        state, metrics = step_fn(model, state, step, batch)
        if args.fail_at is not None and step == args.fail_at:
            raise RuntimeError("injected failure (elastic test)")
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s)", flush=True)
        if args.ckpt and step > 0 and step % args.ckpt_every == 0:
            _save(args, step, model, state, step + 1)
    it.close()
    if args.ckpt:
        _save(args, args.steps, model, state, args.steps)
    return {"losses": losses, "params": params_to_jax(model),
            "model": model, "state": state}


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=list(REGISTRY))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", action="store_true",
                    help="shard over all host devices (item 14f: raises)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (elastic test)")
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--backend", default="cuda", choices=BACKENDS)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    return ap


def main():
    args = parser().parse_args()
    if args.elastic:
        from repro_torch.launch.elastic import run_elastic
        run_elastic(train, args)
    else:
        train(args)


if __name__ == "__main__":
    main()
