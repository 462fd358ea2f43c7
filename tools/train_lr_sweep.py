#!/usr/bin/env python3
"""The training loss over a few steps at each of several learning rates,
on the card: starcoder2-7b at full width cut to 8 of its 32 layers (AdamW),
SyntheticSource batches of 4 x 2,048 tokens, built as smoke phase 6a builds
it (``chip_smoke.train_model``, the same seeded weights) and stepped
through ``launch/train.py``'s ``step_fn``.

    python3 tools/train_lr_sweep.py 3e-4 1e-5 [--steps 8]
    python3 tools/train_lr_sweep.py 3e-4 --steps 3 --backend torch --f32
    python3 tools/train_lr_sweep.py 1e-5 --steps 2 --moved

``--backend torch`` runs the plain attention (autograd through the
reference's chunked schedule) in place of the flash kernels; ``--f32``
trains a float32 copy of the same weights; ``--moved`` also prints, for
each step, the share of parameter elements whose value the step changed.
Prints one line per learning rate: the losses, grad norms and wall time.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("lr", nargs="+", type=float)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--moved", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import train
    dtype = torch.float32 if args.f32 else torch.bfloat16
    for lr in args.lr:
        cfg, model = chip_smoke.train_model(torch, chip_smoke.TRAIN_LAYERS,
                                            lr=lr, dtype=dtype,
                                            backend=args.backend)
        data = SyntheticSource(DataConfig(
            vocab=cfg.vocab, seq_len=chip_smoke.TRAIN_SEQ,
            global_batch=chip_smoke.TRAIN_BATCH, seed=0))
        state, losses, norms, moved = model.init_opt(), [], [], []
        t0 = time.perf_counter()
        for step in range(args.steps):
            before = [p.detach().clone() for p in model.parameters()] \
                if args.moved else None
            state, metrics = train.step_fn(model, state, step,
                                           data.batch(step))
            losses.append(round(float(metrics["loss"]), 4))
            norms.append(round(float(metrics["grad_norm"]), 4))
            if before is not None:
                n = sum(int((p.detach() != b).sum())
                        for p, b in zip(model.parameters(), before))
                total = sum(p.numel() for p in model.parameters())
                moved.append(round(n / total, 4))
                del before
        print(f"lr {lr:g} ({args.backend}, {str(dtype)[6:]}): losses "
              f"{losses}, grad norms {norms}"
              + (f", share of elements moved {moved}" if args.moved else "")
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        del model, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
