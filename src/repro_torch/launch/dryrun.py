"""Dry run of every (arch × shape) cell at full size on the meta device: the
counterpart of ``repro/launch/dryrun.py``.

For each cell of ``configs.archs.cells()`` this builds the model, its
optimizer state, its cache and its batch on ``torch.device("meta")``
(nothing is allocated), runs the cell's step once under
``launch/op_cost.CostCounter`` on the ``cuda`` backend (the hand kernels
record their rules and compute nothing there) and records:

* ``cost``: the counter's ``cost_record()`` (FLOPs, HBM bytes and
  collective bytes of the step, by op and by kernel);
* ``argument_bytes``: params, optimizer state (train), cache (decode) and
  inputs, each exactly, from the tensors' sizes;
* ``peak_bytes_estimate``: the arguments plus the peak of the storages
  the step's ops hold live at once;
* ``model_flops``: 6 · N_active · tokens for train, 2 · N_active · tokens
  for prefill, 2 · N_active · B for decode (the reference's
  ``benchmarks/roofline.py`` rule; N_active is N where no MoE);
* ``bound_s``: ``op_cost.bound_s`` of the record, on one H100 SXM;
* ``n_chips``: 1.

Where the reference compiles each cell for a 256- or 512-chip mesh, the
port runs on one card: ``--mesh`` raises until the sharding item (ROADMAP
Queue 1 item 14f).  The steps are the reference's: ``train_step`` with
the arch's optimizer, ``prefill_step``, ``serve_step`` at the cache's last
slot (``long_mode`` for ``long_500k``).

Results are written to ``dryrun_out/dryrun.json`` at the checkout's root
(git-ignored; ``--out`` elsewhere), one record per cell under the key
``arch|shape`` (``|opt`` appended under ``--tuning opt``), after each
cell, so an interrupted sweep resumes where it stopped (``--force``
recounts the cells it would skip).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--tuning baseline|opt] [--force] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs.archs import REGISTRY, SHAPES, cells
from repro_torch.launch.op_cost import CostCounter, bound_s, nbytes
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.models.tuning import BASELINE, OPTIMIZED

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "dryrun_out" / \
    "dryrun.json"
META = torch.device("meta")
TUNINGS = {"baseline": BASELINE, "opt": OPTIMIZED}


def model_flops(cfg, shape) -> float:
    """The reference's 6·N·D roofline numerator of one step."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch


def source_len(cfg) -> int:
    """The source length a vlm or audio arch reads, else 0."""
    return {"vlm": cfg.n_img_tokens, "audio": cfg.enc_seq}.get(cfg.family, 0)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested list / dict / tuple."""
    if torch.is_tensor(tree):
        return nbytes(tree)
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(tree_bytes(t) for t in items)


def build_cell(arch: str, shape_name: str, tuning: str = "baseline",
               device=META) -> dict:
    """The model, its step's arguments and the step itself, for one cell:
    {"model", "args": {name: tensors}, "step": callable}."""
    cfg, shape = REGISTRY[arch], SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    model = Model(cfg, dtype=torch.bfloat16, device=device, backend="cuda",
                  tuning=TUNINGS[tuning])
    model.params = T.init_params(cfg, torch.bfloat16, model.device)
    T_src = source_len(cfg)
    src = torch.empty((B, T_src, cfg.d_model), dtype=torch.bfloat16,
                      device=model.device) if T_src else None
    if shape.kind == "train":
        tok = torch.empty((B, S), dtype=torch.int32, device=model.device)
        batch = {"tokens": tok, "labels": tok.clone()}
        if src is not None:
            batch["src"] = src
        opt = model.init_opt()
        args = {"opt_state": opt, "inputs": batch}
        step = lambda: model.train_step(opt, 0, batch)
    elif shape.kind == "prefill":
        tok = torch.empty((B, S), dtype=torch.int32, device=model.device)
        args = {"inputs": [tok] + ([] if src is None else [src])}
        step = lambda: model.prefill_step(tok, src)
    else:
        cache = T.init_cache(cfg, B, S, torch.bfloat16, model.device)
        tok = torch.empty((B, 1), dtype=torch.int32, device=model.device)
        args = {"cache": cache,
                "inputs": [tok] + ([] if src is None else [src])}
        long_mode = shape_name == "long_500k"
        step = lambda: model.serve_step(cache, tok, S - 1, src, long_mode)
    args["params"] = list(model.parameters())
    return {"model": model, "args": args, "step": step}


def count_cell(arch: str, shape_name: str, tuning: str = "baseline") -> dict:
    """One cell's record (see the module doc), counted on meta."""
    cell = build_cell(arch, shape_name, tuning)
    arg_bytes = {k: tree_bytes(v) for k, v in sorted(cell["args"].items())}
    with CostCounter() as counter:
        cell["step"]()
    cost = counter.cost_record()
    return {"cost": cost, "argument_bytes": arg_bytes,
            "peak_bytes_estimate": sum(arg_bytes.values()) +
            cost["peak_live_bytes"],
            "model_flops": model_flops(REGISTRY[arch], SHAPES[shape_name]),
            "bound_s": bound_s(cost), "n_chips": 1}


def load_results(path: pathlib.Path) -> dict:
    return json.loads(path.read_text()) if path.exists() else {}


def save_results(path: pathlib.Path, res: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1, sort_keys=True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--tuning", default="baseline", choices=list(TUNINGS),
                    help="baseline = the paper-faithful dispatch and cache "
                         "read; opt = models/tuning.py's OPTIMIZED")
    ap.add_argument("--mesh", default=None, choices=["single", "multi"],
                    help="not ported: the device meshes come with ROADMAP "
                         "Queue 1 item 14f")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=pathlib.Path, default=RESULTS)
    args = ap.parse_args(argv)
    if args.mesh is not None:
        raise NotImplementedError(
            "--mesh: the port counts one card; the production meshes wait "
            "for the sharding item (ROADMAP Queue 1 item 14f)")

    res = load_results(args.out)
    todo = [(a, s) for (a, s) in cells()
            if args.arch in (None, a) and args.shape in (None, s)]
    print(f"dry-run: {len(todo)} cells on meta, tuning {args.tuning}")
    t_all = time.perf_counter()
    for arch, shape_name in todo:
        key = f"{arch}|{shape_name}"
        if args.tuning != "baseline":
            key += f"|{args.tuning}"
        if key in res and res[key].get("ok") and not args.force:
            print(f"[skip] {key}")
            continue
        t0 = time.perf_counter()
        try:
            rec = count_cell(arch, shape_name, args.tuning)
            rec["ok"] = True
            rec["count_s"] = round(time.perf_counter() - t0, 2)
            c = rec["cost"]
            print(f"[ok]   {key}  flops={c['flops_per_device']:.3e} "
                  f"bytes={c['bytes_per_device']:.3e} "
                  f"model_flops={rec['model_flops']:.3e} "
                  f"args={sum(rec['argument_bytes'].values()) / 2**30:.2f}"
                  f"GiB peak~{rec['peak_bytes_estimate'] / 2**30:.2f}GiB "
                  f"bound={rec['bound_s']:.4g}s ({rec['count_s']}s)",
                  flush=True)
        except Exception as e:      # one failed cell must not end the sweep
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "count_s": round(time.perf_counter() - t0, 2)}
            print(f"[FAIL] {key}: {rec['error'][:300]}", flush=True)
            traceback.print_exc(limit=3)
        res[key] = rec
        save_results(args.out, res)
    bad = sorted(k for k, v in res.items() if not v.get("ok"))
    print(f"done in {time.perf_counter() - t_all:.1f} s: "
          f"{sum(1 for v in res.values() if v.get('ok'))} ok, "
          f"{len(bad)} failed")
    for k in bad:
        print(f"  FAILED: {k}: {res[k]['error'][:300]}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
