#!/usr/bin/env python3
"""The graph update's building blocks timed on an NVIDIA card in two or
more trees of the port, each tree in a process of its own, so that a
change to the helpers they share (``tensors.set_drop``, the ELL pack's
row count) is read against another tree in one call.

    python3 tools/update_timing.py SRC [SRC ...]   # each SRC a src/ dir

Graph and batch are ``chip_smoke.py``'s main path: ``rmat_graph(22, 16,
seed=0)`` and the first 65,536-lane batch of ``random_updates(percent=1,
seed=1)``, on a ``cuda`` handle with a pool of twice the stream's adds.
The first tree makes them and saves them under ``build/update_timing/``;
the others load them.  For each tree, in the order given, the median of
``--reps`` CUDA-event times with a cold L2 of: ``pack_ell`` (the repack
of the prepared graph), ``update_csr_add`` (the merge of the batch's
adds), ``patch_ell_revive`` (the revivals' two slot scatters) and the
engine's ``update_del`` + ``update_add`` (the whole batch, its repack
included).  Prints the card's name and power limit, then one JSON line a
tree.  Give the trees as A B B A to see the drift between calls.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "build" / "update_timing" / "graph.npz"
SCALE, DEGREE, PERCENT, BATCH = 22, 16, 1.0, 65536
L2_FLUSH_BYTES = 256 << 20


def median_ms(torch, fn, reps: int, flush) -> float:
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def one(src: str, reps: int) -> None:
    sys.path.insert(0, os.path.abspath(src))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.graph import diffcsr
    from repro_torch.graph.updates import UpdateStream
    from repro_torch.kernels import ell as E
    from repro_torch.kernels import repair as FK
    if DATA.exists():
        z = np.load(DATA)
        n, edges, w = int(z["n"]), z["edges"], z["w"]
        csr = repro_torch.build_csr(n, edges, w, device="cuda")
        stream = UpdateStream(adds=z["adds"], dels=z["dels"])
    else:
        n, edges, w = repro_torch.rmat_graph(SCALE, DEGREE, seed=0)
        csr = repro_torch.build_csr(n, edges, w, device="cuda")
        stream = repro_torch.random_updates(csr, percent=PERCENT, seed=1)
        DATA.parent.mkdir(parents=True, exist_ok=True)
        np.savez(DATA, n=n, edges=edges, w=w, adds=stream.adds,
                 dels=stream.dels)
    del edges, w
    eng = repro_torch.make_engine("cuda", device="cuda")
    h = eng.prepare(csr, 2 * stream.num_adds)
    b = stream.batch(0, BATCH, device="cuda")
    h1 = eng.update_del(h, b)
    lane, active = diffcsr.update_lanes(h1.g, b.add_src, b.add_dst,
                                        b.add_mask)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    steps = {
        "pack_ell": lambda: E.pack_ell(h.g, eng.k),
        "update_csr_add": lambda: diffcsr.update_csr_add(
            h1.g, b.add_src, b.add_dst, b.add_w, b.add_mask,
            pool_merge=FK.merge_pool_sorted),
        "patch_ell_revive": lambda: E.patch_ell_revive(
            h1.ell, lane, b.add_src, b.add_w, active),
        "update_batch": lambda: eng.update_add(eng.update_del(h, b), b),
    }
    out = {"src": src, "E": csr.num_edges, "lanes": BATCH}
    out.update({k: median_ms(torch, fn, reps, flush)
                for k, fn in steps.items()})
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="+", help="a tree's src/ directory")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        one(args.src[0], args.reps)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for src in args.src:
        subprocess.run([sys.executable, __file__, "--one", "--reps",
                        str(args.reps), src], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
