#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # RMAT scale 22, degree 16, 1% updates
    python3 chip_smoke.py --scale 16      # a quick, small run
    python3 chip_smoke.py --profile       # + a torch.profiler breakdown

Phases (any failure exits non-zero):

1. Device: the card's name and power limit, the CUDA version, and the
   build of the kernels in ``src/repro_torch/csrc`` with ``nvcc``.
2. Main path: dynamic SSSP through ``repro_torch.bind_graph(csr,
   backend="cuda")`` — ``static_sssp`` from vertex 0, then ``stream_step``
   over ``random_updates(csr, percent=1, seed=1)`` in batches of 65,536 —
   with every kernel's launch count set to 0 just before and read just
   after; each kernel must have launched.
3. Kernels against their plain PyTorch versions on the card, at the
   shapes of that run, bit for bit, with their times beside the bound
   (bytes each input read once and each output written once, over
   3.35 TB/s) and a one-call PyTorch yardstick where one exists.
4. Correctness of the run: ``dist``, ``parent`` and every DynGraph array
   equal the ``torch`` backend's on the same card, and ``dist`` equals
   scipy's Dijkstra over the post-update edge set.

The last two lines are the kernels' JSON record and the device record.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the main path: RMAT degree 16, 1% of the edges updated, batches of
# 65,536 updates (the admission guard's DEFAULT_MAX_BATCH)
DEGREE, PERCENT, BATCH = 16, 1.0, 65536
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Wall time of one step that ends in a device synchronize."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.s = time.perf_counter() - self.t0


def median_ms(torch, fn, reps: int, flush) -> float:
    """Median of ``reps`` launches, each timed by CUDA events with a cold
    L2 (the main path meets these inputs once per sweep or batch)."""
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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(torch, got, want) -> int:
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype mismatch {a.shape} {a.dtype} "
                                 f"vs {b.shape} {b.dtype}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
        err = max(err, int(d))
    return err


def bound(bytes_moved: int, ops: int):
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = ops / CUDA_CORE_OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def run_sssp(repro_torch, sssp, csr, stream, backend, batch, clock):
    """Bind, prepare, static SSSP from vertex 0, then the stream; returns
    the session, the final props and the three wall times."""
    sess = repro_torch.bind_graph(csr, backend=backend,
                                  capacity=2 * stream.num_adds, device=DEV)
    with clock() as t_prep:
        sess.handle                             # prepare: pool + ELL pack
    with clock() as t_static:
        props = sess.call(sssp.static_sssp, 0)
    with clock() as t_stream:
        props = sess.run_stream(stream, batch, sssp.stream_step, props)
    return sess, props, (t_prep.s, t_static.s, t_stream.s)


def profile_stream(torch, repro_torch, sssp, csr, stream, batch):
    """The cuda path once more under torch.profiler: device time by kernel
    for static_sssp and for the stream, and the device's busy share of
    each window's wall time (kernel rows only: an operator's row repeats
    its kernels' time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sess = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=2 * stream.num_adds, device=DEV)
    sess.handle
    props = None
    for name in ("static_sssp", "stream"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if props is None:
                props = sess.call(sssp.static_sssp, 0)
            else:
                props = sess.run_stream(stream, batch, sssp.stream_step,
                                        props)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [r for r in prof.key_averages()
                if r.device_type != DeviceType.CPU]
        dev_us = lambda r: getattr(r, "self_device_time_total",
                                   getattr(r, "self_cuda_time_total", 0))
        busy = sum(dev_us(r) for r in rows) / 1e6
        launches = sum(r.count for r in rows)
        log(f"[profile] {name}: wall {wall:.3f} s, device busy {busy:.3f} s "
            f"({100 * busy / wall:.1f}%), {launches} kernel launches of "
            f"{len(rows)} kinds")
        for r in sorted(rows, key=dev_us, reverse=True)[:12]:
            log(f"[profile]   {dev_us(r) / 1e3:10.2f} ms  {r.count:6d} calls"
                f"  {r.key[:100]}")
    del sess


def dijkstra_dist(np, csr_host, stream, n, inf_w):
    """scipy's Dijkstra from vertex 0 over (base − dels) ∪ adds, built with
    int64 key arithmetic from host arrays."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    src, dst, w = csr_host
    key = src.astype(np.int64) * n + dst
    dkey = stream.dels[:, 0].astype(np.int64) * n + stream.dels[:, 1]
    keep = ~np.isin(key, dkey)
    a = stream.adds
    s = np.concatenate([src[keep], a[:, 0]])
    d = np.concatenate([dst[keep], a[:, 1]])
    ww = np.concatenate([w[keep], np.maximum(a[:, 2], 1)]).astype(np.float64)
    k2 = s.astype(np.int64) * n + d
    if np.unique(k2).shape[0] != k2.shape[0]:
        raise AssertionError("post-update edge set has duplicate keys")
    g = csr_matrix((ww, (s, d)), shape=(n, n))
    dist = dijkstra(g, directed=True, indices=0)
    return np.where(np.isinf(dist), inf_w, dist).astype(np.int64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true",
                    help="rerun the cuda path under torch.profiler and "
                         "print where the device time goes")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    import repro_torch
    from repro_torch.algos import sssp
    from repro_torch.graph.csr import INF_W
    from repro_torch.kernels import _build
    from repro_torch.kernels import repair as FK

    # -- 1. device + build -----------------------------------------------
    log(nvidia_smi())
    log(f"[device] torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {os.path.relpath(_build.BUILD_INFO['path'], ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{_build.BUILD_INFO['seconds']} s)")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[ptxas] {line.strip()}")
    clock = lambda: Timer(torch)

    # -- 2. main path on the cuda backend ----------------------------------
    with clock() as t_gen:
        n, edges, w = repro_torch.rmat_graph(args.scale, DEGREE, seed=0)
        csr = repro_torch.build_csr(n, edges, w, device=DEV)
        del edges, w
        stream = repro_torch.random_updates(csr, percent=PERCENT, seed=1)
    nb = stream.num_batches(BATCH)
    log(f"[graph] rmat scale {args.scale} degree {DEGREE}: n={n} "
        f"E={csr.num_edges} | stream: {stream.num_adds} adds, "
        f"{stream.num_dels} dels, {nb} batches of {BATCH} | "
        f"generation {t_gen.s:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    sess, props, (t_prep, t_static, t_stream) = run_sssp(
        repro_torch, sssp, csr, stream, "cuda", BATCH, clock)
    launches = dict(FK.LAUNCHES)
    ups = (stream.num_adds + stream.num_dels) / t_stream
    log(f"[cuda] prepare {t_prep:.3f} s | static_sssp {t_static:.3f} s | "
        f"stream {t_stream:.3f} s ({ups:.0f} updates/s) | launches "
        f"{launches} | peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path")
    if launches["merge_pool_sorted"] != nb:
        raise AssertionError(f"merge_pool_sorted launched "
                             f"{launches['merge_pool_sorted']} times for "
                             f"{nb} add batches")

    if args.profile:
        profile_stream(torch, repro_torch, sssp, csr, stream, BATCH)

    # -- 3. kernels against their plain versions, main-path shapes ---------
    h = sess.handle
    g, ell = h.g, h.ell
    cfg = sess.engine._config(g)
    dist = props["dist"]
    vals = torch.cat([torch.where(dist < INF_W, dist, INF_W).int(),
                      dist.new_full((1,), INF_W)])
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    kernels = []

    relax = lambda: FK.fused_relax_rows(ell.ell_src, ell.ell_w, vals,
                                        block=cfg.row_block)
    relax_plain = lambda: FK.fused_relax_rows_plain(
        ell.ell_src, ell.ell_w, vals, cfg.row_block)
    got, want = relax(), relax_plain()
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err:
        raise AssertionError(f"fused_relax_rows differs from its plain "
                             f"version: max abs err {err}")
    R, K = ell.R, ell.K
    b_ms, b_by = bound(nbytes(ell.ell_src, ell.ell_w, vals, *got),
                       3 * R * K)
    kernels.append(dict(
        name="fused_relax_rows", route="cuda",
        source="src/repro_torch/csrc/repair.cu",
        replaces="src/repro/kernels/pallas_repair.py:102",
        launches=launches["fused_relax_rows"], max_abs_err=err,
        ms=median_ms(torch, relax, args.reps, flush),
        plain_ms=median_ms(torch, relax_plain, args.reps, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(R=R, K=K, n=n, block=cfg.row_block)))

    rng = np.random.default_rng(2)
    B = BATCH
    pool = (g.d_src, g.d_dst, g.d_w, g.d_alive)
    D = g.diff_capacity
    pool_keys = (g.d_src.long() * n + g.d_dst.long()).cpu().numpy()
    fk = np.unique(rng.integers(0, n, size=2 * B) * np.int64(n)
                   + rng.integers(0, n, size=2 * B))
    fk = fk[~np.isin(fk, pool_keys)][:B]
    if fk.shape[0] != B:
        raise AssertionError(f"drew {fk.shape[0]} fresh edges, wanted {B}")
    fresh = [torch.from_numpy(x.astype(np.int32)).to(DEV)
             for x in (fk // n, fk % n, rng.integers(1, 100, size=B))]
    fresh.append(torch.ones(B, dtype=torch.bool, device=DEV))
    merge = lambda: FK.merge_pool_sorted(*pool, *fresh, n=n)
    merge_plain = lambda: FK.merge_pool_sorted_plain(*pool, *fresh, n)
    got, want = merge(), merge_plain()
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err:
        raise AssertionError(f"merge_pool_sorted differs from its plain "
                             f"version: max abs err {err}")
    keys = torch.cat([g.d_src.long() * (n + 1) + g.d_dst.long(),
                      fresh[0].long() * (n + 1) + fresh[1].long()])
    lib = lambda: torch.sort(keys, stable=True)
    iters = FK._merge_iters(B)
    b_ms, b_by = bound(nbytes(*pool, *fresh, *got), D * iters * 6)
    kernels.append(dict(
        name="merge_pool_sorted", route="cuda",
        source="src/repro_torch/csrc/repair.cu",
        replaces="src/repro/kernels/pallas_repair.py:200",
        launches=launches["merge_pool_sorted"], max_abs_err=err,
        ms=median_ms(torch, merge, args.reps, flush),
        plain_ms=median_ms(torch, merge_plain, args.reps, flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=median_ms(torch, lib, args.reps, flush),
        shape=dict(D=D, B=B, n=n, used=int((g.d_src < n).sum()))))
    for k in kernels:
        log(f"[kernel] {k['name']}: {k['ms']:.4f} ms (plain "
            f"{k['plain_ms']:.4f}, bound {k['bound_ms']:.4f} by "
            f"{k['bound_by']}, library {k['library_ms']}) bit-exact, "
            f"{k['launches']} launches on the main path")
    del flush, vals, keys, got, want

    # -- 4. correctness: torch backend on the same card, then Dijkstra -----
    cuda_g, cuda_props = g, {k: props[k] for k in ("dist", "parent")}
    del sess, h, ell, props
    torch.cuda.empty_cache()
    tsess, tprops, (tp, ts, tt) = run_sssp(repro_torch, sssp, csr, stream,
                                           "torch", BATCH, clock)
    log(f"[torch] prepare {tp:.3f} s | static_sssp {ts:.3f} s | stream "
        f"{tt:.3f} s")
    for k in ("dist", "parent"):
        if not torch.equal(cuda_props[k], tprops[k]):
            raise AssertionError(f"cuda and torch backends differ in {k}")
    tg = tsess.handle
    for f in ("offsets", "src", "dst", "w", "alive", "d_offsets", "d_src",
              "d_dst", "d_w", "d_alive", "overflow"):
        if not torch.equal(getattr(cuda_g, f), getattr(tg, f)):
            raise AssertionError(f"cuda and torch backends differ in g.{f}")
    log("[check] dist, parent and all DynGraph arrays bit-identical to the "
        "torch backend")
    host = tuple(x.cpu().numpy() for x in (csr.src, csr.dst, csr.w))
    with clock() as t_dij:
        ref = dijkstra_dist(np, host, stream, n, INF_W)
    got = cuda_props["dist"].cpu().numpy().astype(np.int64)
    if not np.array_equal(got, ref):
        bad = int((got != ref).sum())
        raise AssertionError(f"dist differs from scipy Dijkstra at {bad} "
                             f"vertices")
    log(f"[check] dist equals scipy Dijkstra ({int((ref < INF_W).sum())} "
        f"reachable of {n}; {t_dij.s:.1f} s)")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
