#!/usr/bin/env python3
"""The conditional nodes of ``core/device_loop.py`` on an NVIDIA card, at a
small size, in one process:

    python3 tools/graph_cond_probe.py

1. Builds every kernel (``graph_cond.cu`` among them) and runs a toy
   segment with two WHILE loops (one launching ``fused_relax_rows`` in
   its body) and an IF/else branch: uncaptured at its first call,
   captured at its second, then replayed on new inputs, the last time
   from the handle the previous replay returned, against the host-driven
   loops: equal, and ``fused_relax_rows``' launches equal.
2. SSSP and PageRank on ``cuda`` and ``cuda_chained`` over
   ``rmat_graph(12, 8)`` with 1% updates in 5 batches, and TC on ``cuda``
   over a symmetrized 1,024-vertex graph: the per-batch driver
   (``Engine.run_stream``) against the fused executor's first call
   (uncaptured), its second (capture and replay) and a replay alone:
   carries and the DynGraph equal, launches equal, host syncs counted
   (torch's sync debug mode), capture time and conditional nodes
   printed.

Prints the card's name and one line a case; exits non-zero on a mismatch
or without a card.
"""
import pathlib
import sys
import time
import warnings

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def count_syncs(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def toy_segment(dev) -> bool:
    from repro_torch.core import device_loop as DL
    from repro_torch.kernels import repair as FK
    R, K, n = 256, 8, 200
    gen = torch.Generator(device="cpu").manual_seed(0)
    es = torch.randint(0, n + 1, (R, K), generator=gen).int().to(dev)
    ew = torch.randint(1, 9, (R, K), generator=gen).int().to(dev)

    def body(h, c, b):
        i, v = DL.while_loop(lambda s: s[1].sum() < 5000,
                             lambda s: (s[0] + 1, s[1] * 2 + b[0]),
                             (0, h["x"]))
        y = DL.cond(v.sum() > 7000, lambda o: o + 1, lambda o: o - 1,
                    h["y"])

        def relax(s):
            rmin = FK.fused_relax_rows(es, ew, s[1], block=128)[0]
            vn = torch.cat([torch.minimum(s[1][:-1], rmin[:n]), s[1][-1:]])
            return s[0] + 1, vn

        _, vals = DL.while_loop(lambda s: s[0] < 3, relax, (0, h["vals"]))
        return {**h, "x": v, "y": y, "vals": vals}, c + i

    def counters(h):
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return torch.stack([h["x"].sum().int(), z, z])

    h = {"x": torch.arange(4, device=dev, dtype=torch.int32),
         "y": torch.zeros(4, device=dev, dtype=torch.int32),
         "vals": torch.randint(0, 100, (n + 1,), generator=gen).int().to(
             dev)}
    c = torch.zeros((), dtype=torch.int32, device=dev)
    b = torch.ones((2, 4), dtype=torch.int32, device=dev)
    seg = DL.SegmentGraph(body, counters, dev)
    ok = True
    for tag, h_in in (("first, uncaptured", h), ("capture", h),
                      ("new input", {**h, "x": h["x"] + 3}),
                      ("from the last result", None)):
        if h_in is None:
            h_in, c_in = got_h, got_c
            want_h, want_c = body(h_in, got_c, b)
        else:
            c_in = c
            want_h, want_c = body(h_in, c, b)
        FK.reset_launches()
        got_h, got_c, _ = seg(h_in, c_in, b)
        same = all(torch.equal(want_h[k], got_h[k]) for k in want_h) and \
            torch.equal(want_c, got_c)
        launches = FK.LAUNCHES["fused_relax_rows"] == 3
        if seg.graph is None:
            print(f"[toy {tag}] equal {same}, launches {launches}")
        else:
            print(f"[toy {tag}] equal {same}, launches {launches}, "
                  f"capture {seg.capture_s:.3f} s, {seg.cap.nodes} nodes, "
                  f"trips {seg.last_trips}, {seg.copy_bytes} bytes of "
                  f"handle copied in and out")
        ok &= same and launches
    return ok


def engines(dev) -> bool:
    import repro_torch
    from repro_torch.algos import pagerank, sssp, triangles
    from repro_torch.core.engine import Engine
    from repro_torch.kernels import csr_relax as CK
    from repro_torch.kernels import repair as FK
    from repro_torch.kernels import segment as SK

    def launches():
        out = {}
        for m in (FK, CK, SK):
            out.update({k: v for k, v in m.LAUNCHES.items() if v})
            m.reset_launches()
        return out

    def compare(tag, sess, stream, bs, step, c0):
        eng, h0 = sess.engine, sess.handle
        launches()
        (he, ce), se = count_syncs(
            lambda: Engine.run_stream(eng, h0, stream, bs, step, c0))
        le = launches()
        (hu, cu), su = count_syncs(
            lambda: eng.run_stream(h0, stream, bs, step, c0))
        lu = launches()
        t0 = time.perf_counter()
        (hf, cf), sf = count_syncs(
            lambda: eng.run_stream(h0, stream, bs, step, c0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lf = launches()
        (hr, cr), sr = count_syncs(
            lambda: eng.run_stream(h0, stream, bs, step, c0))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lr = launches()
        ce, cu, cf, cr = (x if isinstance(x, dict) else {"c": x}
                          for x in (ce, cu, cf, cr))
        eq = all(torch.equal(ce[k], c[k]) for k in ce for c in (cu, cf, cr))
        geq = all(torch.equal(getattr(eng.handle_graph(he), f),
                              getattr(eng.handle_graph(h), f))
                  for f in ("alive", "w", "d_src", "d_dst", "d_w",
                            "d_alive", "d_offsets") for h in (hu, hf, hr))
        run = next(r for r in eng._stream_cache.values()
                   if r.graph is not None)
        print(f"[{tag}] equal {eq} graph {geq} | syncs per-batch {se}, "
              f"uncaptured {su}, capture call {sf}, replay {sr} | launches "
              f"{le} / {lu} / {lf} / {lr} | capture {run.capture_s:.3f} s, "
              f"{run.cap.nodes} nodes | capture call {t1 - t0:.3f} s, "
              f"replay {t2 - t1:.3f} s")
        return eq and geq and le == lu == lf == lr

    ok = True
    n, edges, w = repro_torch.rmat_graph(12, 8, seed=0)
    csr = repro_torch.build_csr(n, edges, w, device=dev)
    stream = repro_torch.random_updates(csr, percent=1, seed=1)
    bs = -(-max(stream.num_adds, stream.num_dels) // 5)
    for algo, static, step in (
            ("sssp", (sssp.static_sssp, 0), sssp.stream_step),
            ("pagerank", (pagerank.static_pr, 1e-4, 0.85, 100),
             pagerank.make_stream_step(1e-4, 0.85, 100))):
        for backend in ("cuda", "cuda_chained"):
            sess = repro_torch.bind_graph(csr, backend=backend,
                                          capacity=2 * stream.num_adds,
                                          device=dev)
            c0 = sess.call(*static)
            ok &= compare(f"{algo} {backend}", sess, stream, bs, step, c0)
    n = 1 << 10
    rng = np.random.default_rng(0)
    e = rng.integers(0, n, (n * 4, 2))
    e = np.unique(np.concatenate([e, e[:, ::-1]]), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    tcsr = repro_torch.build_csr(n, e, np.ones(len(e), np.int32), device=dev)
    ups = repro_torch.random_updates(tcsr, percent=2, seed=3)
    sym = repro_torch.UpdateStream(
        adds=np.concatenate([ups.adds, ups.adds[:, [1, 0, 2]]]),
        dels=np.concatenate([ups.dels, ups.dels[:, ::-1]]))
    sess = repro_torch.bind_graph(tcsr, backend="cuda",
                                  capacity=2 * sym.num_adds, device=dev)
    ok &= compare("tc cuda", sess, sym, 32, triangles.stream_step,
                  sess.call(triangles.static_tc))
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_cond_probe: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    ok = toy_segment(dev)
    ok &= engines(dev)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
