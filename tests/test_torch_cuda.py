"""The CUDA kernels and the ``cuda`` backend on the card, against their
plain PyTorch versions and the CPU run.  Every test here needs a card
(marker ``cuda``) and skips without one.  The file imports neither JAX
nor repro, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is bit-exact, float outputs included: the float kernels
and their plain versions add in the same fixed order."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.algos import pagerank, sssp
from repro_torch.graph.csr import INF_W
from repro_torch.kernels import csr_relax as TC
from repro_torch.kernels import repair as TK
from repro_torch.kernels import segment as TS
from repro_torch.kernels.ell import pack_ell

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def random_graph(seed, n, e):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    return n, edges, rng.integers(1, 50, len(edges)).astype(np.int32)


@pytest.mark.parametrize("n,e,k,block", [(64, 256, 8, 128),
                                         (200, 1000, 4, 128),
                                         (300, 2000, 8, 256),
                                         (5000, 60000, 8, 512),
                                         (3000, 20000, 16, 256)])
def test_relax_kernel_matches_plain(dev, n, e, k, block):
    n, edges, w = random_graph(n + e, n, e)
    g = repro_torch.graph.from_csr(
        repro_torch.build_csr(n, edges, w, device=dev), 4)
    ell = pack_ell(g, k=k)
    rng = np.random.default_rng(e)
    vals = np.concatenate([rng.integers(0, 1000, n), [INF_W]]).astype(np.int32)
    vals[:n][rng.random(n) < 0.3] = INF_W
    vals = torch.from_numpy(vals).to(dev)
    before = TK.LAUNCHES["fused_relax_rows"]
    got = TK.fused_relax_rows(ell.ell_src, ell.ell_w, vals, block=block)
    assert TK.LAUNCHES["fused_relax_rows"] == before + 1
    want = TK.fused_relax_rows_plain(ell.ell_src, ell.ell_w, vals, block)
    torch.cuda.synchronize()
    for name, a, b in zip(("row_min", "row_arg", "rows", "counts"), got,
                          want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("seed,D,B", [(0, 24, 12), (1, 300, 64),
                                      (2, 5000, 4096), (3, 1, 1),
                                      (4, 70000, 65536)])
def test_merge_kernel_matches_plain(dev, seed, D, B):
    rng = np.random.default_rng(seed)
    n = 1000

    def rows(count, size):
        keys = np.unique(rng.integers(0, n * n, count))[:size]
        used = np.arange(size) < len(keys)
        k = np.concatenate([keys, np.zeros(size - len(keys), np.int64)])
        return [torch.from_numpy(x).to(dev) for x in (
            np.where(used, k // n, n).astype(np.int32),
            np.where(used, k % n, 0).astype(np.int32),
            np.where(used, rng.integers(1, 50, size), 0).astype(np.int32),
            used & (rng.random(size) < 0.9))]

    pool, fresh = rows(D // 2 + 1, D), rows(B, B)
    before = TK.LAUNCHES["merge_pool_sorted"]
    got = TK.merge_pool_sorted(*pool, *fresh, n=n)
    assert TK.LAUNCHES["merge_pool_sorted"] == before + 1
    want = TK.merge_pool_sorted_plain(*pool, *fresh, n)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_refuse_bad_inputs(dev):
    n, edges, w = random_graph(1, 64, 256)
    ell = pack_ell(repro_torch.graph.from_csr(
        repro_torch.build_csr(n, edges, w, device=dev), 4))
    vals = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        TK.fused_relax_rows(ell.ell_src, ell.ell_w.long(), vals)
    with pytest.raises(ValueError):
        TK.fused_relax_rows(ell.ell_src, ell.ell_w.cpu(), vals)
    with pytest.raises(ValueError):
        TK.fused_relax_rows(ell.ell_src.t(), ell.ell_w.t(), vals)


@pytest.mark.parametrize("seed,batch,capacity", [(0, 8, 64), (1, 1, 16),
                                                 (2, 64, 4), (3, 512, 2048)])
def test_cuda_backend_matches_cpu_run(dev, seed, batch, capacity):
    """The cuda backend on the card launches its kernels and gives the
    CPU run's dist, parent, graph and ELL pack bit for bit (capacity 4
    forces grow-and-replay)."""
    n, edges, w = random_graph(seed, 300, 1500)
    out = {}
    for where in ("cpu", dev):
        csr = repro_torch.build_csr(n, edges, w, device=where)
        stream = repro_torch.random_updates(csr, percent=20, seed=seed)
        TK.reset_launches()
        sess = repro_torch.bind_graph(csr, backend="cuda", capacity=capacity,
                                      device=where)
        props = sess.call(sssp.static_sssp, 0)
        props = sess.run_stream(stream, batch, sssp.stream_step, props)
        out[str(where)] = (props, sess.handle, dict(TK.LAUNCHES))
    (p_cpu, h_cpu, l_cpu), (p_gpu, h_gpu, l_gpu) = out.values()
    assert l_cpu == {"fused_relax_rows": 0, "fused_spmv_rows": 0,
                     "merge_pool_sorted": 0}
    assert l_gpu["fused_relax_rows"] > 0 and l_gpu["merge_pool_sorted"] > 0
    for k in ("dist", "parent", "modified"):
        assert torch.equal(p_cpu[k], p_gpu[k].cpu()), k
    for part in ("g", "ell"):
        a, b = getattr(h_cpu, part), getattr(h_gpu, part)
        for f, x in vars(a).items():
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(b, f).cpu()), (part, f)


def small_ell(dev, n, e, k, seed=0):
    n, edges, w = random_graph(seed + n + e, n, e)
    g = repro_torch.graph.from_csr(
        repro_torch.build_csr(n, edges, w, device=dev), 4)
    rng = np.random.default_rng(e)
    vals = np.concatenate([rng.integers(0, 1000, n), [INF_W]]).astype(np.int32)
    vals[:n][rng.random(n) < 0.3] = INF_W
    fvals = rng.random(n + 1).astype(np.float32) / n
    fvals[n] = 0.0                    # the sum's identity at slot n
    fvals[:n][rng.random(n) < 0.2] = 0.0
    return (pack_ell(g, k=k), torch.from_numpy(vals).to(dev),
            torch.from_numpy(fvals).to(dev))


def launched(counts, name, fn):
    before = counts[name]
    out = fn()
    assert counts[name] == before + 1, name
    return out


def assert_same(got, want, name):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("n,e,k,block", [(200, 1000, 4, 128),
                                         (5000, 60000, 8, 512)])
def test_slice2_kernels_match_plain(dev, n, e, k, block):
    """fused_spmv_rows, the three chained row kernels and the float
    segment sum against their plain versions, bit for bit."""
    ell, vals, fvals = small_ell(dev, n, e, k)
    assert_same(launched(TK.LAUNCHES, "fused_spmv_rows",
                         lambda: TK.fused_spmv_rows(ell.ell_src, ell.row2dst,
                                                    fvals, block=block)),
                TK.fused_spmv_rows_plain(ell.ell_src, ell.row2dst, fvals,
                                         block), "fused_spmv_rows")
    assert_same(launched(TC.LAUNCHES, "relax_rowmin",
                         lambda: TC.relax_rowmin(ell.ell_src, ell.ell_w,
                                                 vals)),
                TC.relax_rowmin_plain(ell.ell_src, ell.ell_w, vals),
                "relax_rowmin")
    assert_same(launched(TC.LAUNCHES, "spmv_rowsum",
                         lambda: TC.spmv_rowsum(ell.ell_src, fvals)),
                TC.spmv_rowsum_plain(ell.ell_src, fvals), "spmv_rowsum")
    rmin = TC.relax_rowmin_plain(ell.ell_src, ell.ell_w, vals)
    # targets that some rows reach and others miss
    tgt = torch.where(torch.arange(ell.R, device=dev) % 3 == 0, rmin + 1,
                      rmin)
    assert_same(launched(TC.LAUNCHES, "relax_rowargmin",
                         lambda: TC.relax_rowargmin(ell.ell_src, ell.ell_w,
                                                    vals, tgt, n=n)),
                TC.relax_rowargmin_plain(ell.ell_src, ell.ell_w, vals, tgt,
                                         n), "relax_rowargmin")
    rng = np.random.default_rng(n)
    seg = torch.from_numpy(rng.integers(0, n, 4 * n).astype(np.int32)).to(dev)
    order = torch.argsort(seg, stable=True).to(torch.int32)
    offsets = torch.searchsorted(seg[order.long()], torch.arange(
        n + 1, dtype=torch.int32, device=dev), out_int32=True)
    x = fvals[seg.long()].contiguous()
    for o in (order, None):
        assert_same(launched(TS.LAUNCHES, "segment_sum_sorted",
                             lambda: TS.segment_sum_sorted(x, o, offsets)),
                    TS.segment_sum_sorted_plain(x, o, offsets),
                    "segment_sum_sorted")


def test_slice2_wrappers_refuse_bad_inputs(dev):
    ell, vals, fvals = small_ell(dev, 64, 256, 8)
    with pytest.raises(TypeError):
        TK.fused_spmv_rows(ell.ell_src, ell.row2dst, vals)
    with pytest.raises(ValueError):
        TK.fused_spmv_rows(ell.ell_src, ell.row2dst.cpu(), fvals)
    with pytest.raises(TypeError):
        TC.spmv_rowsum(ell.ell_src.long(), fvals)
    with pytest.raises(TypeError):
        TC.relax_rowmin(ell.ell_src, ell.ell_w, fvals)
    with pytest.raises(ValueError):
        TC.relax_rowargmin(ell.ell_src, ell.ell_w, vals, ell.row2dst[:5],
                           n=64)
    wide = torch.zeros((128, 40), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        TC.relax_rowmin(wide, wide, vals)
    with pytest.raises(TypeError):
        TS.segment_sum_sorted(vals, None, ell.row2dst)


def run_pr(where, backend, seed=0):
    n, edges, w = random_graph(seed, 400, 3000)
    csr = repro_torch.build_csr(n, edges, w, device=where)
    stream = repro_torch.random_updates(csr, percent=10, seed=seed)
    sess = repro_torch.bind_graph(csr, backend=backend, capacity=64,
                                  device=where)
    props = sess.call(pagerank.static_pr, 1e-4, 0.85, 100)
    props = sess.run_stream(stream, 64, pagerank.make_stream_step(
        1e-4, 0.85, 100), props)
    return props["pr"]


def test_pagerank_on_card_is_deterministic(dev):
    """PageRank on cuda: two runs bit-identical, equal to cuda_chained,
    through their kernels; within 1e-5 of the CPU run."""
    for mod in (TK, TC):
        mod.reset_launches()
    first, second = run_pr(dev, "cuda"), run_pr(dev, "cuda")
    assert TK.LAUNCHES["fused_spmv_rows"] > 0
    assert TK.LAUNCHES["merge_pool_sorted"] > 0
    assert set(TC.LAUNCHES.values()) == {0}
    TK.reset_launches()
    chained = run_pr(dev, "cuda_chained")
    assert TC.LAUNCHES["spmv_rowsum"] > 0
    assert set(TK.LAUNCHES.values()) == {0}
    assert torch.equal(first, second)
    assert torch.equal(first, chained)
    torch.testing.assert_close(first.cpu(), run_pr("cpu", "cuda"),
                               rtol=1e-5, atol=1e-6)


def test_chained_sssp_matches_cpu_run(dev):
    """cuda_chained SSSP on the card launches the chained kernels and
    gives the CPU run's dist and parent bit for bit."""
    n, edges, w = random_graph(5, 300, 1500)
    out = []
    for where in ("cpu", dev):
        csr = repro_torch.build_csr(n, edges, w, device=where)
        stream = repro_torch.random_updates(csr, percent=20, seed=5)
        TC.reset_launches()
        sess = repro_torch.bind_graph(csr, backend="cuda_chained",
                                      capacity=16, device=where)
        props = sess.call(sssp.static_sssp, 0)
        out.append(sess.run_stream(stream, 8, sssp.stream_step, props))
    assert TC.LAUNCHES["relax_rowmin"] > 0
    assert TC.LAUNCHES["relax_rowargmin"] > 0
    for k in ("dist", "parent"):
        assert torch.equal(out[0][k], out[1][k].cpu()), k
