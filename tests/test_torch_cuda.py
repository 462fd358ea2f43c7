"""The CUDA kernels and the ``cuda`` backend on the card, against their
plain PyTorch versions and the CPU run.  Every test here needs a card
(marker ``cuda``) and skips without one.  The file imports neither JAX
nor repro, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

All outputs are integer or bool: every comparison is bit-exact."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.algos import sssp
from repro_torch.graph.csr import INF_W
from repro_torch.kernels import repair as TK
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
    assert l_cpu == {"fused_relax_rows": 0, "merge_pool_sorted": 0}
    assert l_gpu["fused_relax_rows"] > 0 and l_gpu["merge_pool_sorted"] > 0
    for k in ("dist", "parent", "modified"):
        assert torch.equal(p_cpu[k], p_gpu[k].cpu()), k
    for part in ("g", "ell"):
        a, b = getattr(h_cpu, part), getattr(h_gpu, part)
        for f, x in vars(a).items():
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(b, f).cpu()), (part, f)
