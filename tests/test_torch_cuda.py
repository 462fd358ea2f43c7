"""The CUDA kernels and the ``cuda`` backend on the card, against their
plain PyTorch versions and the CPU run.  Every test here needs a card
(marker ``cuda``) and skips without one.  The file imports neither JAX
nor repro, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every graph comparison is bit-exact, float outputs included: the float
kernels and their plain versions add in the same fixed order.  The
flash-attention kernel is held to its plain version within the
tolerances of tests/test_kernels.py (bf16 3e-2; float32 2e-5 rather than
1e-5, for the card's expf and another summation order)."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.algos import pagerank, sssp
from repro_torch.graph.csr import INF_W
from repro_torch.kernels import csr_relax as TC
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import repair as TK
from repro_torch.kernels import segment as TS
from repro_torch.kernels.ell import pack_ell
from repro_torch.kernels.ref import flash_ref

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (MERGE_CASES and their inputs)

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


@pytest.mark.parametrize("i", range(len(chip_smoke.MERGE_CASES)),
                         ids=[c[0] for c in chip_smoke.MERGE_CASES])
def test_merge_kernel_on_merge_cases(dev, i):
    """chip_smoke.MERGE_CASES (ties whose rows differ, D at and around the
    tile of MERGE_TILE slots, B above the tile and above D, an empty pool,
    a batch before or after the whole pool, negative source ids), one
    launch into outputs filled with junk, bit for bit."""
    _, D, B, pool_used, batch_used, ties, where = chip_smoke.MERGE_CASES[i]
    arrays = [torch.from_numpy(x).to(dev) for x in chip_smoke.merge_case(
        np, i, D, B, pool_used, batch_used, ties, where)]
    n = chip_smoke.MERGE_N
    with chip_smoke.junk_outputs(torch):
        got = launched(TK.LAUNCHES, "merge_pool_sorted",
                       lambda: TK.merge_pool_sorted(*arrays, n=n))
    assert_same(got, TK.merge_pool_sorted_plain(*arrays, n),
                "merge_pool_sorted")


@pytest.mark.parametrize("R,warp", [(32 * 1021, True), (32 * 1021 + 7, False),
                                    (32, True), (31, False)])
def test_relax_rowmin_by_path(dev, R, warp):
    """relax_rowmin with K = 8 on its warp-loaded path (R a multiple of 32)
    and slot by slot (a ragged R: the last warp's rows do not all exist),
    into outputs filled with junk, bit for bit; vals[n] is no identity,
    so a padding slot dropped shows."""
    src, w, _ = row_pack(dev, 3000, R, 8, seed=R)
    assert TC.warp_loads(src, w) is warp
    vals, _ = sentinel_vals(dev, 3000, seed=R)
    with chip_smoke.junk_outputs(torch):
        got = launched(TC.LAUNCHES, "relax_rowmin",
                       lambda: TC.relax_rowmin(src, w, vals))
    assert_same(got, TC.relax_rowmin_plain(src, w, vals), "relax_rowmin")


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
                     "merge_pool_sorted": 0, "merge_pool_sorted_batched": 0}
    assert l_gpu["fused_relax_rows"] > 0 and l_gpu["merge_pool_sorted"] > 0
    assert l_gpu["merge_pool_sorted_batched"] == 0
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


@pytest.mark.parametrize("k", [4, 8])
def test_row_kernels_gather_out_of_range_sources_as_jax(dev, k):
    """Sources outside [0, n] in the pack (an unchecked, admission="off"
    graph's negative ids; past n for good measure) are gathered as a JAX
    gather takes them — from the end, or clamped — by all five row kernels,
    bit for bit with their plain versions."""
    n = 300
    ell, vals, fvals = small_ell(dev, n, 1500, k)
    rng = np.random.default_rng(k)
    src = ell.ell_src.clone()
    bad = torch.from_numpy(rng.random(src.shape) < 0.1).to(dev)
    ids = torch.from_numpy(rng.choice(
        [-1, -5, -n - 1, -n - 7, n + 1, n + 40, -(2 ** 31)],
        size=src.shape).astype(np.int32)).to(dev)
    src = torch.where(bad, ids, src).contiguous()
    assert bool((src < 0).any()) and bool((src > n).any())
    rmin = TC.relax_rowmin_plain(src, ell.ell_w, vals)
    tgt = torch.where(torch.arange(ell.R, device=dev) % 3 == 0, rmin + 1,
                      rmin)
    cases = [
        (TK.LAUNCHES, "fused_relax_rows",
         lambda: TK.fused_relax_rows(src, ell.ell_w, vals, block=128),
         lambda: TK.fused_relax_rows_plain(src, ell.ell_w, vals, 128)),
        (TK.LAUNCHES, "fused_spmv_rows",
         lambda: TK.fused_spmv_rows(src, ell.row2dst, fvals, block=128),
         lambda: TK.fused_spmv_rows_plain(src, ell.row2dst, fvals, 128)),
        (TC.LAUNCHES, "relax_rowmin",
         lambda: TC.relax_rowmin(src, ell.ell_w, vals), lambda: rmin),
        (TC.LAUNCHES, "spmv_rowsum",
         lambda: TC.spmv_rowsum(src, fvals),
         lambda: TC.spmv_rowsum_plain(src, fvals)),
        (TC.LAUNCHES, "relax_rowargmin",
         lambda: TC.relax_rowargmin(src, ell.ell_w, vals, tgt, n=n),
         lambda: TC.relax_rowargmin_plain(src, ell.ell_w, vals, tgt, n)),
    ]
    for counts, name, kernel, plain in cases:
        assert_same(launched(counts, name, kernel), plain(), name)


def row_pack(dev, n, R, K, seed):
    """A random pack of R rows: row r's first c_r ~ U[0, K] slots live,
    the rest padding (src n, w 0); rows with c_r = 0 are vacant and sit
    at the end with row2dst n, as a real pack keeps them."""
    rng = np.random.default_rng(seed)
    fill = np.sort(rng.integers(0, K + 1, R))[::-1]
    live = np.arange(K)[None, :] < fill[:, None]
    src = np.where(live, rng.integers(0, n, (R, K)), n)
    w = np.where(live, rng.integers(1, 50, (R, K)), 0)
    r2d = np.where(fill > 0, np.sort(rng.integers(0, n, R)), n)
    return tuple(torch.from_numpy(x.astype(np.int32)).to(dev)
                 for x in (src, w, r2d))


def sentinel_vals(dev, n, seed):
    """int vals (30% unreached) and float vals, each with a sentinel at
    slot n that is no identity (12345, 0.5): a padding slot dropped
    rather than given vals[n] changes the result."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1000, n + 1).astype(np.int32)
    v[:n][rng.random(n) < 0.3] = INF_W
    f = (rng.random(n + 1) / n).astype(np.float32)
    v[n], f[n] = 12345, 0.5
    return torch.from_numpy(v).to(dev), torch.from_numpy(f).to(dev)


def assert_row_kernels(dev, src, w, r2d, n, bt, seed=0):
    """Both fused row kernels on the card, one launch each, against their
    plain versions bit for bit, with sentinel vals."""
    vals, fvals = sentinel_vals(dev, n, seed)
    for name, side, v, fn, plain in (
            ("fused_relax_rows", w, vals, TK.fused_relax_rows,
             TK.fused_relax_rows_plain),
            ("fused_spmv_rows", r2d, fvals, TK.fused_spmv_rows,
             TK.fused_spmv_rows_plain)):
        got = launched(TK.LAUNCHES, name, lambda: fn(src, side, v, block=bt))
        assert_same(got, plain(src, side, v, bt), name)


@pytest.mark.parametrize("bt", [128, 256, 512])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_row_kernels_match_plain_with_padding_sentinels(dev, bt, K):
    """Every tile size the config picks and K of 4, 8 and 16, on a pack
    with padding slots and vacant rows and vals[n] no identity."""
    src, w, r2d = row_pack(dev, 5000, bt * 97, K, seed=bt + K)
    assert_row_kernels(dev, src, w, r2d, 5000, bt, seed=K)


@pytest.mark.parametrize("K", [4, 8])
def test_row_kernels_on_one_tile(dev, K):
    """R = bt: a single tile, a single block."""
    src, w, r2d = row_pack(dev, 50, 128, K, seed=K)
    assert_row_kernels(dev, src, w, r2d, 50, 128, seed=K)


def test_row_kernels_on_an_rmat_pack(dev):
    """An RMAT graph's pack (hub sources in many rows, vacant rows at the
    end), bit for bit."""
    n, edges, w = repro_torch.rmat_graph(14, 16, seed=3)
    g = repro_torch.graph.from_csr(repro_torch.build_csr(n, edges, w,
                                                         device=dev), 64)
    ell = pack_ell(g, k=8)
    assert bool((ell.row2dst == n).any())
    assert_row_kernels(dev, ell.ell_src, ell.ell_w, ell.row2dst, n, 128,
                       seed=14)


def test_row_kernels_on_misaligned_views(dev):
    """ell_src, ell_w and row2dst as views 4 bytes into a buffer: the
    kernels take no 16-byte loads of them and still equal the plain
    versions."""
    def view(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        return buf[1:].view(x.shape).copy_(x)

    src, w, r2d = (view(x) for x in row_pack(dev, 3000, 128 * 20, 8, 7))
    assert src.data_ptr() % 16 == 4
    assert_row_kernels(dev, src, w, r2d, 3000, 128, seed=7)


def assert_chained_kernels(dev, src, w, n, seed=0):
    """The three chained row kernels on the card, one launch each, against
    their plain versions bit for bit, with sentinel vals; relax_rowargmin's
    targets are the row minima, plus one on every third row, so some rows
    reach them and others miss."""
    vals, fvals = sentinel_vals(dev, n, seed)
    rmin = TC.relax_rowmin_plain(src, w, vals)
    tgt = torch.where(torch.arange(src.shape[0], device=dev) % 3 == 0,
                      rmin + 1, rmin)
    for name, fn, plain in (
            ("relax_rowmin", lambda: TC.relax_rowmin(src, w, vals),
             lambda: rmin),
            ("spmv_rowsum", lambda: TC.spmv_rowsum(src, fvals),
             lambda: TC.spmv_rowsum_plain(src, fvals)),
            ("relax_rowargmin",
             lambda: TC.relax_rowargmin(src, w, vals, tgt, n=n),
             lambda: TC.relax_rowargmin_plain(src, w, vals, tgt, n))):
        assert_same(launched(TC.LAUNCHES, name, fn), plain(), name)


@pytest.mark.parametrize("R", [256 * 97, 256 * 10 + 13, 32 * 7 + 31, 64])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_chained_row_kernels_match_plain_with_padding_sentinels(dev, R, K):
    """K of 4, 8 and 16, R a multiple of 32 (for K = 8 the warp-loaded
    path of spmv_rowsum and relax_rowargmin) or not (slot by slot, the
    last block ragged), on a pack with padding slots and vacant rows and
    vals[n] no identity."""
    src, w, _ = row_pack(dev, 5000, R, K, seed=R + K)
    assert TC.warp_loads(src, w) is (K == 8 and R % 32 == 0)
    assert_chained_kernels(dev, src, w, 5000, seed=K)


def test_chained_row_kernels_on_an_rmat_pack(dev):
    """An RMAT graph's pack (hub sources in many rows, vacant rows at the
    end) through the warp-loaded chained kernels, bit for bit."""
    n, edges, w = repro_torch.rmat_graph(14, 16, seed=4)
    g = repro_torch.graph.from_csr(repro_torch.build_csr(n, edges, w,
                                                         device=dev), 64)
    ell = pack_ell(g, k=8)
    assert TC.warp_loads(ell.ell_src, ell.ell_w)
    assert_chained_kernels(dev, ell.ell_src, ell.ell_w, n, seed=14)


@pytest.mark.parametrize("offset", [1, 2])
def test_chained_row_kernels_on_misaligned_views(dev, offset):
    """ell_src and ell_w as views 4 or 8 bytes into a buffer: no 16-byte
    loads of them, and still the plain versions' outputs."""
    def view(x):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        return buf[offset:].view(x.shape).copy_(x)

    src, w = (view(x) for x in row_pack(dev, 3000, 256 * 20, 8, 9)[:2])
    assert src.data_ptr() % 16 == 4 * offset
    assert not TC.warp_loads(src) and not TC.warp_loads(src, w)
    assert_chained_kernels(dev, src, w, 3000, seed=offset)


@pytest.mark.parametrize("backend", ["cuda", "cuda_chained"])
def test_admission_off_bad_ids_on_card_match_cpu_run(dev, backend):
    """With admission="off", ids past n, equal to n and negative reach the
    engine unchecked (the add from -5 puts a negative source into the
    pack, the one to -3 a negative destination).  On the card, SSSP gives
    the CPU run's dist and parent bit for bit and PageRank its pr within
    1e-5; the CPU run is held to the reference by
    tests/test_torch_{sssp,pagerank}.py."""
    n, edges, w = random_graph(11, 200, 1000)
    rng = np.random.default_rng(11)
    good = rng.integers(0, n, (40, 2)).astype(np.int32)
    adds = np.column_stack([good, rng.integers(1, 50, 40)]).astype(np.int32)
    bad_adds = np.array([[n + 3, 1, 5], [1, n + 3, 5], [-2, 1, 5],
                         [2, n, 5], [n, 2, 5], [3, -3, 7], [-5, 2, 1]],
                        np.int32)
    adds = np.insert(adds, [1, 5, 9, 13, 17, 21, 25], bad_adds, axis=0)
    dels = np.insert(edges[:40].astype(np.int32), [0, 6, 12, 18],
                     np.array([[n + 1, 0], [0, -1], [n, 3], [5, n]],
                              np.int32), axis=0)
    out = {}
    for where in ("cpu", dev):
        csr = repro_torch.build_csr(n, edges, w, device=where)
        stream = repro_torch.UpdateStream(adds=adds, dels=dels)
        got = []
        for start, step in (
                (lambda s: s.call(sssp.static_sssp, 0), sssp.stream_step),
                (lambda s: s.call(pagerank.static_pr, 1e-4, 0.85, 100),
                 pagerank.make_stream_step(1e-4, 0.85, 100))):
            sess = repro_torch.bind_graph(csr, backend=backend, capacity=16,
                                          admission="off", device=where)
            got.append(sess.run_stream(stream, 8, step, start(sess)))
        out[str(where)] = got
    (s_cpu, p_cpu), (s_gpu, p_gpu) = out.values()
    for k in ("dist", "parent"):
        assert torch.equal(s_cpu[k], s_gpu[k].cpu()), k
    torch.testing.assert_close(p_gpu["pr"].cpu(), p_cpu["pr"], rtol=1e-5,
                               atol=1e-6)


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


@pytest.mark.parametrize("bh,S,dh,causal,dtype,cap", [
    (2, 256, 128, True, torch.float32, None),
    (2, 256, 128, False, torch.float32, None),
    (2, 512, 64, True, torch.bfloat16, None),
    (2, 256, 256, True, torch.float32, 30.0),
    (3, 200, 128, True, torch.bfloat16, None),     # ragged S, tensor cores
    (3, 200, 64, False, torch.bfloat16, None),
    (2, 130, 96, True, torch.bfloat16, 50.0),      # bf16 on the CUDA cores
    (2, 100, 16, True, torch.float32, None),
])
def test_flash_kernel_matches_plain(dev, bh, S, dh, causal, dtype, cap):
    """The flash kernel against its plain version and the O(S^2) oracle on
    the same inputs, every row written (ragged S included)."""
    rng = np.random.default_rng(S + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, S, dh)).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    got = launched(TF.LAUNCHES, "flash_attention", lambda: TF.flash_attention(
        q, k, v, causal=causal, softcap=cap))
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    for want in (TF.flash_attention_plain(q, k, v, causal=causal,
                                          softcap=cap),
                 flash_ref(q, k, v, causal=causal, softcap=cap)):
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        err = float((got.float() - want.float()).abs().max())
        assert err < tol, err


def bf16_close(got, q, k, v, causal, cap, window=None):
    """A bf16 output of the kernel against its plain version: flat 3e-2,
    and relative to the values 2^-7 * A + 2^-6 * |want| elementwise (A the
    attention of |v|: twice P's bf16 rounding against each version's own
    running max plus an output ulp) and 1e-2 normwise."""
    kw = dict(causal=causal, softcap=cap, window=window)
    want = TF.flash_attention_plain(q, k, v, **kw)
    A = TF.flash_attention_plain(q, k, v.abs(), **kw).double()
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    d, w = (got.double() - want.double()).abs(), want.double()
    assert float(d.max()) < 3e-2, float(d.max())
    assert bool((d <= 2.0 ** -7 * A + 2.0 ** -6 * w.abs()).all())
    assert float(d.norm()) <= 1e-2 * float(w.norm())


def on_tensor_cores(name, fn):
    """fn() with one launch of ``name``, which the library ran on the
    tensor cores by its own route count."""
    before = dict(TF.ROUTES[name])
    out = launched(TF.LAUNCHES if name == "flash_attention"
                   else TF.BWD_LAUNCHES, name, fn)
    assert TF.ROUTES[name] == {**before, "tensor_cores":
                               before["tensor_cores"] + 1}, TF.ROUTES[name]
    return out


@pytest.mark.parametrize("dh,S,causal,cap", [
    (dh, S, causal, None) for dh in (64, 128, 256)
    for S in (1, 100, 129, 2048) for causal in (True, False)] + [
    (128, 100, True, 30.0), (128, 2048, True, 30.0), (128, 129, False, 30.0),
    (256, 65, True, 50.0), (256, 2048, True, 50.0), (256, 129, False, 50.0)])
def test_flash_tensor_core_kernel_matches_plain(dev, dh, S, causal, cap):
    """The wgmma kernel (bf16, dh 64, 128 or 256) at a single row, under
    one tile, one key past a tile (of 128 keys, 64 at dh 256) and 16 or 32
    tiles, against its plain version; the library reports the launch on
    the tensor cores."""
    rng = np.random.default_rng(S * dh + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, dh)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    got = on_tensor_cores("flash_attention", lambda: TF.flash_attention(
        q, k, v, causal=causal, softcap=cap))
    bf16_close(got, q, k, v, causal, cap)


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_kernel_keeps_heads_apart(dev, dh):
    """Head 1's k and v are NaN: heads 0 and 2 (S = 200, so their last
    KV tile runs past S) must not read them and equal the plain version."""
    rng = np.random.default_rng(dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 200, dh)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    k[1], v[1] = float("nan"), float("nan")
    for causal in (True, False):
        got = launched(TF.LAUNCHES, "flash_attention",
                       lambda: TF.flash_attention(q, k, v, causal=causal))
        torch.cuda.synchronize()
        keep = [0, 2]
        assert bool(torch.isfinite(got[keep]).all())
        bf16_close(got[keep], q[keep], k[keep], v[keep], causal, None)


# the window on both kernels: the tensor cores (bf16, dh 64 and 128 with
# 128-key tiles, 256 with 64-key ones: gemma2's width) and the CUDA cores
# (float32).  S = 300 and 1,000 are ragged; at S = 640 a window of 128
# leaves the last row of each 128-row q tile past the first its whole
# first KV tile masked, windows of 63 and 64 do the same for dh 256's
# 64-key tiles (rows 190-255 / 191-255 of the q tile from row 128), and on
# the CUDA cores (16-row tiles of 32 keys) a window of 127 does; windows
# of 200 and 300 give a q tile a second lower-edge KV tile below its
# diagonal one (the masked tiles inside the tensor-core kernel's loop).
WINDOW_PATHS = [(torch.bfloat16, 64), (torch.bfloat16, 128),
                (torch.bfloat16, 256), (torch.float32, 128)]


@pytest.mark.parametrize("dtype,dh", WINDOW_PATHS)
@pytest.mark.parametrize("S,window,cap", [
    (300, 1, None), (300, 127, None), (300, 128, None), (300, 129, None),
    (300, 300, None), (300, 5000, None), (640, 128, None),
    (640, 127, 30.0), (640, 256, 50.0), (640, 200, None),
    (1000, 300, 50.0), (640, 63, None), (640, 64, 50.0)])
def test_flash_window_matches_plain(dev, dtype, dh, S, window, cap):
    rng = np.random.default_rng(S * window + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, dh)).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    kw = dict(causal=True, softcap=cap, window=window)
    got = launched(TF.LAUNCHES, "flash_attention",
                   lambda: TF.flash_attention(q, k, v, **kw))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.bfloat16:
        bf16_close(got, q, k, v, True, cap, window)
    else:
        tol = dict(rtol=1e-4, atol=1e-5) if cap else dict(rtol=0, atol=2e-5)
        for want in (TF.flash_attention_plain(q, k, v, **kw),
                     flash_ref(q, k, v, **kw)):
            torch.testing.assert_close(got, want, **tol)
    if window >= S:       # no key is that far behind: the causal result
        assert torch.equal(got, TF.flash_attention(q, k, v, causal=True,
                                                   softcap=cap))


def test_flash_window_refused_without_causal(dev):
    q = torch.zeros((2, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="causal"):
        TF.flash_attention(q, q, q, causal=False, window=8)
    with pytest.raises(ValueError, match="positive int"):
        TF.flash_attention(q, q, q, window=0)


def test_flash_wrapper_refuses_bad_inputs(dev):
    q = torch.zeros((2, 64, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        TF.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        TF.flash_attention(q, q.float(), q)
    with pytest.raises(ValueError):
        TF.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        TF.flash_attention(q, q[:, :32], q)
    with pytest.raises(ValueError):
        TF.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    wide = torch.zeros((1, 8, 320), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        TF.flash_attention(wide, wide, wide)


# The backward kernel (csrc/flash_attention_bwd.cu) against its plain
# version on the same q, k, v, o, lse and do, by chip_smoke.bwd_rel:
# float32 within 2e-5 of each gradient's largest magnitude; bf16
# elementwise within 2^-6 (A + |want|) + 2^-16 A_t (A: the same products
# over the magnitudes of their terms; A_t with those of dS's terms) and
# normwise within 1e-2 ||want|| + 2^-16 ||A_t|| (chip_smoke.BWD_REL says
# why).

def bwd_case(dev, bh, S, dh, dtype, seed, **kw):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, S, dh)).astype(
        np.float32)).to(dev, dtype) for _ in range(4))
    o, lse = TF.flash_attention(q, k, v, return_lse=True, **kw)
    return q, k, v, o, lse, do


def bwd_close(case, got, **kw):
    torch.cuda.synchronize()
    chip_smoke.bwd_rel(TF, got, case, **kw)


@pytest.mark.parametrize("dtype,dh,S,causal,window,cap", [
    (dtype, dh, S, causal, None, cap) for dtype in (torch.float32,
                                                    torch.bfloat16)
    for dh in (64, 128, 256) for S in (200, 256) for causal in (True, False)
    for cap in (None, 30.0)] + [
    (torch.bfloat16, 96, 200, True, None, 50.0),     # off the tensor cores
    (torch.bfloat16, 16, 130, True, None, None),
    (torch.float32, 32, 200, True, 50, None),        # windows
    (torch.bfloat16, 128, 700, True, 128, None),
    (torch.bfloat16, 64, 300, True, 1, 30.0),
    (torch.bfloat16, 256, 300, True, 127, 50.0),
    (torch.bfloat16, 64, 1500, False, None, None),   # whisper's encoder
    (torch.bfloat16, 128, 2048, True, None, None)])
def test_flash_backward_matches_plain(dev, dtype, dh, S, causal, window, cap):
    kw = dict(causal=causal, softcap=cap, window=window)
    case = bwd_case(dev, 2, S, dh, dtype, S * dh + causal, **kw)
    got = launched(TF.BWD_LAUNCHES, "flash_attention_backward",
                   lambda: TF.flash_attention_backward(*case, **kw))
    bwd_close(case, got, **kw)


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 128),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 256),
                                      (torch.float32, 64)])
def test_flash_backward_is_deterministic(dev, dtype, dh):
    """Two launches on the same inputs agree bit for bit (no atomics); at
    bf16 dh 64 and 128 both ran on the tensor-core kernels."""
    kw = dict(causal=True, softcap=None, window=None)
    case = bwd_case(dev, 3, 600, dh, dtype, dh, **kw)
    run = (lambda fn: on_tensor_cores("flash_attention_backward", fn)) \
        if dtype == torch.bfloat16 and dh in (64, 128) else (lambda fn: fn())
    a = run(lambda: TF.flash_attention_backward(*case, **kw))
    b = run(lambda: TF.flash_attention_backward(*case, **kw))
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype,dh,S,causal,window,cap", [
    (torch.bfloat16, 128, 2048, True, None, None),
    (torch.bfloat16, 64, 200, False, None, None),
    (torch.bfloat16, 256, 300, True, 127, 50.0),
    (torch.float32, 128, 256, True, None, 30.0),
    (torch.bfloat16, 128, 700, True, 128, None)])
def test_flash_forward_lse_leaves_o_unchanged(dev, dtype, dh, S, causal,
                                              window, cap):
    """The forward with lse gives o bit for bit as without it, and an lse
    within 1e-4 (bf16 1e-2: the tensor cores' exp2) of the plain
    version's on the same inputs."""
    rng = np.random.default_rng(dh + S)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, dh)).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    kw = dict(causal=causal, softcap=cap, window=window)
    o, lse = TF.flash_attention(q, k, v, return_lse=True, **kw)
    _, want = TF.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, TF.flash_attention(q, k, v, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (2, S)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((lse - want).abs().max()) < tol


def test_flash_autograd_on_card_matches_cpu_run(dev):
    """A layer's worth of training on the card (FlashAttention forward and
    backward through the kernels) against the same on the CPU (the plain
    versions), float32."""
    rng = np.random.default_rng(7)
    host = [torch.from_numpy(rng.standard_normal((2, 160, 64)).astype(
        np.float32)) for _ in range(4)]
    grads = []
    for d in ("cpu", dev):
        q, k, v = (t.to(d).detach().requires_grad_() for t in host[:3])
        TF.reset_launches()
        TF.FlashAttention.apply(q, k, v, True, 30.0, 100).backward(
            host[3].to(d))
        grads.append([t.grad.cpu() for t in (q, k, v)])
        on_card = d != "cpu"
        assert TF.LAUNCHES["flash_attention"] == int(on_card)
        assert TF.BWD_LAUNCHES["flash_attention_backward"] == int(on_card)
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 2e-5 * float(b.abs().max())


def test_flash_backward_refuses_bad_inputs(dev):
    case = bwd_case(dev, 2, 64, 64, torch.bfloat16, 0)
    q, k, v, o, lse, do = case
    with pytest.raises(TypeError):
        TF.flash_attention_backward(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError):
        TF.flash_attention_backward(q, k, v, o, lse[:1], do)
    with pytest.raises(ValueError):
        TF.flash_attention_backward(q, k, v, o, lse, do.cpu())
    with pytest.raises(ValueError):
        TF.flash_attention_backward(q, k, v, o, lse, do.transpose(1, 2)
                                    .contiguous().transpose(1, 2))


def test_lm_prefill_launches_flash_once_per_layer(dev):
    """starcoder2-7b at full width cut to 2 layers, bf16, on the card:
    prefill launches the flash kernel once per layer, decode never; the
    cuda backend's logits stay near the torch backend's (the same weights
    with the plain attention; bf16 attention accumulators differ)."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch("starcoder2-7b"), n_layers=2,
                              repeat=2)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (2, 300), generator=gen,
                            device=dev)
    TF.reset_launches()
    logits, caches = serve.prefill(model, prompts, 304)
    assert TF.LAUNCHES["flash_attention"] == 2
    toks = serve.decode(model, logits, caches, 300, 4)
    assert TF.LAUNCHES["flash_attention"] == 2
    assert toks.shape == (2, 4) and bool(((toks >= 0) &
                                          (toks < cfg.vocab)).all())
    model.backend = "torch"
    ref, _ = model.prefill_step(prompts)
    assert TF.LAUNCHES["flash_attention"] == 2
    assert float((logits - ref).abs().max()) <= 0.25 * float(ref.std())


def test_gemma2_prefill_launches_windowed_and_global(dev):
    """gemma2-9b at full width cut to one unit (a local and a global
    layer), its window cut to 128 keys so that a prompt of 300 is windowed:
    prefill launches the kernel once a layer (windowed, then global),
    decode and long_mode decode never; the logits stay near the torch
    backend's, as in the test above."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch("gemma2-9b"), n_layers=2, repeat=1,
                              local_window=128)
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (2, 300), generator=gen,
                            device=dev)
    windows = []
    real = TF.flash_attention

    def seen(q, k, v, **kw):
        windows.append(kw.get("window"))
        return real(q, k, v, **kw)

    TF.reset_launches()
    TF.flash_attention = seen
    try:
        logits, caches = serve.prefill(model, prompts, 304)
    finally:
        TF.flash_attention = real
    assert TF.LAUNCHES["flash_attention"] == 2 and windows == [128, None]
    for long_mode in (False, True):
        toks = serve.decode(model, logits, [dict(c) for c in caches], 300,
                            4, long_mode=long_mode)
        assert toks.shape == (2, 4) and bool(((toks >= 0) &
                                              (toks < cfg.vocab)).all())
    assert TF.LAUNCHES["flash_attention"] == 2
    model.backend = "torch"
    ref, _ = model.prefill_step(prompts)
    assert TF.LAUNCHES["flash_attention"] == 2
    assert float((logits - ref).abs().max()) <= 0.25 * float(ref.std())


def test_llama_vision_serve_on_card_matches_torch(dev):
    """llama-3.2-vision-11b reduced, float32, on the card: the cuda
    backend (the kernel on the CUDA cores, dh 16) against the torch
    backend on the same weights and image tokens: prefill logits within
    1e-4, the same greedy tokens, one launch per self-attention layer."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    cfg = reduced(get_arch("llama-3.2-vision-11b"))
    model = Model(cfg, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12))).to(dev)
    src = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    n_attn = sum(s["mixer"] == "attn" for s in cfg.pattern) * cfg.repeat
    out = {}
    for backend in ("cuda", "torch"):
        model.backend = backend
        TF.reset_launches()
        logits, caches = serve.prefill(model, prompts, 20, src)
        assert TF.LAUNCHES["flash_attention"] == \
            (n_attn if backend == "cuda" else 0)
        out[backend] = (logits, serve.decode(model, logits, caches, 12, 8,
                                             src))
    torch.testing.assert_close(out["cuda"][0], out["torch"][0], rtol=0,
                               atol=1e-4)
    assert torch.equal(out["cuda"][1], out["torch"][1])


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_recurrent_serve_on_card_matches_cpu_run(dev, arch):
    """xlstm-125m and jamba-v0.1-52b reduced, float32: the same weights
    served on the card (cuda backend: the SSM mixers, the MoE routing and
    dispatch, jamba's flash launches) and on the CPU; prompts of 128 (two
    64-position chunks): prefill logits within 1e-4, equal greedy
    tokens, one flash launch per attention layer on the card."""
    import copy
    from repro_torch.configs.archs import get_arch
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    cfg = reduced(get_arch(arch))
    out = {}
    host = Model(cfg, dtype=torch.float32, device="cpu")
    host.init(torch.Generator().manual_seed(0))
    card = Model(cfg, dtype=torch.float32, device=dev)
    card.params = copy.deepcopy(host.params).to(dev)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 128)))
    n_attn = sum(s["mixer"] == "attn" for s in cfg.pattern) * cfg.repeat
    for model in (host, card):
        TF.reset_launches()
        logits, caches = serve.prefill(model, prompts, 136)
        assert TF.LAUNCHES["flash_attention"] == \
            (n_attn if model is card else 0)
        out[model.device.type] = (logits.cpu(), serve.decode(
            model, logits, caches, 128, 8).cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-4)
    assert torch.equal(out["cuda"][1], out["cpu"][1])


# ---------------------------------------------------------------------------
# Triangle counting and the DSL sessions on the card
# ---------------------------------------------------------------------------

def sym_graph_and_stream(where, seed=0, n=300, m=1500, percent=10):
    """A symmetrized random graph and an update stream whose two
    directions of an edge sit side by side (so a batch of even size
    never splits them), as benchmarks/dynamic_vs_static.py makes them."""
    from repro_torch.algos.oracles import symmetrize
    n, edges, w = random_graph(seed, n, m)
    e, w2 = symmetrize(edges, w)
    csr = repro_torch.build_csr(n, e, w2, device=where)
    ups = repro_torch.random_updates(csr, percent=percent, seed=seed + 1)
    adds = np.stack([ups.adds, ups.adds[:, [1, 0, 2]]], 1).reshape(-1, 3)
    dels = np.stack([ups.dels, ups.dels[:, [1, 0]]], 1).reshape(-1, 2)
    return csr, repro_torch.UpdateStream(adds=adds, dels=dels)


ROW_KERNELS = ("fused_relax_rows", "fused_spmv_rows")


@pytest.mark.parametrize("backend", ["cuda", "cuda_chained", "torch"])
def test_tc_on_card_matches_cpu_run_and_oracle(dev, backend):
    """static_tc, dyn_tc and the stream executor on the card give the CPU
    run's int32 counts and the oracle's; cuda merges each add batch with
    merge_pool_sorted and no row kernel runs."""
    from repro_torch.algos import oracles, triangles
    out = []
    for where in ("cpu", dev):
        csr, stream = sym_graph_and_stream(where)
        for mod in (TK, TC):
            mod.reset_launches()
        sess = repro_torch.bind_graph(csr, backend=backend, device=where,
                                      capacity=2 * stream.num_adds)
        c0 = sess.call(triangles.static_tc)
        c1 = sess.call(triangles.dyn_tc, stream, 32)
        sess = repro_torch.bind_graph(csr, backend=backend, device=where,
                                      capacity=2 * stream.num_adds)
        c2 = sess.run_stream(stream, 32, triangles.stream_step,
                             sess.call(triangles.static_tc))
        out.append(([c0, c1, c2], {**TK.LAUNCHES, **TC.LAUNCHES}))
    (cpu, _), (gpu, launches) = out
    for a, b in zip(cpu, gpu):
        assert b.dtype == torch.int32 and b.device.type == dev.type
        assert int(a) == int(b)
    csr, stream = sym_graph_and_stream("cpu")
    e = np.stack([csr.src.numpy(), csr.dst.numpy()], 1)
    post, _ = oracles.edges_after_updates(csr.n, e, csr.w.numpy(),
                                          stream.adds, stream.dels)
    assert int(cpu[0]) == oracles.tc_oracle(csr.n, e)
    assert int(cpu[1]) == int(cpu[2]) == oracles.tc_oracle(csr.n, post)
    nb = stream.num_batches(32)
    assert launches["merge_pool_sorted"] == (2 * nb if backend == "cuda"
                                             else 0)
    assert all(launches[k] == 0 for k in ROW_KERNELS + tuple(TC.LAUNCHES))


def dsl_sssp(where, backend, stream=None, capacity=1024):
    from repro_torch import dsl_programs
    n, edges, w = random_graph(7, 300, 1500)
    csr = repro_torch.build_csr(n, edges, w, device=where)
    if stream is None:
        stream = repro_torch.random_updates(csr, percent=20, seed=7)
    sess = repro_torch.compile(dsl_programs.path("sssp")).bind(
        csr, backend=backend, capacity=capacity, device=where)
    return csr, stream, sess


def test_dsl_sssp_session_on_card(dev):
    """DynSSSP through compile → bind → run on cuda: the CPU session's
    dist and parent, the hand-staged cuda run's dist; armed applies equal
    the one-shot run; merge_pool_sorted launches once per add batch and
    no row kernel runs (DSL sweeps take the segment path)."""
    _, stream, cpu = dsl_sssp("cpu", "cuda")
    want = cpu.run("DynSSSP", updateBatch=stream, batchSize=16, src=0)
    for mod in (TK, TC):
        mod.reset_launches()
    csr, _, sess = dsl_sssp(dev, "cuda", stream)
    got = sess.run("DynSSSP", updateBatch=stream, batchSize=16, src=0)
    assert TK.LAUNCHES["merge_pool_sorted"] == stream.num_batches(16)
    assert all(TK.LAUNCHES[k] == 0 for k in ROW_KERNELS)
    assert set(TC.LAUNCHES.values()) == {0}
    for k in ("dist", "parent"):
        assert torch.equal(got.props[k].cpu(), want.props[k]), k
    hand = repro_torch.bind_graph(csr, backend="cuda", capacity=1024,
                                  device=dev)
    props = hand.call(sssp.static_sssp, 0)
    props = hand.run_stream(stream, 16, sssp.stream_step, props)
    assert torch.equal(props["dist"], got.props["dist"])
    _, _, armed = dsl_sssp(dev, "cuda", stream)
    armed.run("DynSSSP", batchSize=16, src=0)
    for b in stream.batches(16, device=dev):
        armed.apply(b)
    for k, v in got.props.items():
        assert torch.equal(armed.props[k], v), k


def test_dsl_save_restore_on_card(dev, tmp_path):
    """An armed DynSSSP saved midway on the card and restored finishes
    bit for bit as the uninterrupted run: dist, every DynGraph array and
    the ELL pack."""
    _, stream, full = dsl_sssp(dev, "cuda")
    batches = list(stream.batches(16, device=dev))
    assert len(batches) >= 2
    full.run("DynSSSP", batchSize=16, src=0)
    for b in batches:
        full.apply(b)
    _, _, part = dsl_sssp(dev, "cuda", stream)
    part.run("DynSSSP", batchSize=16, src=0)
    k = len(batches) // 2
    for b in batches[:k]:
        part.apply(b)
    part.save(tmp_path)
    del part
    back = repro_torch.restore_session(tmp_path, device=dev)
    assert back.armed and back.stream_cursor == k and back.device == dev
    for b in batches[k:]:
        back.apply(b)
    for k_, v in full.props.items():
        assert torch.equal(back.props[k_], v), k_
    for part_ in ("g", "ell"):
        a, b = getattr(full.handle, part_), getattr(back.handle, part_)
        for f, x in vars(a).items():
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(b, f)), (part_, f)


# ---------------------------------------------------------------------------
# slice 9: the batched merge, failover and the pool on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 3, 32])
@pytest.mark.parametrize("i", [0, 3, 5, 8, 12, 13],
                         ids=[chip_smoke.MERGE_CASES[i][0]
                              for i in (0, 3, 5, 8, 12, 13)])
def test_batched_merge_kernel_on_merge_cases(dev, i, S):
    """MERGE_CASES stacked S sessions wide: one launch equals its plain
    version and S solo launches, bit for bit."""
    _, D, B, pool_used, batch_used, ties, where = chip_smoke.MERGE_CASES[i]
    sessions = [chip_smoke.merge_case(np, 1000 * i + s, D, B, pool_used,
                                      batch_used, ties, where)
                for s in range(S)]
    st = [torch.from_numpy(np.stack(col)).to(dev) for col in zip(*sessions)]
    n = chip_smoke.MERGE_N
    before = TK.LAUNCHES["merge_pool_sorted_batched"]
    with chip_smoke.junk_outputs(torch):
        got = TK.merge_pool_sorted_batched(*st, n=n)
    assert TK.LAUNCHES["merge_pool_sorted_batched"] == before + 1
    want = TK.merge_pool_sorted_batched_plain(*st, n)
    solo = [TK.merge_pool_sorted(*(x[s] for x in st), n=n)
            for s in range(S)]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), k
        assert torch.equal(g, torch.stack([o[k] for o in solo])), k


def test_batched_merge_refuses_bad_inputs(dev):
    st = [torch.from_numpy(np.stack(col)).to(dev) for col in zip(
        *(chip_smoke.merge_case(np, s, 100, 40, 60, 40, 0.25, None)
          for s in range(2)))]
    with pytest.raises(ValueError):
        TK.merge_pool_sorted_batched(*st[:4], *(x[:1] for x in st[4:]),
                                     n=chip_smoke.MERGE_N)
    with pytest.raises(TypeError):
        TK.merge_pool_sorted_batched(st[0].long(), *st[1:],
                                     n=chip_smoke.MERGE_N)


def test_failover_hop_on_card(dev):
    """A fault planted at cuda's update_add launch moves an SSSP session
    to cuda_chained and then torch on the card; dist and the alive edges
    equal an undisturbed cuda run, and the re-probe brings it back."""
    from repro_torch.runtime import faults
    n, edges, w = random_graph(7, 300, 2400)
    csr = repro_torch.build_csr(n, edges, w, device=dev)
    stream = repro_torch.random_updates(csr, percent=10, seed=2)
    ref = repro_torch.bind_graph(csr, backend="cuda", capacity=1024,
                                 device=dev)
    want = ref.run_stream(stream, 16, sssp.stream_step,
                          ref.call(sssp.static_sssp, 0))
    sess = repro_torch.bind_graph(csr, backend="cuda", capacity=1024,
                                  failover=True, device=dev)
    sess._failover.probe_base_s = 0.0
    props = sess.call(sssp.static_sssp, 0)
    with faults.inject("kernel_launch", times=None, after=2,
                       match=lambda c: c.get("engine") == "cuda"
                       and c.get("op") == "update_add"):
        props = sess.run_stream(stream, 16, sssp.stream_step, props)
    assert sess.backend_name == "torch" and sess.health.failovers == 2
    assert sess.engine.device == dev
    for k in ("dist", "parent"):
        assert torch.equal(props[k], want[k]), k
    for f in ("src", "dst", "w", "alive", "d_src", "d_dst", "d_w",
              "d_alive"):
        assert torch.equal(getattr(sess.handle, f), getattr(ref.handle.g, f))
    TK.reset_launches()
    extra = repro_torch.random_updates(csr, percent=1, seed=3)
    props = sess.run_stream(extra, 16, sssp.stream_step, props)
    want = ref.run_stream(extra, 16, sssp.stream_step, want)
    assert sess.backend_name == "cuda" and not sess.health.degraded
    assert TK.LAUNCHES["fused_relax_rows"] > 0
    for k in ("dist", "parent"):
        assert torch.equal(props[k], want[k]), k


def test_pool_vmap_launches_the_batched_merge_once_a_round(dev):
    """Five structural tenants in vmap mode: one batched merge launch a
    round, no solo merge, the tenants equal solo cuda sessions."""
    from repro_torch.core import registry
    from repro_torch.serve import SessionPool
    n, edges, w = random_graph(11, 256, 2000)
    csr = repro_torch.build_csr(n, edges, w, device=dev)
    streams = [repro_torch.random_updates(csr, percent=20, seed=t)
               for t in range(5)]
    registry.clear_shared_engines()
    pool = SessionPool(backend="cuda", batch_mode="vmap", device=dev)
    for t in range(5):
        pool.bind(f"t{t}", csr, capacity=256)
    TK.reset_launches()
    for i in range(2):
        pool.apply_many([(f"t{t}", streams[t].batch(i, 32, device=dev))
                         for t in range(5)])
    assert TK.LAUNCHES["merge_pool_sorted_batched"] == 2
    assert TK.LAUNCHES["merge_pool_sorted"] == 0
    for t in range(5):
        solo = repro_torch.bind_graph(csr, backend="cuda", capacity=256,
                                      device=dev)
        for i in range(2):
            solo.apply(streams[t].batch(i, 32, device=dev))
        got = pool.session(f"t{t}").handle
        for part in ("g", "ell"):
            a, b = getattr(got, part), getattr(solo.handle, part)
            for f, x in vars(a).items():
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, getattr(b, f)), (t, part, f)
    registry.clear_shared_engines()


def test_set_drop_last_lane_wins_on_card(dev):
    """``tensors.set_drop(last_wins=True)`` on the card, where
    ``index_put_`` picks no fixed winner among duplicate lanes: equal to
    the CPU's sequential scatter at the main path's lane count, with every
    index written by many lanes."""
    from repro_torch.tensors import set_drop
    rng = np.random.default_rng(0)
    L, W = 4096, 65536
    buf = torch.from_numpy(rng.integers(0, 9, L).astype(np.int32))
    idx = torch.from_numpy(rng.integers(-L, 2 * L, W).astype(np.int32))
    vals = torch.from_numpy(rng.integers(0, 1 << 30, W).astype(np.int32))
    want = set_drop(buf, idx, vals, last_wins=True)
    got = set_drop(buf.to(dev), idx.to(dev), vals.to(dev), last_wins=True)
    assert torch.equal(got.cpu(), want)


# -- the fused stream executor (captured CUDA graphs, conditional nodes) ----

def test_captured_while_and_if_match_eager(dev):
    """A WHILE node (a loop of data-dependent trips with a kernel launch in
    its body), the two IF nodes of a branch and a loop inside a loop (two
    deep, as a captured wedge walk's pool searches), run uncaptured at the
    segment's first call, then captured once and replayed on new inputs,
    equal the host-driven loop; ``LAUNCHES`` gets the body's launches once
    per trip the card ran."""
    from repro_torch.core import device_loop as DL
    ell_src = torch.randint(0, 201, (256, 8), dtype=torch.int32, device=dev)
    ell_w = torch.randint(1, 9, (256, 8), dtype=torch.int32, device=dev)

    def body(h, c, b):
        i, x = DL.while_loop(lambda s: s[1].sum() < 5000,
                             lambda s: (s[0] + 1, s[1] * 2 + b[0]),
                             (0, h["x"]))
        y = DL.cond(x.sum() > 7000, lambda o: o + 1, lambda o: o - 1,
                    h["y"])

        def relax(s):
            rmin = TK.fused_relax_rows(ell_src, ell_w, s[1], block=128)[0]
            v = torch.minimum(s[1][:-1], rmin[:200])
            return s[0] + 1, torch.cat([v, s[1][-1:]])

        _, vals = DL.while_loop(lambda s: s[0] < h["k"], relax,
                                (0, h["vals"]))

        def outer(s):
            _, inner = DL.while_loop(lambda t: t[0] < s[0],
                                     lambda t: (t[0] + 1, t[1] + 1),
                                     (0, s[1]))
            return s[0] + 1, inner

        _, tri = DL.while_loop(lambda s: s[0] < h["k"], outer,
                               (0, h["tri"]))
        return {**h, "x": x, "y": y, "vals": vals, "tri": tri}, c + i

    def counters(h):
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return torch.stack([h["x"].sum().int(), z, z])

    seg = DL.SegmentGraph(body, counters, dev)
    c = torch.zeros((), dtype=torch.int32, device=dev)
    b = torch.ones((2, 4), dtype=torch.int32, device=dev)
    for step, (shift, k) in enumerate(((0, 3), (5, 1), (100, 0), (7, 4))):
        h = {"x": torch.arange(4, device=dev, dtype=torch.int32) + shift,
             "y": torch.zeros(4, dtype=torch.int32, device=dev),
             "k": torch.tensor(k, dtype=torch.int32, device=dev),
             "vals": torch.randint(0, 100, (201,), dtype=torch.int32,
                                   device=dev),
             "tri": torch.zeros(3, dtype=torch.int32, device=dev)}
        TK.reset_launches()
        want_h, want_c = body(h, c, b)
        want_launches = TK.LAUNCHES["fused_relax_rows"]
        assert want_launches == k
        assert torch.equal(want_h["tri"].cpu(),
                           torch.full((3,), k * (k - 1) // 2,
                                      dtype=torch.int32))
        TK.reset_launches()
        got_h, got_c, _ = seg(h, c, b)
        assert (seg.graph is None) == (step == 0)
        assert TK.LAUNCHES["fused_relax_rows"] == want_launches
        if step:
            assert seg.launches_per_replay().get("fused_relax_rows",
                                                 0) == k
        assert torch.equal(got_c, want_c)
        for key in want_h:
            assert torch.equal(got_h[key], want_h[key]), (shift, key)
            # the results are copies: no caller's tensor is the graph's
            assert got_h[key] is not h[key] or key == "k"
    assert seg.cap.nodes == 6 and seg.replays == 3


@pytest.mark.parametrize("algo,backend", [
    ("sssp", "cuda"), ("sssp", "cuda_chained"), ("pagerank", "cuda"),
    ("pagerank", "cuda_chained"), ("tc", "cuda"), ("sssp", "frontier")])
def test_fused_stream_matches_per_batch_on_card(dev, algo, backend):
    """The fused executor against the per-batch driver on the card, three
    times from the same start (the segment uncaptured, captured, then
    replayed): carries and handles bit for bit, and the kernels'
    ``LAUNCHES`` equal the per-batch run's every time; a replayed segment
    reads the host twice."""
    from repro_torch.algos import triangles
    from repro_torch.core.engine import Engine
    import warnings
    if algo == "tc":
        n = 1 << 10
        rng = np.random.default_rng(0)
        e = rng.integers(0, n, (n * 4, 2))
        e = np.unique(np.concatenate([e, e[:, ::-1]]), axis=0)
        e = e[e[:, 0] != e[:, 1]]
        csr = repro_torch.build_csr(n, e, np.ones(len(e), np.int32),
                                    device=dev)
        ups = repro_torch.random_updates(csr, percent=2, seed=3)
        stream = repro_torch.UpdateStream(
            adds=np.concatenate([ups.adds, ups.adds[:, [1, 0, 2]]]),
            dels=np.concatenate([ups.dels, ups.dels[:, ::-1]]))
        static, step, bs = (triangles.static_tc,), triangles.stream_step, 32
    else:
        n, edges, w = random_graph(7, 3000, 24000)
        csr = repro_torch.build_csr(n, edges, w, device=dev)
        stream = repro_torch.random_updates(csr, percent=2, seed=1)
        bs = 128
        if algo == "sssp":
            static, step = (sssp.static_sssp, 0), sssp.stream_step
        else:
            static = (pagerank.static_pr, 1e-4, 0.85, 100)
            step = pagerank.make_stream_step(1e-4, 0.85, 100)
    sess = repro_torch.bind_graph(csr, backend=backend,
                                  capacity=2 * stream.num_adds, device=dev)
    c0 = sess.call(*static)
    eng, h0 = sess.engine, sess.handle

    def launches():
        out = {}
        for m in (TK, TC, TS):
            out.update({k: v for k, v in m.LAUNCHES.items() if v})
            m.reset_launches()
        return out

    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return out, sum("synchroniz" in str(x.message) for x in caught)

    launches()
    he, ce = Engine.run_stream(eng, h0, stream, bs, step, c0)
    want = launches()
    for i in range(3):
        (hf, cf), n_sync = syncs(
            lambda: eng.run_stream(h0, stream, bs, step, c0,
                                   segment_size=64))
        assert launches() == want, i
        captured = [r for r in eng._stream_cache.values()
                    if r.graph is not None]
        assert len(captured) == (i > 0), i
        if i == 2:
            assert n_sync <= 2
        for a, b in zip(DL_tensors(ce), DL_tensors(cf)):
            assert torch.equal(a, b)
        ga, gb = eng.handle_graph(he), eng.handle_graph(hf)
        for f in ("alive", "w", "d_src", "d_dst", "d_w", "d_alive",
                  "d_offsets", "overflow"):
            assert torch.equal(getattr(ga, f), getattr(gb, f)), f


def DL_tensors(tree):
    from repro_torch.core import device_loop
    return device_loop.tensors(tree)


def test_capture_failure_raises_and_never_runs_eagerly(dev):
    """A step that reads the host runs uncaptured at its segment's first
    use, as every segment does; at the second use it cannot be captured:
    the fused executor raises through the session (a kernel failure in its
    health), nothing of that stream is applied, and no eager run finishes
    the job."""
    n, edges, w = random_graph(11, 500, 3000)
    csr = repro_torch.build_csr(n, edges, w, device=dev)
    stream = repro_torch.random_updates(csr, percent=5, seed=2)

    def reads_host(engine, g, batch, props):
        if bool(props["dist"].min() >= 0):          # a host read
            return sssp.stream_step(engine, g, batch, props)
        return g, props

    sess = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=4 * stream.num_adds, device=dev)
    p0 = sess.call(sssp.static_sssp, 0)
    p1 = sess.run_stream(stream, 64, reads_host, p0)
    want = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=4 * stream.num_adds, device=dev)
    pw = want.run_stream(stream, 64, sssp.stream_step,
                         want.call(sssp.static_sssp, 0))
    for k in ("dist", "parent"):
        assert torch.equal(p1[k], pw[k]), k
    cursor = sess.stream_cursor
    before = [t.clone() for t in DL_tensors(sess.handle)]
    with pytest.raises(Exception):
        sess.run_stream(stream, 64, reads_host, p1)
    assert sess.health.kernel_failures == 1
    assert sess.stream_cursor == cursor
    for a, b in zip(before, DL_tensors(sess.handle)):
        assert torch.equal(a, b)


def test_fault_after_a_replayed_segment_leaves_the_handle_unchanged(dev):
    """A 12-batch stream in segments of 4 on a session that has already
    run one such stream (its segments uncaptured, captured, replayed): its
    first segment replays the captured graph, and a fault at the
    ``segment_scan`` seam of its second (start 4) leaves the session's
    handle as it was before the stream, since a replay never writes a
    handle a caller holds.  The stream run again without the fault equals
    the per-batch driver (``Engine.run_stream``) bit for bit."""
    from repro_torch.core.engine import Engine
    from repro_torch.runtime import faults
    n, edges, w = random_graph(13, 3000, 24000)
    csr = repro_torch.build_csr(n, edges, w, device=dev)
    bs, nb = 16, 12

    def stream_of(seed):
        ups = repro_torch.random_updates(csr, percent=2, seed=seed)
        assert min(ups.num_adds, ups.num_dels) >= bs * nb
        return repro_torch.UpdateStream(adds=ups.adds[:bs * nb],
                                        dels=ups.dels[:bs * nb])

    s1, s2 = stream_of(4), stream_of(5)
    cap = 2 * (s1.num_adds + s2.num_adds)
    sess = repro_torch.bind_graph(csr, backend="cuda", capacity=cap,
                                  device=dev)
    p1 = sess.run_stream(s1, bs, sssp.stream_step,
                         sess.call(sssp.static_sssp, 0), segment_size=4)
    runs = [r for r in sess.engine._stream_cache.values()
            if r.graph is not None]
    assert len(runs) == 1 and runs[0].replays == 2
    cursor = sess.stream_cursor
    before = [t.clone() for t in DL_tensors(sess.handle)]
    with faults.inject("segment_scan",
                       match=lambda ctx: ctx.get("start") == 4) as inj:
        with pytest.raises(Exception):
            sess.run_stream(s2, bs, sssp.stream_step, p1, segment_size=4)
    assert inj.fired == 1 and runs[0].replays == 3
    assert sess.stream_cursor == cursor
    for a, b in zip(before, DL_tensors(sess.handle)):
        assert torch.equal(a, b)
    p2 = sess.run_stream(s2, bs, sssp.stream_step, p1, segment_size=4)

    ref = repro_torch.bind_graph(csr, backend="cuda", capacity=cap,
                                 device=dev)
    eng = ref.engine
    h, q = Engine.run_stream(eng, ref.handle, s1, bs, sssp.stream_step,
                             ref.call(sssp.static_sssp, 0))
    h, q = Engine.run_stream(eng, h, s2, bs, sssp.stream_step, q)
    for k in ("dist", "parent"):
        assert torch.equal(p2[k], q[k]), k
    for a, b in zip(DL_tensors(h), DL_tensors(sess.handle)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the distributed backends on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dist", "dist_sharded"])
def test_dist_stacked_on_card_matches_torch(dev, backend):
    """Two shards stacked on the card against the torch backend there:
    SSSP bit for bit, PageRank to 1e-5; the fused stream three times from
    one start (uncaptured, captured, replayed) equals the per-batch
    driver bit for bit."""
    from repro_torch.core.engine import Engine
    n, edges, w = random_graph(11, 3000, 24000)
    csr = repro_torch.build_csr(n, edges, w, device=dev)
    stream = repro_torch.random_updates(csr, percent=2, seed=1)
    bs = 128
    paths = {"sssp": ((sssp.static_sssp, 0), sssp.stream_step),
             "pagerank": ((pagerank.static_pr, 1e-4, 0.85, 100),
                          pagerank.make_stream_step(1e-4, 0.85, 100))}
    for algo, (static, step) in paths.items():
        ref = repro_torch.bind_graph(csr, backend="torch",
                                     capacity=2 * stream.num_adds,
                                     device=dev)
        want = ref.run_stream(stream, bs, step, ref.call(*static))
        sess = repro_torch.bind_graph(csr, backend=backend, num_shards=2,
                                      capacity=2 * stream.num_adds,
                                      device=dev)
        c0 = sess.call(*static)
        eng, h0 = sess.engine, sess.handle
        assert eng.comm.kind == "stacked" and h0.src.shape[0] == 2
        if backend == "dist_sharded":
            # the stream's inserts miss the first ghost tables (a rebuild
            # through the overflow lane, so a fused run from h0 never
            # reuses a segment); its ghost hints kept, a fresh prepare
            # covers them and the runs below capture
            Engine.run_stream(eng, h0, stream, bs, step, c0)
            assert eng.rebuilds["halo"] >= 1, eng.rebuilds
            h0 = eng.prepare(csr, 2 * stream.num_adds)
        he, ce = Engine.run_stream(eng, h0, stream, bs, step, c0)
        for i in range(3):
            hf, cf = eng.run_stream(h0, stream, bs, step, c0,
                                    segment_size=64)
            for k in ce:
                assert torch.equal(ce[k], cf[k]), (algo, i, k)
            for f in ("alive", "w", "d_src", "d_dst", "d_w", "d_alive",
                      "d_offsets", "overflow"):
                assert torch.equal(getattr(he, f), getattr(hf, f)), f
        captured = [r for r in eng._stream_cache.values()
                    if getattr(r, "graph", None) is not None]
        assert captured, "no segment was captured"
        if algo == "sssp":
            for k in ("dist", "parent"):
                assert torch.equal(ce[k][:n], want[k][:n]), k
        else:
            torch.testing.assert_close(ce["pr"][:n], want["pr"][:n],
                                       rtol=1e-5, atol=1e-9)


def test_nccl_one_rank_equals_stacked(dev):
    """One NCCL rank (``comm="group"``, the per-batch driver) against the
    stacked P = 1 run: SSSP and PageRank bit for bit."""
    import torch.distributed as tdist
    n, edges, w = random_graph(12, 2000, 16000)
    csr = repro_torch.build_csr(n, edges, w, device=dev)
    stream = repro_torch.random_updates(csr, percent=2, seed=2)
    paths = {"sssp": ((sssp.static_sssp, 0), sssp.stream_step),
             "pagerank": ((pagerank.static_pr, 1e-4, 0.85, 100),
                          pagerank.make_stream_step(1e-4, 0.85, 100))}

    def run(algo, **opts):
        static, step = paths[algo]
        sess = repro_torch.bind_graph(csr, backend="dist", device=dev,
                                      capacity=2 * stream.num_adds, **opts)
        return sess, sess.run_stream(stream, 128, step, sess.call(*static))

    want = {algo: run(algo, num_shards=1)[1] for algo in paths}
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        for algo in paths:
            sess, got = run(algo, comm="group")
            assert sess.engine.comm.kind == "group"
            for k in got:
                assert torch.equal(got[k], want[algo][k]), (algo, k)
    finally:
        tdist.destroy_process_group()


def test_mamba_scan_serving_form_matches_training_form_on_card(dev):
    """The Mamba doubling scan's serving form (buffers written with
    ``out=``) and its training form (``torch.cat``) on the card: the same
    bits, at jamba's chunk of 64 positions and d_state 16."""
    from repro_torch.models import ssm
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.rand((2, 64, 1024, 16), generator=g, device=dev)
    bu = torch.randn((2, 64, 1024, 16), generator=g, device=dev)
    h0 = torch.randn((2, 1024, 16), generator=g, device=dev)
    with torch.no_grad():
        h, last = ssm._mamba_scan_chunk(h0, a, bu)
    ht, lastt = ssm._mamba_scan_chunk(h0, a.clone().requires_grad_(), bu)
    assert torch.equal(h, ht.detach()) and torch.equal(last, lastt.detach())
