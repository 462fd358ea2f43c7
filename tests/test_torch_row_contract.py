"""The row kernels' contract on the CPU, where the wrappers run
their plain versions (the CUDA kernels are held to those bit for bit on
the card, tests/test_torch_cuda.py): against repro's Pallas kernels in
interpret mode on packs with padding slots, vacant rows and a vals[n]
that is no identity, and against a numpy statement of the contract (the
left-to-right float sum, the row argmin's sentinel rule, the per-tile
compaction).  Also the tile the wrappers choose, and which launches take
the kernels' warp-loaded path (the fused kernels', and the three chained
kernels').

Integer outputs, the compacted rows and the counts are compared bit for
bit; the float row sums agree with the Pallas kernel to rtol 1e-6 (XLA's
reduction order) and with the numpy left-to-right sum bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import csr_relax as RC
from repro.kernels import pallas_repair as RK
from repro_torch.graph.csr import INF_W
from repro_torch.kernels import csr_relax as TC
from repro_torch.kernels import repair as TK
from repro_torch.kernels.ell import ell_capacity

SENTINELS = (12345, 0.5)     # vals[n]: neither the min-plus nor the sum's identity


def padded_pack(n, R, K, seed):
    """R rows: row r's first c_r ~ U[0, K] slots live, the rest padding
    (src n, w 0); rows with c_r = 0 are vacant, at the end with row2dst
    n, as a real pack keeps them."""
    rng = np.random.default_rng(seed)
    fill = np.sort(rng.integers(0, K + 1, R))[::-1]
    live = np.arange(K)[None, :] < fill[:, None]
    src = np.where(live, rng.integers(0, n, (R, K)), n).astype(np.int32)
    w = np.where(live, rng.integers(1, 50, (R, K)), 0).astype(np.int32)
    r2d = np.where(fill > 0, np.sort(rng.integers(0, n, R)), n)
    return src, w, r2d.astype(np.int32)


def sentinel_vals(n, seed):
    """int vals (30% unreached) and float vals (20% zero), with the
    SENTINELS at slot n."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1000, n + 1).astype(np.int32)
    v[:n][rng.random(n) < 0.3] = INF_W
    f = (rng.random(n + 1) / n).astype(np.float32)
    f[:n][rng.random(n) < 0.2] = 0.0
    v[n], f[n] = SENTINELS
    return v, f


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def compact_oracle(hit, bt):
    """Each tile's hit row ids in order, then R; and each tile's count."""
    R = hit.shape[0]
    rows = np.full(R, R, np.int32)
    counts = np.zeros(R // bt, np.int32)
    for i in range(R // bt):
        ids = np.flatnonzero(hit[i * bt:(i + 1) * bt]) + i * bt
        rows[i * bt:i * bt + len(ids)] = ids
        counts[i] = len(ids)
    return rows, counts


@pytest.mark.parametrize("bt", [128, 256, 512])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_relax_rows_match_pallas_on_padded_packs(K, bt):
    n = 700
    src, w, _ = padded_pack(n, bt * 5, K, seed=K + bt)
    vals, _ = sentinel_vals(n, seed=K)
    want = RK.fused_relax_rows(jnp.asarray(src), jnp.asarray(w),
                               jnp.asarray(vals), block=bt)
    got = TK.fused_relax_rows(t(src), t(w), t(vals), block=bt)
    for name, g, x in zip(("row_min", "row_arg", "rows", "counts"), got,
                          want):
        assert np.array_equal(g.numpy(), np.asarray(x)), name


@pytest.mark.parametrize("bt", [128, 256, 512])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_spmv_rows_match_pallas_on_padded_packs(K, bt):
    n = 700
    src, _, r2d = padded_pack(n, bt * 5, K, seed=K * bt)
    _, fvals = sentinel_vals(n, seed=K + 1)
    want = RK.fused_spmv_rows(jnp.asarray(src), jnp.asarray(r2d),
                              jnp.asarray(fvals), block=bt)
    row_sum, rows, counts = TK.fused_spmv_rows(t(src), t(r2d), t(fvals),
                                               block=bt)
    np.testing.assert_allclose(row_sum.numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=0)
    assert np.array_equal(rows.numpy(), np.asarray(want[1]))
    assert np.array_equal(counts.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("K", [4, 8, 16])
def test_chained_rows_match_pallas_on_padded_packs(K):
    """The three chained row kernels on a pack with padding slots, vacant
    rows and vals[n] no identity; relax_rowargmin's targets are reached on
    some rows and missed on others."""
    n, R = 700, 128 * 5
    src, w, _ = padded_pack(n, R, K, seed=3 * K)
    vals, fvals = sentinel_vals(n, seed=K + 2)
    rmin = TC.relax_rowmin(t(src), t(w), t(vals))
    assert np.array_equal(rmin.numpy(), np.asarray(RC.relax_rowmin(
        jnp.asarray(src), jnp.asarray(w), jnp.asarray(vals))))
    tgt = np.where(np.arange(R) % 3 == 0, rmin.numpy() + 1, rmin.numpy())
    got = TC.relax_rowargmin(t(src), t(w), t(vals), t(tgt), n=n)
    assert np.array_equal(got.numpy(), np.asarray(RC.relax_rowargmin(
        jnp.asarray(src), jnp.asarray(w), jnp.asarray(vals),
        jnp.asarray(tgt), n=n)))
    np.testing.assert_allclose(
        TC.spmv_rowsum(t(src), t(fvals)).numpy(),
        np.asarray(RC.spmv_rowsum(jnp.asarray(src), jnp.asarray(fvals))),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("K", [4, 8])
def test_row_kernels_on_one_tile_match_pallas(K):
    """R = bt = 128: one tile, one count."""
    n = 50
    src, w, r2d = padded_pack(n, 128, K, seed=K)
    vals, fvals = sentinel_vals(n, seed=K)
    relax = TK.fused_relax_rows(t(src), t(w), t(vals), block=128)
    want = RK.fused_relax_rows(jnp.asarray(src), jnp.asarray(w),
                               jnp.asarray(vals), block=128)
    for g, x in zip(relax, want):
        assert np.array_equal(g.numpy(), np.asarray(x))
    assert relax[3].shape == (1,)
    _, rows, counts = TK.fused_spmv_rows(t(src), t(r2d), t(fvals), block=128)
    want = RK.fused_spmv_rows(jnp.asarray(src), jnp.asarray(r2d),
                              jnp.asarray(fvals), block=128)
    assert np.array_equal(rows.numpy(), np.asarray(want[1]))
    assert np.array_equal(counts.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 7, 8, 16])
def test_row_sum_adds_left_to_right(K):
    """row_sum is ((v0 + v1) + v2) + ... in float32, padding slots adding
    vals[n]: the one order the kernels keep."""
    n = 400
    src, _, r2d = padded_pack(n, 256, K, seed=100 + K)
    _, fvals = sentinel_vals(n, seed=K)
    g = fvals[src]
    acc = g[:, 0].copy()
    for k in range(1, K):
        acc = (acc + g[:, k]).astype(np.float32)
    got = TK.fused_spmv_rows(t(src), t(r2d), t(fvals), block=128)[0]
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.int32), acc.view(np.int32))


@pytest.mark.parametrize("K", [1, 2, 4, 5, 8, 16])
def test_relax_rows_min_and_argmin_rule(K):
    """row_min is min_k vals[src] + w (int32, wrapping); row_arg the least
    source reaching it, or n where some slot misses the min and n is
    smaller (the reference's min(where(cand == rmin, src, n)))."""
    n = 300
    src, w, _ = padded_pack(n, 256, K, seed=200 + K)
    vals, _ = sentinel_vals(n, seed=K)
    rng = np.random.default_rng(K)
    tie = rng.random(256) < 0.3          # rows whose slots all tie
    src[tie] = src[tie, :1]
    w[tie] = w[tie, :1]
    cand = (vals[src].astype(np.int64) + w).astype(np.int32)
    rmin = cand.min(axis=1)
    rarg = np.where(cand == rmin[:, None], src, n).min(axis=1)
    got = TK.fused_relax_rows(t(src), t(w), t(vals), block=128)
    assert np.array_equal(got[0].numpy(), rmin)
    assert np.array_equal(got[1].numpy(), rarg)


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("bt", [32, 64, 128, 256, 512, 1024])
def test_rows_compact_per_tile_in_row_order(bt, density):
    """Each tile of bt rows holds its hit rows' ids in increasing order,
    then the sentinel R; counts[i] is tile i's number of hits."""
    n, R = 97, 2048
    rng = np.random.default_rng(bt)
    src = np.full((R, 4), n, np.int32)
    src[:, 0] = rng.integers(0, n, R)
    w = np.zeros((R, 4), np.int32)
    vals, fvals = sentinel_vals(n, seed=bt)
    vals[n] = INF_W
    vals[:n] = np.where(rng.random(n) < density, 1, INF_W)
    r2d = np.where(rng.random(R) < density, rng.integers(0, n, R), n)
    r2d = r2d.astype(np.int32)
    _, _, rows, counts = TK.fused_relax_rows(t(src), t(w), t(vals),
                                             block=bt)
    want = compact_oracle(vals[src[:, 0]] < INF_W, bt)
    assert np.array_equal(rows.numpy(), want[0])
    assert np.array_equal(counts.numpy(), want[1])
    _, rows, counts = TK.fused_spmv_rows(t(src), t(r2d), t(fvals), block=bt)
    want = compact_oracle(r2d < n, bt)
    assert np.array_equal(rows.numpy(), want[0])
    assert np.array_equal(counts.numpy(), want[1])


@pytest.mark.parametrize("R,block,want", [
    (1024, 256, 256), (1024, 512, 512), (1152, 256, 128), (128, 512, 128),
    (3 * 1024, 1024, 1024)])
def test_tile_is_the_block_where_it_divides_R(R, block, want):
    assert TK._row_block("fused_relax_rows", R, block) == want


@pytest.mark.parametrize("R,block", [(100, 256), (64, 64 * 3), (2048, 2048),
                                     (128 * 3, 48)])
def test_tile_that_cannot_cover_R_is_refused(R, block):
    """No tile of whole warps up to 1,024 rows that divides R: refused,
    not rounded."""
    with pytest.raises(ValueError):
        TK._row_block("fused_spmv_rows", R, block)


@pytest.mark.parametrize("n,e_cap,k", [(4_194_304, 66_000_000, 8),
                                       (1000, 8000, 8), (300, 2000, 4),
                                       (5000, 60000, 16), (64, 256, 8)])
def test_repair_config_takes_the_largest_dividing_tile(n, e_cap, k):
    """The largest of 512, 256, 128 that divides R and leaves two tiles."""
    R = ell_capacity(n, e_cap, k)
    bt = TK.repair_config(n, e_cap, k).row_block
    assert R % bt == 0
    bigger = [c for c in (512, 256) if c > bt]
    assert all(R % c or R // c < 2 for c in bigger)


def _view(x, offset):
    """x as a view ``offset`` int32 into a larger buffer."""
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype)
    return buf[offset:].view(x.shape).copy_(x)


@pytest.mark.parametrize("K,src_off,w_off,relax,spmv", [
    (8, 0, 0, True, True), (8, 4, 0, True, True), (8, 1, 0, False, False),
    (8, 0, 1, False, True), (8, 2, 3, False, False), (4, 0, 0, False, False),
    (16, 0, 0, False, False), (1, 0, 0, False, False)])
def test_warp_loaded_path_by_K_and_alignment(K, src_off, w_off, relax, spmv):
    """The warp-loaded path only for K = 8 with 16-byte aligned slots
    (ell_src, and ell_w for relax); views into a buffer at other offsets
    and other K load slot by slot."""
    src = _view(torch.zeros((256, K), dtype=torch.int32), src_off)
    w = _view(torch.zeros((256, K), dtype=torch.int32), w_off)
    assert src.data_ptr() % 16 == (src_off * 4) % 16
    assert TK.warp_loads(src, w) is relax
    assert TK.warp_loads(src) is spmv


@pytest.mark.parametrize("K,R,src_off,w_off,relax,spmv", [
    (8, 256, 0, 0, True, True), (8, 96, 4, 0, True, True),
    (8, 250, 0, 0, False, False), (8, 256 + 16, 0, 0, False, False),
    (8, 256, 1, 0, False, False), (8, 256, 0, 1, False, True),
    (8, 256, 2, 3, False, False), (4, 256, 0, 0, False, False),
    (16, 256, 0, 0, False, False)])
def test_chained_warp_loaded_path_by_K_R_and_alignment(K, R, src_off, w_off,
                                                       relax, spmv):
    """The chained kernels take their warp-loaded path only for K = 8, R a
    multiple of 32 (whole warps of rows, which their any-R launches need
    before their shuffles) and 16-byte aligned slots: ell_src for
    spmv_rowsum (``spmv``); ell_src and ell_w for relax_rowmin and
    relax_rowargmin (``relax``), which test them alike
    (csrc/csr_relax.cu: warp8(K, R, ell_src, ell_w) in both entry
    points)."""
    src = _view(torch.zeros((R, K), dtype=torch.int32), src_off)
    w = _view(torch.zeros((R, K), dtype=torch.int32), w_off)
    assert TC.warp_loads(src, w) is relax
    assert TC.warp_loads(src) is spmv
    cu = (TC._build.CSRC / "csr_relax.cu").read_text()
    for entry in ("repro_relax_rowmin", "repro_relax_rowargmin"):
        body = cu[cu.index(f"int {entry}("):]
        body = body[:body.index("return (int)cudaGetLastError();")]
        assert "if (warp8(K, R, ell_src, ell_w)) {" in body, entry
    body = cu[cu.index("int repro_spmv_rowsum("):]
    assert "if (warp8(K, R, ell_src, ell_src)) {" in body[:body.index(
        "return (int)cudaGetLastError();")]


@pytest.mark.parametrize("offset", [1, 3])
def test_misaligned_views_match_the_plain_versions(offset):
    """Misaligned views give the outputs of contiguous arrays (on the CPU
    both run the plain versions; on the card they take different
    loads)."""
    n = 300
    src, w, r2d = padded_pack(n, 256, 8, seed=offset)
    vals, fvals = sentinel_vals(n, seed=offset)
    a = TK.fused_relax_rows(t(src), t(w), t(vals), block=128)
    b = TK.fused_relax_rows(_view(t(src), offset), _view(t(w), offset),
                            t(vals), block=128)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = TK.fused_spmv_rows(t(src), t(r2d), t(fvals), block=128)
    b = TK.fused_spmv_rows(_view(t(src), offset), _view(t(r2d), offset),
                           t(fvals), block=128)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
