"""The kernels' plain versions against repro's Pallas kernels (interpret
mode) on the CPU: the fused repair kernels and the chained row kernels.
The CUDA kernels against their plain versions on the card:
tests/test_torch_cuda.py.

Integer and bool outputs are compared bit for bit.  Float row sums agree
to rtol 1e-6: the plain versions add the K lanes left to right, the
Pallas kernels in whatever order XLA's reduction takes."""
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.graph import build_csr as r_build_csr, from_csr as r_from_csr
from repro.kernels import csr_relax as RC
from repro.kernels import ops as rops
from repro.kernels import pallas_repair as RK
from repro.kernels.ell import pack_ell as r_pack_ell
from repro_torch.graph import build_csr as t_build_csr, from_csr as t_from_csr
from repro_torch.graph import diffcsr as td
from repro_torch.graph.csr import INF_W
from repro_torch.kernels import csr_relax as TC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import repair as TK
from repro_torch.kernels import segment as TS
from repro_torch.tensors import segment_sum
from repro_torch.kernels import ell as tell
from repro_torch.kernels.ell import pack_ell as t_pack_ell


sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (MERGE_CASES and their inputs)

R_PACK = jax.jit(r_pack_ell, static_argnames=("k",))


def random_ells(seed, n, e, k):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    w = rng.integers(1, 50, len(edges)).astype(np.int32)
    ref = R_PACK(r_from_csr(r_build_csr(n, edges, w), 4), k=k)
    port = t_pack_ell(t_from_csr(t_build_csr(n, edges, w, device="cpu"), 4),
                      k=k)
    vals = np.concatenate([rng.integers(0, 1000, n),
                           [INF_W]]).astype(np.int32)
    vals[:n][rng.random(n) < 0.3] = INF_W      # a partial frontier
    return ref, port, vals


CASES = [(200, 1000, 4, 128), (300, 2000, 8, 256)]


@pytest.fixture(scope="module")
def relax_refs():
    """repro's fused_relax_rows and vertex_relax_fused, once per case."""
    out = {}
    for n, e, k, block in CASES:
        ref, port, vals = random_ells(n + e, n, e, k)
        rows = RK.fused_relax_rows(ref.ell_src, ref.ell_w, jnp.asarray(vals),
                                   block=block)
        vert = rops.vertex_relax_fused(ref, jnp.asarray(vals), block=block)
        out[(n, e, k, block)] = (port, vals, [np.asarray(x) for x in rows],
                                 [np.asarray(x) for x in vert])
    return out


@pytest.mark.parametrize("case", CASES)
def test_relax_rows_plain_matches_pallas(relax_refs, case):
    """row_min, row_arg, the per-block compacted rows and the counts."""
    port, vals, want, _ = relax_refs[case]
    got = TK.fused_relax_rows(port.ell_src, port.ell_w,
                              torch.from_numpy(vals), block=case[3])
    for name, g, w in zip(("row_min", "row_arg", "rows", "counts"), got,
                          want):
        assert g.dtype == torch.int32, name
        assert np.array_equal(g.numpy(), w), name


@pytest.mark.parametrize("case", CASES)
def test_vertex_relax_fused_matches(relax_refs, case):
    port, vals, _, want = relax_refs[case]
    got = tops.vertex_relax_fused(port, torch.from_numpy(vals),
                                  block=case[3])
    for name, g, w in zip(("vmin", "parent", "hit"), got, want):
        assert np.array_equal(g.numpy(), w), name


def float_vals(seed, n):
    """(n+1,) float32 PageRank-like contributions, 0.0 at slot n."""
    rng = np.random.default_rng(seed)
    v = rng.random(n).astype(np.float32) / n
    v[rng.random(n) < 0.2] = 0.0
    return np.concatenate([v, [0.0]]).astype(np.float32)


@pytest.fixture(scope="module")
def spmv_refs():
    """repro's fused_spmv_rows, csr_relax kernels and vertex ops, once per
    case, on integer and float vals."""
    out = {}
    for n, e, k, block in CASES:
        ref, port, vals = random_ells(n + e, n, e, k)
        fvals = float_vals(e, n)
        jv, jf = jnp.asarray(vals), jnp.asarray(fvals)
        vmin = rops.vertex_min_plus(ref, jv)
        got = dict(
            fused=RK.fused_spmv_rows(ref.ell_src, ref.row2dst, jf,
                                     block=block),
            rowmin=RC.relax_rowmin(ref.ell_src, ref.ell_w, jv),
            rowsum=RC.spmv_rowsum(ref.ell_src, jf),
            rowargmin=RC.relax_rowargmin(
                ref.ell_src, ref.ell_w, jv,
                jnp.concatenate([vmin, jnp.full((1,), INF_W, vmin.dtype)])[
                    jnp.minimum(ref.row2dst, n)], n=n),
            vertex_min=vmin, vertex_arg=rops.vertex_argmin_src(ref, jv, vmin),
            vertex_sum=rops.vertex_spmv(ref, jf),
            fused_vertex=rops.vertex_spmv_fused(ref, jf, block=block))
        out[(n, e, k, block)] = (port, vals, fvals, jax.tree_util.tree_map(
            np.asarray, got))
    return out


@pytest.mark.parametrize("case", CASES)
def test_spmv_rows_plain_matches_pallas(spmv_refs, case):
    """row_sum to rtol 1e-6; the compacted rows and counts bit for bit."""
    port, _, fvals, want = spmv_refs[case]
    row_sum, rows, counts = TK.fused_spmv_rows(
        port.ell_src, port.row2dst, torch.from_numpy(fvals), block=case[3])
    assert row_sum.dtype == torch.float32
    np.testing.assert_allclose(row_sum.numpy(), want["fused"][0], rtol=1e-6,
                               atol=0)
    assert np.array_equal(rows.numpy(), want["fused"][1])
    assert np.array_equal(counts.numpy(), want["fused"][2])


@pytest.mark.parametrize("case", CASES)
def test_chained_plain_matches_pallas(spmv_refs, case):
    """relax_rowmin and relax_rowargmin bit for bit, spmv_rowsum to rtol
    1e-6, and the vertex ops over them."""
    port, vals, fvals, want = spmv_refs[case]
    n = case[0]
    v, fv = torch.from_numpy(vals), torch.from_numpy(fvals)
    assert np.array_equal(TC.relax_rowmin(port.ell_src, port.ell_w, v).numpy(),
                          want["rowmin"])
    vmin = tops.vertex_min_plus(port, v)
    assert np.array_equal(vmin.numpy(), want["vertex_min"])
    tgt = torch.cat([vmin, vmin.new_full((1,), INF_W)])[
        port.row2dst.clamp(max=n)]
    assert np.array_equal(TC.relax_rowargmin(port.ell_src, port.ell_w, v,
                                             tgt, n=n).numpy(),
                          want["rowargmin"])
    assert np.array_equal(tops.vertex_argmin_src(port, v, vmin).numpy(),
                          want["vertex_arg"])
    np.testing.assert_allclose(TC.spmv_rowsum(port.ell_src, fv).numpy(),
                               want["rowsum"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(tops.vertex_spmv(port, fv).numpy(),
                               want["vertex_sum"], rtol=1e-6, atol=0)
    vsum, hit = tops.vertex_spmv_fused(port, fv, block=case[3])
    np.testing.assert_allclose(vsum.numpy(), want["fused_vertex"][0],
                               rtol=1e-6, atol=0)
    assert np.array_equal(hit.numpy(), want["fused_vertex"][1])
    # fused and chained regimes: the same row sums, the same vertex sums
    assert torch.equal(vsum, tops.vertex_spmv(port, fv))


@pytest.mark.parametrize("seed", [0, 1])
def test_float_segment_sum_adds_in_lane_order(seed):
    """The float segment sum adds each segment's lanes in lane order from
    0.0 — the order of XLA's scatter on the CPU, so jax.ops.segment_sum
    agrees bit for bit; ids out of range are dropped; lanes already
    grouped by segment, summed with no sort over their offsets (as the
    ELL vertex combine does), give the same bits."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(3000)
         * 10.0 ** rng.integers(-3, 4, 3000)).astype(np.float32)
    s = rng.integers(-2, 62, 3000).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(s),
                                          num_segments=60))
    got = segment_sum(torch.from_numpy(v), torch.from_numpy(s), 60)
    assert np.array_equal(got.numpy(), want)
    order = np.argsort(s, kind="stable")
    offsets = np.searchsorted(s[order], np.arange(61)).astype(np.int32)
    grouped = TS.segment_sum_sorted(torch.from_numpy(v[order]), None,
                                    torch.from_numpy(offsets))
    assert torch.equal(grouped, got)


@pytest.mark.parametrize("case", CASES[:1])
def test_ell_offsets_bound_each_vertex_rows(case):
    """The pack's vertex row offsets: vertex v owns rows
    [offsets[v], offsets[v+1]), the unused rows come after offsets[n],
    and a restore from the saved state derives the same offsets."""
    n, e, k, _ = case
    _, port, _ = random_ells(n + e, n, e, k)
    off = port.offsets.long()
    assert port.offsets.dtype == torch.int32 and off.shape == (n + 1,)
    owner = torch.repeat_interleave(torch.arange(n), off[1:] - off[:-1])
    assert torch.equal(port.row2dst[:int(off[n])].long(), owner)
    assert bool((port.row2dst[int(off[n]):] == n).all())
    back = tell.ell_from_state(tell.ell_state(port), n, "cpu")
    assert "offsets" not in tell.ell_state(port)
    assert torch.equal(back.offsets, port.offsets)


def test_relax_compaction_invariants():
    """Frontier row ids packed to each block's prefix (sentinel R after
    the count), per-block counts, and every hit row listed once."""
    _, port, vals = random_ells(5, 64, 256, 8)
    block = 128
    rmin, _, rows, cnts = TK.fused_relax_rows(
        port.ell_src, port.ell_w, torch.from_numpy(vals), block=block)
    R = port.R
    hit_rows = np.nonzero(rmin.numpy() < INF_W)[0]
    rows, got = rows.numpy(), []
    for t in range(R // block):
        c = int(cnts[t])
        seg = rows[t * block:(t + 1) * block]
        assert (seg[:c] < R).all() and (seg[c:] == R).all(), t
        got.extend(seg[:c].tolist())
    assert sorted(got) == hit_rows.tolist()


def merge_inputs(seed, n=40, D=24, B=12):
    """A sorted diff pool (some rows dead, vacant rows last) and a sorted
    admitted batch (alive prefix, sentinel rows after), as numpy arrays;
    some batch keys tie with pool keys."""
    rng = np.random.default_rng(seed)
    pk = np.unique(rng.integers(0, n * n, int(rng.integers(1, D))))
    fk = np.unique(np.concatenate([rng.integers(0, n * n, B - 3),
                                   rng.choice(pk, 2)]))[:B - 1]

    def rows(keys, size, alive):
        used = np.arange(size) < len(keys)
        k = np.concatenate([keys, np.zeros(size - len(keys), np.int64)])
        return [np.where(used, k // n, n).astype(np.int32),
                np.where(used, k % n, 0).astype(np.int32),
                np.where(used, rng.integers(1, 50, size), 0).astype(np.int32),
                used & alive]

    return (rows(pk, D, rng.random(D) < 0.8)
            + rows(fk, B, np.ones(B, bool)))


@pytest.mark.parametrize("seed", range(6))
def test_merge_plain_matches_pallas(seed):
    """One merge-path search per slot; the pool wins ties."""
    arrays = merge_inputs(seed)
    n = 40
    want = RK.merge_pool_sorted(*[jnp.asarray(a) for a in arrays], n=n)
    got = TK.merge_pool_sorted(*[torch.from_numpy(a) for a in arrays], n=n)
    for g, w in zip(got, want):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype
        assert np.array_equal(g.numpy(), w)


# chip_smoke.MERGE_CASES small enough for interpret mode (D and B up to
# 5,000): ties whose rows differ, D at and around the kernel's tile of
# 2,048 slots, B above D, an empty pool, a batch before or after the whole
# pool, negative source ids
SMALL_MERGE = [i for i, (_, D, B, *_) in enumerate(chip_smoke.MERGE_CASES)
               if D <= 5000 and B <= 5000]


@pytest.mark.parametrize("i", SMALL_MERGE,
                         ids=[chip_smoke.MERGE_CASES[i][0]
                              for i in SMALL_MERGE])
def test_merge_plain_matches_pallas_on_merge_cases(i):
    """The inputs chip_smoke.check_merge holds the CUDA kernel to on the
    card, through the plain version and repro's Pallas merge."""
    _, D, B, pool_used, batch_used, ties, where = chip_smoke.MERGE_CASES[i]
    arrays = chip_smoke.merge_case(np, i, D, B, pool_used, batch_used, ties,
                                   where)
    n = chip_smoke.MERGE_N
    want = RK.merge_pool_sorted(*[jnp.asarray(a) for a in arrays], n=n)
    got = TK.merge_pool_sorted(*[torch.from_numpy(a) for a in arrays], n=n)
    for g, w in zip(got, want):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype
        assert np.array_equal(g.numpy(), w)


def test_merge_ties_go_to_the_pool():
    """Where a batch key equals a pool key, the pool's row comes first:
    its w and alive, then the batch's."""
    n = 10
    pool = [np.array(x, np.int32) for x in ([1, 2, 3, n], [5, 5, 5, 0],
                                            [11, 12, 13, 0])]
    pool.append(np.array([True, False, True, False]))
    fresh = [np.array(x, np.int32) for x in ([2, 3], [5, 5], [21, 22])]
    fresh.append(np.array([True, True]))
    got = TK.merge_pool_sorted(*[torch.from_numpy(a) for a in pool + fresh],
                               n=n)
    assert got[0].tolist() == [1, 2, 2, 3]
    assert got[2].tolist() == [11, 12, 21, 13]
    assert got[3].tolist() == [True, False, True, True]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_matches_scatter_path(seed):
    """update_csr_add with the merge plugged in == the scatter path,
    dedupe, revivals and overflow included (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    n = 40
    e = rng.integers(0, n, size=(120, 2))
    e = e[e[:, 0] != e[:, 1]]
    g = t_from_csr(t_build_csr(n, e, rng.integers(1, 50, len(e)),
                               device="cpu"), int(rng.integers(3, 24)))
    for step in range(4):
        B = int(rng.integers(2, 12))
        qs, qd = (torch.from_numpy(rng.integers(0, n, B).astype(np.int32))
                  for _ in range(2))
        qw = torch.from_numpy(rng.integers(1, 50, B).astype(np.int32))
        mask = torch.from_numpy(rng.random(B) < 0.9)
        g1 = td.update_csr_add(g, qs, qd, qw, mask)
        g2 = td.update_csr_add(g, qs, qd, qw, mask,
                               pool_merge=TK.merge_pool_sorted)
        for f in ("d_src", "d_dst", "d_w", "d_alive", "d_offsets", "w",
                  "alive", "overflow"):
            assert torch.equal(getattr(g1, f), getattr(g2, f)), (step, f)
        g = g1
        if step == 1:
            g = td.update_csr_del(g, qs[: B // 2], qd[: B // 2])


def test_repair_config_matches_heuristic():
    for n, e_cap, k in [(100, 700, 8), (4096, 30000, 8), (65536, 10**6, 8),
                        (300, 2000, 4), (4194304, 65894701, 8)]:
        want = RK._heuristic_config(n, e_cap, k)
        got = TK.repair_config(n, e_cap, k)
        assert got.row_block == want.row_block
        assert TK.repair_config(n, e_cap, k) is got


def test_repair_config_cached_per_shape():
    """tests/test_kernels.py's test on the port: the heuristic config
    cached per shape, then ``measure=True`` on the CPU (the plain version
    timed at each row block that divides R), cached apart from it."""
    TK.clear_tune_cache()
    c1 = TK.repair_config(64, 300, 8)
    assert TK.repair_config(64, 300, 8) is c1          # cache hit
    assert TK.repair_config(64, 600, 8) is not c1      # new shape, new cfg
    assert tell.ell_capacity(64, 300, 8) % c1.row_block == 0
    TK.clear_tune_cache()
    for n, e_cap in [(32, 64), (4096, 30000), (4096, 32000)]:
        R = tell.ell_capacity(n, e_cap, 8)
        cm = TK.repair_config(n, e_cap, 8, measure=True, device="cpu")
        assert cm.row_block in (128, 256, 512) and R % cm.row_block == 0
        assert set(TK.TUNE_TIMES[(n, e_cap, 8, "cpu")]) == {
            bt for bt in (512, 256, 128) if R % bt == 0}
        assert TK.repair_config(n, e_cap, 8, measure=True,
                                device="cpu") is cm
        assert TK.repair_config(n, e_cap, 8).row_block == \
            RK._heuristic_config(n, e_cap, 8).row_block
    TK.clear_tune_cache()
    assert not TK.TUNE_TIMES


def test_autotuned_cuda_engine_runs_sssp_as_the_default():
    """``CudaEngine(autotune=True)`` on the CPU: the measured row block,
    SSSP's dist and parent equal to the heuristic engine's."""
    import repro_torch
    from repro_torch.algos import sssp
    TK.clear_tune_cache()
    n, edges, w = repro_torch.rmat_graph(9, 8, seed=0)
    csr = t_build_csr(n, edges, w, device="cpu")
    stream = repro_torch.random_updates(csr, percent=5, seed=1)
    out = []
    for autotune in (False, True):
        sess = repro_torch.bind_graph(csr, backend="cuda", capacity=2048,
                                      device="cpu", autotune=autotune)
        props = sess.run_stream(stream, 256, sssp.stream_step,
                                sess.call(sssp.static_sssp, 0))
        out.append(props)
        assert sess.engine.autotune is autotune
    assert len(TK.TUNE_TIMES) == 1
    for k in ("dist", "parent"):
        assert torch.equal(out[0][k], out[1][k]), k
    TK.clear_tune_cache()


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    for mod in (TK, TC, TS):
        mod.reset_launches()
    _, port, vals = random_ells(1, 64, 256, 8)
    v, fv = torch.from_numpy(vals), torch.from_numpy(float_vals(1, 64))
    TK.fused_relax_rows(port.ell_src, port.ell_w, v)
    TK.fused_spmv_rows(port.ell_src, port.row2dst, fv)
    arrays = [torch.from_numpy(a) for a in merge_inputs(0)]
    TK.merge_pool_sorted(*arrays, n=40)
    TK.merge_pool_sorted_batched(*[a[None] for a in arrays], n=40)
    TC.relax_rowmin(port.ell_src, port.ell_w, v)
    TC.spmv_rowsum(port.ell_src, fv)
    TC.relax_rowargmin(port.ell_src, port.ell_w, v, port.row2dst, n=64)
    tops.vertex_spmv(port, fv)
    assert TK.LAUNCHES == {"fused_relax_rows": 0, "fused_spmv_rows": 0,
                           "merge_pool_sorted": 0,
                           "merge_pool_sorted_batched": 0}
    assert TC.LAUNCHES == {"relax_rowmin": 0, "spmv_rowsum": 0,
                           "relax_rowargmin": 0}
    assert TS.LAUNCHES == {"segment_sum_sorted": 0}


def test_build_flags_are_per_source(monkeypatch):
    """Each CUDA source is compiled with its own flags.  The graph kernels
    keep --fmad=false: their float sums equal their plain versions bit for
    bit only without fused multiply-adds.  A source's flags key its
    library, so changing them rebuilds it."""
    from repro_torch.kernels import _build
    assert {p.name for p in _build.sources()} == set(_build.SOURCE_FLAGS)
    for name in ("repair.cu", "csr_relax.cu", "segment.cu"):
        assert "--fmad=false" in _build.flags(_build.CSRC / name)
    assert "--fmad=false" not in _build.FLAGS
    for src in _build.sources():
        got = _build.flags(src)
        assert got[:len(_build.FLAGS)] == _build.FLAGS
        assert "arch=compute_90a,code=sm_90a" in got
    with pytest.raises(KeyError):
        _build.flags(_build.CSRC / "unlisted.cu")
    before = _build.library_paths()
    monkeypatch.setitem(_build.SOURCE_FLAGS, "flash_attention.cu",
                        ("--fmad=false",))
    assert _build.library_paths() != before
