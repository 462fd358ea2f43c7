"""The port's distributed backends ``dist`` and ``dist_sharded`` on the CPU,
held against ``repro``'s.

* ``graph/partition.py`` and ``graph/halo.py`` against ``repro``'s copies
  (equal arrays).
* Hand-staged SSSP, PageRank and TC on ``dist`` and on ``dist_sharded``
  (block and degree partitioners), P shards stacked in one process, P in
  {1, 2, 4}, on conformance scenarios: SSSP ``dist``/``parent`` and TC
  counts bit for bit against ``repro``'s ``dist`` (one CPU device) and
  the port's ``torch``; PageRank to rtol 1e-5 of ``repro``'s ``dist`` and
  within the conformance tolerances of the oracle.
* At P = 1 every handle leaf equals ``repro``'s DistGraph; at P = 4 the
  per-shard DynGraphs, the halo tables and ``dist`` equal ``repro``'s run
  on four virtual devices (a subprocess, started at the module's first
  test).
* Two gloo ranks (``comm="group"``) equal the stacked P = 2 run bit for
  bit (a subprocess that spawns them).
* Halo-miss rebuilds and pool growth, checkpoints crossing between the
  packages and onto another shard count, the one host copy of
  ``pack_state``, the shard-count key of ``shared_engine``, and failover
  ``dist_sharded → dist → torch`` under a planted ``kernel_launch``
  fault.

``repro``'s P = 1 runs go through a thread pool started at the first
test that needs them."""
import concurrent.futures
import functools
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algos import oracles
from repro.algos import pagerank as r_pr
from repro.algos import sssp as r_sssp
from repro.algos import triangles as r_tc
from repro.graph import build_csr as r_build_csr
from repro_torch.algos import pagerank as t_pr
from repro_torch.algos import sssp as t_sssp
from repro_torch.algos import triangles as t_tc
from repro_torch.core import dist as t_dist
from repro_torch.core import registry as t_registry
from repro_torch.graph import halo as t_halo
from repro_torch.graph import partition as t_part
from repro_torch.runtime import faults as t_faults
from conformance import digraph_scenario, sym_scenario

ROOT = pathlib.Path(__file__).resolve().parents[1]
PR_KNOBS = (1e-4, 0.85, 100)
DYN = ("offsets", "src", "dst", "w", "alive", "d_offsets", "d_src", "d_dst",
       "d_w", "d_alive", "overflow")
HALO = ("row_starts", "ghosts", "send_idx", "recv_tgt", "hmiss", "miss_buf")
# (registry name, engine options)
BACKENDS = {"dist": ("dist", {}),
            "sharded_block": ("dist_sharded", {"partitioner": "block"}),
            "sharded_degree": ("dist_sharded", {"partitioner": "degree"})}
SHARDS = (1, 2, 4)
DI_SCENARIOS = ("batch8", "del_then_readd")
SYM_SCENARIOS = ("sym_batch16", "sym_del_readd")


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


# ---------------------------------------------------------------------------
# repro's runs: one CPU device in this process (P = 1), four in a
# subprocess
# ---------------------------------------------------------------------------

def ref_stream(algo, name):
    """repro's dist (P = 1): the static run then the fused stream; props
    and the handle's leaves as numpy."""
    sc = digraph_scenario(name)
    csr = r_build_csr(sc.n, sc.edges, sc.w)
    sess = repro.bind_graph(csr, backend="dist", capacity=sc.diff_capacity)
    if algo == "sssp":
        props = sess.call(r_sssp.static_sssp, sc.src)
        step = r_sssp.stream_step
    else:
        props = sess.call(r_pr.static_pr, *PR_KNOBS)
        step = r_pr.make_stream_step(*PR_KNOBS)
    props = sess.run_stream(sc.stream, sc.batch_size, step, props)
    n = sc.n
    out = {k: np.asarray(v)[:n] for k, v in props.items()}
    leaves = {f: np.asarray(getattr(sess.handle, f)) for f in DYN}
    return out, leaves


def ref_tc(name):
    """repro's dist (P = 1) counting the triangles of the scenario's
    final graph."""
    sc = sym_scenario(name)
    e2, w2 = oracles.edges_after_updates(sc.n, sc.edges, sc.w,
                                         sc.stream.adds, sc.stream.dels)
    sess = repro.bind_graph(r_build_csr(sc.n, e2, w2), backend="dist",
                            capacity=sc.diff_capacity)
    return int(sess.call(r_tc.static_tc))


FOUR_SHARD_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    assert len(jax.devices()) == 4, jax.devices()
    import repro
    from repro.algos import sssp
    from repro.graph import build_csr
    from conformance import digraph_scenario
    DYN = {dyn!r}
    HALO = {halo!r}
    out = {{}}
    sc = digraph_scenario("batch8")
    csr = build_csr(sc.n, sc.edges, sc.w)
    for be in ("dist", "dist_sharded"):
        sess = repro.bind_graph(csr, backend=be, capacity=sc.diff_capacity,
                                num_shards=4)
        fields = DYN + (HALO if be == "dist_sharded" else ())
        for f in fields:
            out[f"{{be}}/prep/{{f}}"] = np.asarray(getattr(sess.handle, f))
        props = sess.call(sssp.static_sssp, sc.src)
        props = sess.run_stream(sc.stream, sc.batch_size, sssp.stream_step,
                                props)
        for f in fields:
            out[f"{{be}}/end/{{f}}"] = np.asarray(getattr(sess.handle, f))
        for k in ("dist", "parent"):
            out[f"{{be}}/{{k}}"] = np.asarray(props[k])
    np.savez(sys.argv[1], **out)
""").format(dyn=DYN, halo=HALO)


class _Refs:
    def __init__(self, tmp):
        self.ex = concurrent.futures.ThreadPoolExecutor(max_workers=3)
        self.runs = {}
        for name in DI_SCENARIOS:
            for algo in ("sssp", "pagerank"):
                self.runs[(algo, name)] = self.ex.submit(ref_stream, algo,
                                                         name)
        for name in SYM_SCENARIOS:
            self.runs[("tc", name)] = self.ex.submit(ref_tc, name)
        self.npz = tmp / "four.npz"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), str(ROOT / "tests")]))
        script = tmp / "four.py"
        script.write_text(FOUR_SHARD_SCRIPT)
        self.proc = subprocess.Popen(
            [sys.executable, str(script), str(self.npz)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def get(self, key):
        return self.runs[key].result()

    def four(self):
        out, _ = self.proc.communicate(timeout=600)
        assert self.proc.returncode == 0, out.decode()[-4000:]
        return dict(np.load(self.npz))


@pytest.fixture(scope="module", autouse=True)
def refs(tmp_path_factory):
    r = _Refs(tmp_path_factory.mktemp("dist-refs"))
    yield r
    r.ex.shutdown(wait=True)
    if r.proc.poll() is None:
        r.proc.kill()
        r.proc.wait()


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------

def bind(csr, backend, P, capacity, **kw):
    name, opts = BACKENDS.get(backend, (backend, {}))
    if name != "torch":
        opts = dict(opts, num_shards=P)
    return repro_torch.bind_graph(csr, backend=name, capacity=capacity,
                                  device="cpu", **opts, **kw)


def port_stream(algo, name, backend, P=1):
    sc = digraph_scenario(name)
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    sess = bind(csr, backend, P, sc.diff_capacity)
    if algo == "sssp":
        props = sess.call(t_sssp.static_sssp, sc.src)
        step = t_sssp.stream_step
    else:
        props = sess.call(t_pr.static_pr, *PR_KNOBS)
        step = t_pr.make_stream_step(*PR_KNOBS)
    props = sess.run_stream(stream, sc.batch_size, step, props)
    return sess, {k: _host(v)[:sc.n] for k, v in props.items()}


@functools.lru_cache(maxsize=None)
def torch_run(algo, name):
    """The port's torch backend on a scenario, once per module."""
    if algo == "tc":
        return port_tc(name, "torch")
    return port_stream(algo, name, "torch")[1]


def port_tc(name, backend, P=1):
    sc = sym_scenario(name)
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    sess = bind(csr, backend, P, sc.diff_capacity)
    count = sess.call(t_tc.dyn_tc, stream, sc.batch_size)
    assert count.dtype == torch.int32 and count.shape == ()
    return int(count)


# ---------------------------------------------------------------------------
# partition.py and halo.py against repro's
# ---------------------------------------------------------------------------

def _skewed_src(n=97, seed=5):
    rng = np.random.default_rng(seed)
    deg = (rng.pareto(1.2, n) * 3).astype(np.int64)
    return np.repeat(np.arange(n), deg), rng


@pytest.mark.parametrize("P", (1, 2, 3, 4, 8))
@pytest.mark.parametrize("fn", ("block_partition", "degree_partition",
                                "make_partition"))
def test_partition_matches_repro(fn, P):
    from repro.graph import partition as r_part
    src, _ = _skewed_src()
    n = 97
    cases = {"block_partition": lambda m: [m.block_partition(n, P)],
             "degree_partition": lambda m: [m.degree_partition(n, P, src),
                                            m.degree_partition(n, P, src[:0])],
             "make_partition": lambda m: [m.make_partition(k, n, P, src)
                                          for k in m.PARTITIONERS]}[fn]
    assert t_part.PARTITIONERS == r_part.PARTITIONERS
    for got, want in zip(cases(t_part), cases(r_part)):
        assert (got.kind, got.n, got.P, got.block) == \
            (want.kind, want.n, want.P, want.block)
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.assign, want.assign)
        np.testing.assert_array_equal(got.owner_of(src), want.owner_of(src))
    with pytest.raises(ValueError):
        t_part.make_partition("magic", n, P)


@pytest.mark.parametrize("P", (1, 2, 4))
@pytest.mark.parametrize("fn", ("ghost_sets", "build_plan"))
def test_halo_matches_repro(fn, P):
    from repro.graph import halo as r_halo
    from repro.graph import partition as r_part
    src, rng = _skewed_src()
    n = 97
    dst = rng.integers(0, n, src.shape[0])
    for kind in r_part.PARTITIONERS:
        part = r_part.make_partition(kind, n, P, src)
        owner = part.owner_of(src)
        for hints in (None, np.array([3, 50, 96])):
            args = (src, dst, owner, part.block, P, hints)
            got, want = t_halo.ghost_sets(*args), r_halo.ghost_sets(*args)
            if fn == "ghost_sets":
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                continue
            a = t_halo.build_plan(got, P, part.block, part.block * P)
            b = r_halo.build_plan(want, P, part.block, part.block * P)
            for f in ("P", "block", "n_pad", "H", "Hs"):
                assert getattr(a, f) == getattr(b, f), f
            for f in ("ghosts", "counts", "send_idx", "recv_tgt"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# the algorithms, P shards stacked, against repro's dist and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DI_SCENARIOS)
@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_sssp_matches_repro(refs, backend, P, name):
    _, got = port_stream("sssp", name, backend, P)
    want, _ = refs.get(("sssp", name))
    for k in ("dist", "parent"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], torch_run("sssp", name)[k],
                                      err_msg=k)


@pytest.mark.parametrize("name", DI_SCENARIOS)
@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_pagerank_matches_repro(refs, backend, P, name):
    sc = digraph_scenario(name)
    _, got = port_stream("pagerank", name, backend, P)
    want, _ = refs.get(("pagerank", name))
    np.testing.assert_allclose(got["pr"], want["pr"], rtol=1e-5, atol=0)
    e2, w2 = oracles.edges_after_updates(sc.n, sc.edges, sc.w,
                                         sc.stream.adds, sc.stream.dels)
    oracle = oracles.pagerank_oracle(sc.n, e2, beta=PR_KNOBS[0],
                                     delta=PR_KNOBS[1], max_iter=PR_KNOBS[2])
    np.testing.assert_allclose(got["pr"], oracle, rtol=5e-2, atol=1e-4)


@pytest.mark.parametrize("name", SYM_SCENARIOS)
@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_tc_matches_repro(refs, backend, P, name):
    got = port_tc(name, backend, P)
    assert got == refs.get(("tc", name))
    assert got == torch_run("tc", name)


def test_one_shard_leaves_match_repro(refs):
    """P = 1: every leaf of the handle after the stream equals repro's
    DistGraph's; dist_sharded at P = 1 holds the same DynGraph."""
    want, leaves = refs.get(("sssp", "batch8"))
    sess, got = port_stream("sssp", "batch8", "dist", 1)
    for f in DYN:
        a = _host(getattr(sess.handle, f))
        assert a.dtype == leaves[f].dtype, f
        np.testing.assert_array_equal(a, leaves[f], err_msg=f)
    sh, _ = port_stream("sssp", "batch8", "sharded_block", 1)
    for f in DYN:
        np.testing.assert_array_equal(_host(getattr(sh.handle, f)),
                                      leaves[f], err_msg=f)


@pytest.mark.parametrize("backend", ("dist", "dist_sharded"))
def test_four_shards_match_repro_leaf_for_leaf(refs, backend):
    """P = 4: repro on four virtual CPU devices (subprocess) against the
    port's four stacked shards: the prepared and the final per-shard
    DynGraphs, the halo tables and miss channel, ``dist`` and ``parent``."""
    want = refs.four()
    sc = digraph_scenario("batch8")
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    sess = repro_torch.bind_graph(csr, backend=backend, num_shards=4,
                                  capacity=sc.diff_capacity, device="cpu")
    fields = DYN + (HALO if backend == "dist_sharded" else ())
    for f in fields:
        np.testing.assert_array_equal(_host(getattr(sess.handle, f)),
                                      want[f"{backend}/prep/{f}"],
                                      err_msg=f"prepared {f}")
    props = sess.call(t_sssp.static_sssp, sc.src)
    props = sess.run_stream(stream, sc.batch_size, t_sssp.stream_step, props)
    for f in fields:
        np.testing.assert_array_equal(_host(getattr(sess.handle, f)),
                                      want[f"{backend}/end/{f}"],
                                      err_msg=f"final {f}")
    for k in ("dist", "parent"):
        np.testing.assert_array_equal(_host(props[k]), want[f"{backend}/{k}"])


# ---------------------------------------------------------------------------
# one shard a rank: two gloo ranks against the stacked run
# ---------------------------------------------------------------------------

GLOO_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp
    import repro_torch
    from repro_torch.algos import pagerank, sssp

    def run(rank, data, store_path, out):
        store = dist.FileStore(store_path, 2)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=2)
        sc = dict(np.load(data))
        n, bs = int(sc["n"]), int(sc["batch_size"])
        csr = repro_torch.build_csr(n, sc["edges"], sc["w"], device="cpu")
        stream = repro_torch.UpdateStream(adds=sc["adds"], dels=sc["dels"])
        res = {}
        for be in ("dist", "dist_sharded"):
            for algo in ("sssp", "pagerank"):
                sess = repro_torch.bind_graph(
                    csr, backend=be, capacity=int(sc["capacity"]),
                    device="cpu")
                assert sess.engine.comm.kind == "group"
                assert sess.engine.P == 2 and sess.engine.L == 1
                if algo == "sssp":
                    p = sess.call(sssp.static_sssp, int(sc["src"]))
                    step = sssp.stream_step
                else:
                    p = sess.call(pagerank.static_pr, 1e-4, 0.85, 100)
                    step = pagerank.make_stream_step(1e-4, 0.85, 100)
                p = sess.run_stream(stream, bs, step, p)
                for k, v in p.items():
                    res[f"{be}/{algo}/{k}"] = v.numpy()[:n]
                tree, _ = sess.engine.pack_state(sess.handle)
                for k, v in tree.items():
                    res[f"{be}/{algo}/edges/{k}"] = v.numpy()
        np.savez(f"{out}.{rank}.npz", **res)
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=tuple(sys.argv[1:4]), nprocs=2)
""")


def test_gloo_ranks_equal_stacked(tmp_path):
    """Two gloo ranks, one shard each (``comm="group"``, the per-batch
    driver), against the stacked P = 2 run: SSSP and PageRank on both
    backends, bit for bit (a float sum over two shards does not depend on
    their order), and the packed edge lists."""
    sc = digraph_scenario("batch8")
    data = tmp_path / "scenario.npz"
    np.savez(data, n=sc.n, edges=sc.edges, w=sc.w, adds=sc.stream.adds,
             dels=sc.stream.dels, batch_size=sc.batch_size, src=sc.src,
             capacity=sc.diff_capacity)
    script = tmp_path / "gloo.py"
    script.write_text(GLOO_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "ranks"
    proc = subprocess.run([sys.executable, str(script), str(data),
                           str(tmp_path / "store"), str(out)], env=env,
                          capture_output=True, timeout=300)
    assert proc.returncode == 0, proc.stderr.decode()[-4000:]
    ranks = [dict(np.load(f"{out}.{r}.npz")) for r in (0, 1)]
    assert sorted(ranks[0]) == sorted(ranks[1])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    for backend, tag in (("dist", "dist"), ("sharded_block", "dist_sharded")):
        for algo in ("sssp", "pagerank"):
            sess, props = port_stream(algo, "batch8", backend, 2)
            assert sorted(f"{tag}/{algo}/{k}" for k in props) == sorted(
                k for k in ranks[0] if k.startswith(f"{tag}/{algo}/")
                and "/edges/" not in k)
            for k, v in props.items():
                np.testing.assert_array_equal(
                    v, ranks[0][f"{tag}/{algo}/{k}"],
                    err_msg=f"{tag} {algo} {k}")
            tree, _ = sess.engine.pack_state(sess.handle)
            for k, v in tree.items():
                np.testing.assert_array_equal(
                    v.numpy(), ranks[0][f"{tag}/{algo}/edges/{k}"])


def test_group_comm_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        repro_torch.make_engine("dist", comm="group", device="cpu")
    with pytest.raises(ValueError):
        repro_torch.make_engine("dist", comm="mesh", device="cpu")
    eng = repro_torch.make_engine("dist_sharded", num_shards=3, device="cpu")
    assert eng.comm.kind == "stacked" and eng.P == eng.L == 3


# ---------------------------------------------------------------------------
# halo misses, pool growth, compaction
# ---------------------------------------------------------------------------

def _csr_stream(n=48, deg=4, seed=3, percent=40, add_frac=0.6):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    keep = src != dst
    w = rng.integers(1, 40, keep.sum()).astype(np.int64)
    csr = repro_torch.build_csr(n, np.stack([src[keep], dst[keep]], 1), w,
                                device="cpu")
    return csr, repro_torch.random_updates(csr, percent=percent,
                                           seed=seed + 1, add_frac=add_frac)


@pytest.mark.parametrize("kind", ("block", "degree"))
def test_halo_miss_rebuild_and_pool_growth_replay(kind):
    """An add-heavy stream whose inserts fall outside the ghost tables
    (halo-miss → rollback → rebuild at the same capacity → replay) and a
    tiny pool (overflow → grow → replay): bit for bit the torch engine,
    fused and per batch; then the heavy-insertion state packs and
    restores onto another shard count edge for edge."""
    from repro_torch.core.engine import Engine
    csr, ups = _csr_stream(percent=50, add_frac=0.7)
    ref_eng = repro_torch.make_engine("torch", device="cpu")
    g0 = ref_eng.prepare(csr, diff_capacity=16)
    _, ref = t_sssp.dyn_sssp_stream(ref_eng, g0, 0, ups, batch_size=8,
                                    segment_size=3)
    for cap, driver in ((16, "fused"), (4, "fused"), (4, "per_batch")):
        eng = repro_torch.make_engine("dist_sharded", num_shards=2,
                                      partitioner=kind, device="cpu")
        g = eng.prepare(csr, diff_capacity=cap)
        props = t_sssp.static_sssp(eng, g, 0)
        if driver == "fused":
            g, props = eng.run_stream(g, ups, 8, t_sssp.stream_step, props,
                                      segment_size=3)
        else:
            g, props = Engine.run_stream(eng, g, ups, 8, t_sssp.stream_step,
                                         props)
        for k in ("dist", "parent"):
            torch.testing.assert_close(props[k][:csr.n], ref[k], rtol=0,
                                       atol=0)
        assert eng.rebuilds["halo"] >= 1, eng.rebuilds
        if cap == 4:
            assert eng.rebuilds["pool"] >= 1, eng.rebuilds
            assert int(g.d_src.shape[1]) > 4
    # heavy insertion, packed and restored onto one shard
    width = max(ups.num_adds, ups.num_dels, 1)
    b = ups.batch(0, width, device="cpu")
    eng = repro_torch.make_engine("dist_sharded", num_shards=2,
                                  partitioner=kind, device="cpu")
    sg = eng.update_add(eng.update_del(
        eng.prepare(csr, diff_capacity=2 * ups.num_adds + 8), b), b)
    tree1, meta1 = eng.pack_state(sg)
    assert meta1["kind"] == "dist" and meta1["partitioner"] == kind
    eng2 = repro_torch.make_engine("dist_sharded", num_shards=1,
                                   partitioner=kind, device="cpu")
    tree2, _ = eng2.pack_state(eng2.unpack_state(tree1, meta1))
    order = lambda t: np.stack([t[k].numpy() for k in ("src", "dst", "w")],
                               1)
    srt = lambda e: e[np.lexsort((e[:, 2], e[:, 1], e[:, 0]))]
    np.testing.assert_array_equal(srt(order(tree2)), srt(order(tree1)))


def test_per_shard_bytes_and_compaction():
    csr, ups = _csr_stream(n=256, deg=8)
    eng = repro_torch.make_engine("dist_sharded", num_shards=2, device="cpu")
    sg = eng.prepare(csr, diff_capacity=64)
    per = eng.per_shard_bytes(sg)
    whole = sum(int(np.prod(a.shape[1:])) * a.element_size()
                for a in (sg.src, sg.dst, sg.w, sg.alive))
    assert whole < per < 2 * whole + 4 * (csr.n + 1) * 2 + 4096
    b = ups.batch(0, 32, device="cpu")
    sg = eng.update_add(eng.update_del(sg, b), b)
    dead = repro_torch.UpdateStream(adds=np.zeros((0, 3), np.int32),
                                    dels=ups.adds[:32, :2])
    sg = eng.update_del(sg, dead.batch(0, 32, device="cpu"))
    of, used, dead_n = eng._counters(sg)
    assert of == 0 and used > 0 and dead_n > 0
    tree_before, _ = eng.pack_state(sg)
    sg2 = eng.compact_handle(sg)
    assert eng._counters(sg2)[2] == 0
    tree_after, _ = eng.pack_state(sg2)
    for k in ("src", "dst", "w"):
        np.testing.assert_array_equal(tree_after[k], tree_before[k])
    # the untouched leaves keep their tensors
    assert sg2.offsets is sg.offsets and sg2.ghosts is sg.ghosts


# ---------------------------------------------------------------------------
# durable state: one host copy, both packages, re-mesh
# ---------------------------------------------------------------------------

def test_pack_state_is_one_host_copy(monkeypatch):
    csr, ups = _csr_stream(seed=23)
    eng = repro_torch.make_engine("dist", num_shards=4, device="cpu")
    g = eng.prepare(csr, diff_capacity=64)
    b = ups.batch(0, max(ups.num_adds, ups.num_dels, 1), device="cpu")
    g = eng.update_add(eng.update_del(g, b), b)
    assert int(eng._counters(g)[1]) > 0          # a populated diff pool
    calls = []
    real = t_dist._host_fetch
    monkeypatch.setattr(t_dist, "_host_fetch",
                        lambda t: calls.append(1) or real(t))
    tree, meta = eng.pack_state(g)
    assert len(calls) == 1 and meta["num_shards"] == 4
    teng = repro_torch.make_engine("torch", device="cpu")
    tg = teng.update_add(teng.update_del(teng.prepare(csr, 64), b), b)
    es, ed, ew, ea = (x.numpy() for x in tg.edge_arrays())
    want = np.stack([es[ea], ed[ea], ew[ea]], 1)
    got = np.stack([tree[k].numpy() for k in ("src", "dst", "w")], 1)
    srt = lambda e: e[np.lexsort((e[:, 2], e[:, 1], e[:, 0]))]
    np.testing.assert_array_equal(srt(got), srt(want))


def _session_after(csr, stream, bs, k, backend, P):
    sess = bind(csr, backend, P, 64)
    props = sess.call(t_sssp.static_sssp, 0)
    for i in range(k):
        sess._handle, props = t_sssp.stream_step(
            sess.engine, sess.handle, stream.batch(i, bs, device="cpu"),
            props)
    sess._props = props
    return sess


def test_remesh_restore_continues_bit_for_bit(tmp_path):
    """A session saved on four stacked shards restores onto two (and onto
    torch) and runs on to the uninterrupted run's SSSP, bit for bit."""
    sc = digraph_scenario("batch8")
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    nb = stream.num_batches(sc.batch_size)
    full = _session_after(csr, stream, sc.batch_size, nb, "dist", 4)
    half = _session_after(csr, stream, sc.batch_size, nb // 2, "dist", 4)
    half.save(tmp_path / "ck")
    for backend, opts in (("dist", {"num_shards": 2}),
                          ("dist_sharded", {"num_shards": 3}),
                          ("torch", {})):
        res = repro_torch.restore_session(tmp_path / "ck", backend=backend,
                                          device="cpu", **opts)
        assert res.engine.n_pad == res.props["dist"].shape[0]
        props = dict(res.props)
        h = res.handle
        for i in range(nb // 2, nb):
            h, props = t_sssp.stream_step(
                res.engine, h, stream.batch(i, sc.batch_size, device="cpu"),
                props)
        for k in ("dist", "parent"):
            np.testing.assert_array_equal(_host(props[k])[:sc.n],
                                          _host(full.props[k])[:sc.n],
                                          err_msg=f"{backend} {k}")


@pytest.mark.parametrize("direction", ("port_to_repro", "repro_to_port"))
def test_dist_checkpoints_cross_packages(tmp_path, direction):
    """The shard-count-free "dist" checkpoint: the port's read by repro's
    restore_session, and repro's by the port's onto two shards; the edge
    set and the properties survive."""
    sc = digraph_scenario("batch8")
    if direction == "port_to_repro":
        csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
        stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                          dels=sc.stream.dels)
        sess = _session_after(csr, stream, sc.batch_size, 2, "dist", 2)
        sess.save(tmp_path / "ck")
        res = repro.restore_session(str(tmp_path / "ck"))
        tree_a, meta_a = sess.engine.pack_state(sess.handle)
        tree_b, meta_b = res.engine.pack_state(res.handle)
        props_a = {k: _host(v)[:sc.n] for k, v in sess.props.items()}
        props_b = res.props.to_host()
    else:
        csr = r_build_csr(sc.n, sc.edges, sc.w)
        sess = repro.bind_graph(csr, backend="dist",
                                capacity=sc.diff_capacity)
        props = sess.call(r_sssp.static_sssp, sc.src)
        # one batch through the fused stream (one compile, where eager
        # shard_map updates compile per call)
        sess._props = sess.run_stream(sc.stream.window(sc.batch_size, 0, 1),
                                      sc.batch_size, r_sssp.stream_step,
                                      props)
        sess.save(str(tmp_path / "ck"))
        res = repro_torch.restore_session(tmp_path / "ck", num_shards=2,
                                          device="cpu")
        assert res.engine.P == 2 and res.backend_name == "dist"
        tree_a, meta_a = sess.engine.pack_state(sess.handle)
        tree_b, meta_b = res.engine.pack_state(res.handle)
        props_a = sess.props.to_host()
        props_b = {k: _host(v)[:sc.n] for k, v in res.props.items()}
    assert meta_a["kind"] == meta_b["kind"] == "dist"
    assert meta_a["diff_capacity"] == meta_b["diff_capacity"]
    edges = lambda t: np.stack([np.asarray(_host(t[k]))
                                for k in ("src", "dst", "w")], 1)
    srt = lambda e: e[np.lexsort((e[:, 2], e[:, 1], e[:, 0]))]
    np.testing.assert_array_equal(srt(edges(tree_a)), srt(edges(tree_b)))
    assert sorted(props_a) == sorted(props_b)
    for k in props_a:
        np.testing.assert_array_equal(props_a[k], props_b[k], err_msg=k)


# ---------------------------------------------------------------------------
# registry: the shard-count key, the failover chain
# ---------------------------------------------------------------------------

def test_mesh_token_and_shared_engine_by_shard_count(monkeypatch):
    t_registry.clear_shared_engines()
    try:
        assert t_registry._mesh_token("dist", {}) == ("mesh", 1)
        monkeypatch.setattr(t_registry, "_world_size", lambda: 4)
        assert t_registry._mesh_token("dist", {}) == ("mesh", 4)
        assert t_registry._mesh_token("dist", {"num_shards": 2}) == \
            ("mesh", 2)
        assert t_registry._mesh_token("dist_sharded",
                                      {"num_shards": 2}) == ("mesh", 2)
        assert t_registry._mesh_token("torch", {}) is None
        d1 = t_registry.shared_engine("dist", scope=(None, 48),
                                      num_shards=2, device="cpu")
        assert t_registry.shared_engine("dist", scope=(None, 48),
                                        num_shards=2, device="cpu") is d1
        d4 = t_registry.shared_engine("dist", scope=(None, 48),
                                      num_shards=4, device="cpu")
        assert d4 is not d1 and (d1.P, d4.P) == (2, 4)
        assert {"dist", "dist_sharded"} <= set(
            repro_torch.available_backends())
        assert t_registry.failover_chain("dist_sharded") == ("dist", "torch")
        assert t_registry.failover_chain("dist") == ("torch",)
    finally:
        t_registry.clear_shared_engines()


def test_failover_dist_sharded_to_dist_to_torch():
    """A planted kernel_launch fault on dist_sharded moves the session to
    dist, one on dist too moves it to torch; the end state equals a torch
    session's."""
    sc = digraph_scenario("batch8")
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    ref = repro_torch.bind_graph(csr, backend="torch", device="cpu")
    ref_props = ref.run_stream(stream, sc.batch_size, t_sssp.stream_step,
                               ref.call(t_sssp.static_sssp, sc.src))
    hops = []
    for doomed in (("dist_sharded",), ("dist_sharded", "dist")):
        sess = repro_torch.bind_graph(csr, backend="dist_sharded",
                                      num_shards=2, failover=True,
                                      device="cpu")
        # the re-probe window pinned shut
        sess._failover.probe_base_s = 3600.0
        props = sess.call(t_sssp.static_sssp, sc.src)
        with t_faults.inject("kernel_launch", times=None,
                             match=lambda ctx: ctx.get("engine") in doomed):
            props = sess.run_stream(stream, sc.batch_size,
                                    t_sssp.stream_step, props)
        hops.append(sess.backend_name)
        assert sess.health.failovers == len(doomed)
        for k in ("dist", "parent"):
            np.testing.assert_array_equal(_host(props[k])[:sc.n],
                                          _host(ref_props[k])[:sc.n])
    assert hops == ["dist", "torch"]
