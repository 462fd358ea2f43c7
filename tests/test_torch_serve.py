"""The port's serving pool on the CPU, held against ``repro``'s.

The same tenants and ΔG streams go through ``repro_torch.serve.SessionPool``
(on ``torch``, on ``cuda``, whose kernels run their plain versions
here, and on ``frontier``) and through ``repro.serve.SessionPool`` on ``jnp`` (the Pallas
pool in interpret mode is too slow for a test), in each batch mode: every
tenant's graph arrays bit for bit (the ``cuda`` pool's graph beside its
ELL pack or push pack), armed tenants' ``dist``, the ``stats()``
snapshot, and the dead-letter records under ``reject`` and ``shed``.  The
``cuda`` and ``frontier`` pools also equal solo sessions fed the same
batches, packs and all.  The batched merge's plain version is held against the solo one,
and that against ``repro``'s Pallas merge in interpret mode.  ``repro``'s
pools run on worker threads started at the module's first test."""
import concurrent.futures
import json
import tempfile

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro_torch import dsl_programs
from repro_torch.core import registry as t_registry
from repro_torch.graph.csr import rmat_graph
from repro_torch.graph.updates import UpdateStream, random_updates
from repro_torch.kernels import repair as TK
from repro_torch.runtime.errors import PoolSaturatedError
from repro_torch.serve import (BATCH_MODES, MegaBatcher, SessionPool,
                               next_pow2, tree_index, tree_stack)

TENANTS, ARMED, BS, TICKS = 6, 2, 8, 2
MODES = ("vmap", "scan", "off")
# frontier's update_stacked leaves the push pack's repack to the pool's
# one read, so it runs in every mode as the reference's does
POOL_BACKENDS = ("torch", "cuda", "frontier")


@pytest.fixture(autouse=True)
def _fresh_shared_engines():
    t_registry.clear_shared_engines()
    yield
    t_registry.clear_shared_engines()


def _edges():
    n, edges, w = rmat_graph(7, 8, seed=1)
    keep = edges[:, 0] != edges[:, 1]
    return n, edges[keep], w[keep]


def _streams():
    n, e, w = _edges()
    csr = repro_torch.build_csr(n, e, w, device="cpu")
    return [random_updates(csr, percent=30, seed=t) for t in range(TENANTS)]


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: _host(tree)}


# ---------------------------------------------------------------------------
# one pool run, on either package
# ---------------------------------------------------------------------------

def run_pool(port: bool, backend: str, mode: str):
    """A mixed pool: ``ARMED`` armed DynSSSP tenants, the rest structural,
    two of them with pools small enough to overflow inside a mega-call;
    ``max_resident`` forces evictions and restores."""
    n, e, w = _edges()
    streams = _streams()
    spill = tempfile.mkdtemp(prefix="pool-test-")
    if port:
        csr = repro_torch.build_csr(n, e, w, device="cpu")
        prog = repro_torch.compile(dsl_programs.path("sssp"))
        pool = SessionPool(prog, backend=backend, batch_mode=mode,
                           max_resident=4, spill_dir=spill, device="cpu")
        batch = lambda s, i: s.batch(i, BS, device="cpu")
    else:
        from repro.dsl_programs import path
        from repro.serve import SessionPool as RPool
        csr = repro.graph.build_csr(n, e, w)
        prog = repro.api.compile(path("sssp"))
        pool = RPool(prog, backend=backend, batch_mode=mode, max_resident=4,
                     spill_dir=spill)
        streams = [repro.graph.updates.UpdateStream(adds=s.adds, dels=s.dels)
                   for s in streams]
        batch = lambda s, i: s.batch(i, BS)
    for t in range(TENANTS):
        kw = {"capacity": 8} if t >= TENANTS - 2 else {}
        sess = pool.bind(f"t{t}", csr, **kw)
        if t < ARMED:
            sess.run("DynSSSP", batchSize=BS, src=0)
    for i in range(TICKS):
        pool.apply_many([(f"t{t}", batch(streams[t], i))
                         for t in range(TENANTS)])
    out = {"stats": pool.stats(), "tenants": {}}
    for t in range(TENANTS):
        sess = pool.session(f"t{t}")
        tree, _ = sess.engine.pack_state(sess.handle)
        rec = {"state": _flat(tree), "cursor": sess.stream_cursor}
        if t < ARMED:
            rec["dist"] = sess.props.host("dist")
        out["tenants"][t] = rec
    if port:
        out["solo_runs"] = list(pool.solo_runs)
    return out


def backpressure(port: bool):
    """reject and shed on a small pool: the typed error's detail and the
    shed records."""
    n, e, w = _edges()
    s = _streams()[0]
    if port:
        csr = repro_torch.build_csr(n, e, w, device="cpu")
        Pool, err = SessionPool, PoolSaturatedError
        batch = lambda i: s.batch(i, BS, device="cpu")
        kw = {"device": "cpu", "backend": "torch"}
    else:
        from repro.runtime import PoolSaturatedError as RErr
        from repro.serve import SessionPool as RPool
        csr = repro.graph.build_csr(n, e, w)
        Pool, err = RPool, RErr
        rs = repro.graph.updates.UpdateStream(adds=s.adds, dels=s.dels)
        batch = lambda i: rs.batch(i, BS)
        kw = {"backend": "jnp"}
    out = {}
    pool = Pool(max_pending=2, overload="reject", **kw)
    pool.bind("a", csr)
    pool.bind("b", csr)
    pool.submit("a", batch(0))
    pool.submit("b", batch(0))
    with pytest.raises(err) as ei:
        pool.submit("a", batch(1))
    out["reject"] = ei.value.describe()
    pool.drain()
    out["reject_stats"] = pool.stats()
    pool = Pool(max_pending=3, overload="shed", **kw)
    pool.bind("deep", csr)
    pool.bind("shallow", csr)
    pool.submit("deep", batch(0))
    pool.submit("deep", batch(1))
    pool.submit("shallow", batch(0))
    pool.submit("shallow", batch(1))
    out["shed"] = [r.as_dict() for r in pool.shed_records.records()]
    pool.drain()
    out["shed_stats"] = pool.stats()
    out["cursors"] = (pool.session("deep").stream_cursor,
                      pool.session("shallow").stream_cursor)
    return out


class _Results:
    """The reference runs' futures, read as one dict."""

    def __init__(self, futures):
        self.futures = futures

    def result(self):
        return {k: f.result() for k, f in self.futures.items()}


@pytest.fixture(scope="module", autouse=True)
def ref_runs():
    """repro's pools, one worker thread each (separate pools; repro's
    shared engines and compile caches are behind locks), started at the
    module's first test."""
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=len(MODES) + 1)
    futures = {mode: ex.submit(run_pool, False, "jnp", mode)
               for mode in MODES}
    futures["backpressure"] = ex.submit(backpressure, False)
    yield _Results(futures)
    ex.shutdown(wait=True)


@pytest.fixture(scope="module")
def port_runs():
    return {(b, m): run_pool(True, b, m)
            for b in POOL_BACKENDS for m in MODES}


@pytest.mark.parametrize("backend", POOL_BACKENDS)
def test_modes_agree_and_count(backend, port_runs):
    """Every mode leaves every tenant in the same state, and in the
    batched modes every solo run outside the armed tenants is named."""
    runs = {m: port_runs[(backend, m)] for m in MODES}
    for m in ("scan", "off"):
        for t in range(TENANTS):
            a, b = runs["vmap"]["tenants"][t], runs[m]["tenants"][t]
            for k in a["state"]:
                np.testing.assert_array_equal(a["state"][k], b["state"][k])
    for m in ("vmap", "scan"):
        st = runs[m]["stats"]
        assert st["mega_calls"] > 0
        solo = runs[m]["solo_runs"]
        assert st["sequential_fallbacks"] == ARMED * TICKS + len(solo)
        assert ("t5", "overflow") in solo
        assert {t for t, _ in solo} <= {"t4", "t5"}
    assert runs["off"]["stats"]["mega_calls"] == 0
    assert runs["off"]["solo_runs"] == []


def _pool_equals_solo(port_runs, backend):
    n, e, w = _edges()
    streams = _streams()
    csr = repro_torch.build_csr(n, e, w, device="cpu")
    prog = repro_torch.compile(dsl_programs.path("sssp"))
    got = port_runs[(backend, "vmap")]["tenants"]
    for t in range(TENANTS):
        cap = 8 if t >= TENANTS - 2 else "auto"
        if t < ARMED:
            solo = prog.bind(csr, backend=backend, capacity=cap,
                             device="cpu")
            solo.run("DynSSSP", batchSize=BS, src=0)
        else:
            solo = repro_torch.bind_graph(csr, backend=backend, capacity=cap,
                                          device="cpu")
        for i in range(TICKS):
            solo.apply(streams[t].batch(i, BS, device="cpu"))
        want = _flat(solo.engine.pack_state(solo.handle)[0])
        assert sorted(want) == sorted(got[t]["state"])
        for k in want:
            np.testing.assert_array_equal(got[t]["state"][k], want[k],
                                          err_msg=f"t{t}{k}")


def test_cuda_pool_equals_solo_sessions(port_runs):
    """The ``cuda`` pool against solo ``cuda`` sessions fed the same
    batches: graph and ELL pack, bit for bit."""
    _pool_equals_solo(port_runs, "cuda")


def test_frontier_pool_equals_solo_sessions(port_runs):
    """The ``frontier`` pool in ``vmap`` mode (its ``update_stacked`` /
    ``finish_stacked``) against solo ``frontier`` sessions: graph and push
    pack, bit for bit."""
    _pool_equals_solo(port_runs, "frontier")


# ---------------------------------------------------------------------------
# the mega-call's launch path on the CPU
# ---------------------------------------------------------------------------

def test_vmap_mode_takes_the_batched_merge_once_a_group(monkeypatch):
    """On ``cuda`` the vmapped body reaches the merge's custom op, whose
    vmap rule runs the batched merge once for the whole group (its real
    members: the port does not pad); ``scan`` runs the solo merge once a
    member."""
    calls = []
    plain = TK.merge_pool_sorted_batched_plain

    def counting(*args, **kw):
        calls.append(int(args[0].shape[0]))
        return plain(*args, **kw)

    monkeypatch.setattr(TK, "merge_pool_sorted_batched_plain", counting)
    n, e, w = _edges()
    csr = repro_torch.build_csr(n, e, w, device="cpu")
    streams = _streams()
    for mode, want in (("vmap", [5, 5]), ("scan", [])):
        pool = SessionPool(backend="cuda", batch_mode=mode, device="cpu")
        for t in range(5):                      # 5 tenants, S = 5
            pool.bind(f"t{t}", csr)
        for i in range(2):
            pool.apply_many([(f"t{t}", streams[t].batch(i, BS, device="cpu"))
                             for t in range(5)])
        assert calls == want, mode
        assert pool.health.mega_calls == 2 and pool.health.mega_sessions == 10
        calls.clear()
        t_registry.clear_shared_engines()


@pytest.mark.parametrize("mode", ("vmap", "scan"))
def test_megabatcher_patches_revivals_only_where_the_pool_stayed(
        mode, monkeypatch):
    """Three ``cuda`` members: fresh adds (the pool moves: repacked, no
    revival patch), re-adds of the edges the batch deletes (revivals) and
    deletes only.  Only the last two are patched, at once in ``vmap``,
    one by one in ``scan``; every member equals a solo apply."""
    from repro_torch.core import cuda_engine
    from repro_torch.serve.batch import _leaves
    calls = []
    revive = cuda_engine.ell_revive

    def counting(*a, **kw):
        calls.append(1)
        return revive(*a, **kw)

    monkeypatch.setattr(cuda_engine, "ell_revive", counting)
    n, e, w = _edges()
    csr = repro_torch.build_csr(n, e, w, device="cpu")
    eng = repro_torch.make_engine("cuda", device="cpu")
    hs = [eng.prepare(csr, 64) for _ in range(3)]
    old = e[:BS].astype(np.int32)
    streams = [_streams()[0],
               UpdateStream(adds=np.c_[old, np.full(BS, 7, np.int32)],
                            dels=old),
               UpdateStream(adds=np.zeros((0, 3), np.int32), dels=old)]
    bs = [s.batch(0, BS, device="cpu") for s in streams]
    new, counters = MegaBatcher(mode).run(eng, hs, bs)
    assert len(calls) == (1 if mode == "vmap" else 2)
    assert len(new) == 3 and counters.shape == (3, 3)
    for h, b, got in zip(hs, bs, new):
        want = eng.update_add(eng.update_del(h, b), b)
        for x, y in zip(_leaves(got), _leaves(want)):
            assert torch.equal(x, y)


def test_tree_stack_and_index_round_trip():
    n, e, w = _edges()
    csr = repro_torch.build_csr(n, e, w, device="cpu")
    eng = repro_torch.make_engine("cuda", device="cpu")
    h = eng.prepare(csr, 16)
    st = tree_stack([h, h])
    assert st.g.d_src.shape == (2, 16)
    back = tree_index(st, 1)
    assert torch.equal(back.ell.ell_src, h.ell.ell_src)
    assert back.g.n == h.g.n


# ---------------------------------------------------------------------------
# the batched merge's plain version
# ---------------------------------------------------------------------------

def _merge_inputs(seed, n=40, D=24, B=12):
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


@pytest.mark.parametrize("S", (1, 3, 8))
def test_batched_merge_plain_equals_solo_merges(S):
    sessions = [_merge_inputs(seed) for seed in range(S)]
    stacked = [torch.from_numpy(np.stack(col)) for col in zip(*sessions)]
    got = TK.merge_pool_sorted_batched(*stacked, n=40)
    assert all(g.shape == (S, 24) for g in got)
    for s, arrays in enumerate(sessions):
        want = TK.merge_pool_sorted_plain(
            *[torch.from_numpy(a) for a in arrays], 40)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g[s], w)


def test_batched_merge_sessions_match_repro_pallas():
    import jax.numpy as jnp
    from repro.kernels import pallas_repair as RK
    sessions = [_merge_inputs(seed) for seed in (11, 12, 13)]
    stacked = [torch.from_numpy(np.stack(col)) for col in zip(*sessions)]
    got = TK.merge_pool_sorted_batched(*stacked, n=40)
    for s, arrays in enumerate(sessions):
        want = RK.merge_pool_sorted(*[jnp.asarray(a) for a in arrays], n=40)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[s].numpy(), np.array(w))


def test_custom_op_vmap_rule_equals_solo_calls():
    sessions = [_merge_inputs(seed) for seed in range(4)]
    stacked = [torch.from_numpy(np.stack(col)) for col in zip(*sessions)]
    got = torch.func.vmap(
        lambda *a: TK.merge_pool_sorted_op(*a, n=40))(*stacked)
    for s, arrays in enumerate(sessions):
        want = TK.merge_pool_sorted_op(
            *[torch.from_numpy(a) for a in arrays], n=40)
        for g, w in zip(got, want):
            assert torch.equal(g[s], w)


# ---------------------------------------------------------------------------
# plumbing (copies of the reference's)
# ---------------------------------------------------------------------------

def test_next_pow2_buckets():
    from repro.serve import next_pow2 as r_next_pow2
    ks = (1, 2, 3, 4, 5, 8, 9)
    assert [next_pow2(k) for k in ks] == [1, 2, 4, 4, 8, 8, 16]
    assert [next_pow2(k) for k in ks] == [r_next_pow2(k) for k in ks]
    assert BATCH_MODES == ("vmap", "scan", "off")


def test_shared_engine_scoped_and_clearable():
    e1 = t_registry.shared_engine("torch", scope=(None, 48), device="cpu")
    e2 = t_registry.shared_engine("torch", scope=(None, 48), device="cpu")
    e3 = t_registry.shared_engine("torch", scope=(None, 32), device="cpu")
    assert e1 is e2 and e1 is not e3
    t_registry.clear_shared_engines()
    assert t_registry.shared_engine("torch", scope=(None, 48),
                                    device="cpu") is not e1


def test_mesh_token_keys_mesh_scoped_factories(monkeypatch):
    class Meshy:
        mesh_scoped = True

        def __new__(cls, **kw):
            return repro_torch.make_engine("torch", device="cpu")

    t_registry.register_engine("meshy", Meshy, overwrite=True)
    try:
        # without num_shards a mesh-scoped engine takes the default
        # process group's world size (1 without a group)
        assert t_registry._mesh_token("meshy", {}) == ("mesh", 1)
        monkeypatch.setattr(t_registry, "_world_size", lambda: 4)
        assert t_registry._mesh_token("meshy", {}) == ("mesh", 4)
        assert t_registry._mesh_token("meshy", {"num_shards": 2}) == \
            ("mesh", 2)
        assert t_registry._mesh_token("torch", {}) is None
        d1 = t_registry.shared_engine("meshy", scope=(None, 48))
        monkeypatch.setattr(t_registry, "_world_size", lambda: 8)
        assert t_registry.shared_engine("meshy", scope=(None, 48)) is not d1
    finally:
        t_registry.unregister_engine("meshy")


def test_pool_validates_knobs():
    with pytest.raises(ValueError):
        SessionPool(batch_mode="magic", device="cpu")
    with pytest.raises(ValueError):
        SessionPool(overload="panic", device="cpu")
    with pytest.raises(ValueError):
        SessionPool(max_pending=0, device="cpu")
    n, e, w = _edges()
    pool = SessionPool(backend="torch", device="cpu")
    pool.bind("a", repro_torch.build_csr(n, e, w, device="cpu"))
    with pytest.raises(ValueError):
        pool.bind("a", repro_torch.build_csr(n, e, w, device="cpu"))
    with pytest.raises(KeyError):
        pool.submit("ghost", None)


def test_pool_binds_on_its_device_and_shares_the_engine(tmp_path):
    n, e, w = _edges()
    csr = repro_torch.build_csr(n, e, w, device="cpu")
    pool = SessionPool(backend="cuda", spill_dir=str(tmp_path),
                       device="cpu")
    a, b = pool.bind("a", csr), pool.bind("b", csr)
    assert a.engine is b.engine and a.device.type == "cpu"
    pool.apply("a", _streams()[0].batch(0, BS, device="cpu"))
    pool.evict("a")
    revived = pool.session("a")
    assert revived.engine is pool.session("b").engine
    assert pool.health.restores == 1
    json.dumps(pool.stats())


def test_serve_graph_entry_point_on_the_cpu(capsys):
    from repro_torch.launch import serve
    args = serve.parser().parse_args(
        ["--graph", "--tenants", "3", "--ticks", "2", "--scale", "6",
         "--device", "cpu", "--batch-size", "8"])
    out = serve.serve(args)
    assert out["stats"]["applied"] == 6 and out["stats"]["mega_calls"] == 2
    printed = capsys.readouterr().out
    assert "tick p50" in printed and "us/session" in printed


# ---------------------------------------------------------------------------
# the pool against repro's, in every mode (last: repro's thread runs
# meanwhile)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", POOL_BACKENDS)
@pytest.mark.parametrize("mode", MODES)
def test_pool_matches_repro(backend, mode, port_runs, ref_runs):
    got, want = port_runs[(backend, mode)], ref_runs.result()[mode]
    assert got["stats"] == want["stats"]
    for t in range(TENANTS):
        g, r = got["tenants"][t], want["tenants"][t]
        assert g["cursor"] == r["cursor"]
        # the cuda pool packs {"g": DynGraph, "ell": ...}, the frontier
        # pool {"g": ..., "push": ...}; jnp the DynGraph
        state = g["state"]
        if backend != "torch":
            state = {k[len("/g"):]: v for k, v in state.items()
                     if k.startswith("/g/")}
        assert sorted(state) == sorted(r["state"])
        for k in state:
            np.testing.assert_array_equal(state[k], r["state"][k],
                                          err_msg=f"t{t}{k}")
        if t < ARMED:
            np.testing.assert_array_equal(g["dist"], r["dist"])


def test_backpressure_matches_repro(ref_runs):
    got, want = backpressure(True), ref_runs.result()["backpressure"]
    assert got == want
    assert got["reject"]["kind"] == "PoolSaturatedError"
    assert got["shed"][0]["reasons"][0]["kind"] == "pool_saturated"
    assert got["cursors"] == (1, 2)
