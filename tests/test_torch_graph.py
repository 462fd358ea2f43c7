"""Parity of repro_torch's graph layer against repro on the CPU.

Inputs come from numpy with fixed seeds and go through both packages;
every array here is an integer or bool array, so every comparison is
bit-exact."""
import ast
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.graph as rg
from repro.graph import diffcsr as rd
from repro.graph import updates as ru
from repro.kernels import ell as rell
import repro_torch
import repro_torch.graph as tg
from repro_torch.graph import diffcsr as td
from repro_torch.kernels import ell as tell
from conformance import digraph_scenario

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENARIOS = ["batch1", "batch8", "batch64", "self_loops"]
B = 12          # lanes per test batch: one compiled shape per graph

# the reference jitted, as its engines run it (eager JAX would re-trace
# every fori_loop on each call)
R_ADD = jax.jit(rd.update_csr_add)
R_DEL = jax.jit(rd.update_csr_del)
R_PACK = jax.jit(rell.pack_ell, static_argnames=("k",))
R_ELL_DEL = jax.jit(rell.ell_apply_del)
R_ELL_ADD = jax.jit(rell.ell_apply_add, static_argnames=("repack",))


def assert_same(ref, port, what=""):
    """Field-by-field bit equality of a repro dataclass and its port."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "n":
            assert a == b, what
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.dtype == b.dtype, (what, f.name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f.name)


def both_graphs(n, edges, w, cap):
    g_ref = rd.from_csr(rg.build_csr(n, edges, w), cap)
    g_port = td.from_csr(tg.build_csr(n, edges, w, device="cpu"), cap)
    return g_ref, g_port


def lanes(*arrays):
    """The same int32/bool lanes for both packages."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def padded(rng, n, rows, w=None):
    """``rows`` (k, 2) as a B-lane batch: (src, dst, w, mask)."""
    k = len(rows)
    src, dst = np.zeros((2, B), np.int32)
    src[:k], dst[:k] = rows[:, 0], rows[:, 1]
    ww = np.ones(B, np.int32)
    ww[:k] = rng.integers(1, 50, k) if w is None else w
    return src, dst, ww, np.arange(B) < k


def random_edges(rng, n, m):
    e = rng.integers(0, n, size=(m, 2))
    e = e[e[:, 0] != e[:, 1]]
    return e, rng.integers(1, 50, len(e)).astype(np.int32)


# ---------------------------------------------------------------------------
# CSR, generators and update streams
# ---------------------------------------------------------------------------

def test_generators_and_csr_match():
    for ref, port in [(rg.csr.rmat_graph(8, 4, seed=3),
                       tg.rmat_graph(8, 4, seed=3)),
                      (rg.csr.uniform_graph(50, 3, seed=1),
                       tg.uniform_graph(50, 3, seed=1)),
                      (rg.csr.grid_graph(6, seed=2),
                       tg.grid_graph(6, seed=2))]:
        assert ref[0] == port[0]
        assert np.array_equal(ref[1], port[1])
        assert np.array_equal(ref[2], port[2])
        assert_same(rg.build_csr(*ref), tg.build_csr(*port, device="cpu"))


@pytest.mark.parametrize("name", SCENARIOS)
def test_random_updates_match(name):
    """The searchsorted membership test draws the reference's stream."""
    sc = digraph_scenario(name)
    for percent, seed in [(12, 9), (40, 3)]:
        ref = ru.random_updates(rg.build_csr(sc.n, sc.edges, sc.w),
                                percent=percent, seed=seed)
        port = tg.random_updates(tg.build_csr(sc.n, sc.edges, sc.w,
                                              device="cpu"),
                                 percent=percent, seed=seed)
        assert np.array_equal(ref.adds, port.adds)
        assert np.array_equal(ref.dels, port.dels)
        for i in range(ref.num_batches(4)):
            assert_same(ref.batch(i, 4), port.batch(i, 4, device="cpu"))


def test_row_searchsorted_matches():
    rng = np.random.default_rng(0)
    vals = np.sort(rng.integers(0, 30, 40)).astype(np.int32)
    lo = rng.integers(0, 40, 64).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 12, 64), 40).astype(np.int32)
    q = rng.integers(0, 32, 64).astype(np.int32)
    (a, b, c, d), (e, f, g, h) = lanes(vals, lo, hi, q)
    assert np.array_equal(np.asarray(rg.csr.row_searchsorted(a, b, c, d)),
                          tg.row_searchsorted(e, f, g, h).numpy())


# ---------------------------------------------------------------------------
# DynGraph updates (after tests/test_kernels.py's merge-kernel sequence)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_dyngraph_random_add_del_sequence(seed):
    """Random add/del batches (duplicates, revivals, absent deletes and
    pool overflow included) leave every DynGraph field bit-identical."""
    rng = np.random.default_rng(seed)
    n = 40
    e, w = random_edges(rng, n, 120)
    g_ref, g_port = both_graphs(n, e, w, 12)
    for step in range(5):
        q = rng.integers(0, n, (B, 2)).astype(np.int32)
        src, dst, ww, mask = padded(rng, n, q)
        mask &= rng.random(B) < 0.9
        (a, b, c, d), (a2, b2, c2, d2) = lanes(src, dst, ww, mask)
        g_ref = R_ADD(g_ref, a, b, c, d)
        g_port = td.update_csr_add(g_port, a2, b2, c2, d2)
        assert_same(g_ref, g_port, f"add {step}")
        keep = np.arange(B) < B // 2
        (d,), (d2,) = lanes(mask & keep)
        g_ref = R_DEL(g_ref, a, b, d)
        g_port = td.update_csr_del(g_port, a2, b2, d2)
        assert_same(g_ref, g_port, f"del {step}")
        if step == 3:
            assert_same(rd.compact(g_ref), td.compact(g_port), "compact")
            assert np.array_equal(np.asarray(rd.pool_counters(g_ref)),
                                  td.pool_counters(g_port).numpy())
    assert int(g_port.overflow) > 0, "the sequence should overflow the pool"
    assert_same(rd.merge(g_ref, diff_capacity=64),
                td.merge(g_port, diff_capacity=64), "merge")
    (a, b), (a2, b2) = lanes(*rng.integers(0, n, (2, B)).astype(np.int32))
    assert np.array_equal(np.asarray(jax.jit(rd.is_edge)(g_ref, a, b)),
                          td.is_edge(g_port, a2, b2).numpy())
    assert np.array_equal(np.asarray(jax.jit(rd.edge_weight)(g_ref, a, b)),
                          td.edge_weight(g_port, a2, b2).numpy())


def test_duplicate_revive_keeps_last_lane():
    """A batch reviving one edge twice with different weights: the
    reference's CPU scatter keeps the LAST lane's weight (pinned here),
    in the main region, in the diff pool and in the ELL slot, and so does
    the port."""
    n = 8
    rng = np.random.default_rng(0)
    e = np.array([[0, 1], [1, 2], [2, 3]])
    w = np.array([10, 20, 30], np.int32)
    g_ref, g_port = both_graphs(n, e, w, 8)
    # put a fresh edge 4->5 in the diff pool
    (a, b, c, m), (a2, b2, c2, m2) = lanes(
        *padded(rng, n, np.array([[4, 5]]), w=[7]))
    g_ref, g_port = R_ADD(g_ref, a, b, c, m), td.update_csr_add(
        g_port, a2, b2, c2, m2)
    ell_ref, ell_port = R_PACK(g_ref, k=8), tell.pack_ell(g_port, k=8)
    # tombstone 0->1 and 4->5
    (a, b, c, m), (a2, b2, c2, m2) = lanes(
        *padded(rng, n, np.array([[0, 1], [4, 5]])))
    ell_ref = R_ELL_DEL(ell_ref, g_ref, a, b, m)
    ell_port = tell.ell_apply_del(ell_port, g_port, a2, b2, m2)
    g_ref, g_port = R_DEL(g_ref, a, b, m), td.update_csr_del(
        g_port, a2, b2, m2)
    # revive each twice in one batch: weights 5 then 9, 6 then 3
    (a, b, c, m), (a2, b2, c2, m2) = lanes(*padded(
        rng, n, np.array([[0, 1], [4, 5], [0, 1], [4, 5]]), w=[5, 6, 9, 3]))
    g1_ref = R_ADD(g_ref, a, b, c, m)
    g1_port = td.update_csr_add(g_port, a2, b2, c2, m2)
    assert np.asarray(g1_ref.w)[0] == 9
    assert np.asarray(g1_ref.d_w)[0] == 3
    assert_same(g1_ref, g1_port)
    ell_ref = R_ELL_ADD(ell_ref, g_ref, g1_ref, a, b, c, m, a,
                        repack=R_PACK)
    ell_port = tell.ell_apply_add(ell_port, g_port, g1_port, a2, b2, c2, m2,
                                  slot_value=a2, repack=tell.pack_ell)
    assert_same(ell_ref, ell_port)
    assert 9 in ell_port.ell_w.reshape(-1).tolist()


@pytest.mark.parametrize("seed", range(4))
def test_set_drop_matches_jax_scatter_drop(seed):
    """``tensors.set_drop`` against JAX's ``.at[idx].set(mode="drop")`` on
    the CPU (the reference's scatter: the last of duplicate lanes wins,
    indices outside [-L, L) drop): many duplicates, tensor and scalar
    values, and mapped by ``torch.func.vmap`` over batched lanes into a
    fresh buffer, as the serving pool's mega-call runs it."""
    from repro_torch.tensors import set_drop
    rng = np.random.default_rng(seed)
    S, L, W = 3, int(rng.integers(1, 40)), int(rng.integers(1, 90))
    buf = rng.integers(0, 9, (S, L)).astype(np.int32)
    idx = rng.integers(-2 * L, 2 * L, (S, W)).astype(np.int32)
    vals = rng.integers(0, 1000, (S, W)).astype(np.int32)
    want = [np.asarray(jnp.asarray(buf[s]).at[idx[s]].set(vals[s],
                                                         mode="drop"))
            for s in range(S)]
    for s in range(S):
        got = set_drop(torch.from_numpy(buf[s]), torch.from_numpy(idx[s]),
                       torch.from_numpy(vals[s]), last_wins=True)
        assert np.array_equal(got.numpy(), want[s])
        got = set_drop(torch.from_numpy(buf[s]), torch.from_numpy(idx[s]), 7)
        assert np.array_equal(got.numpy(), np.asarray(
            jnp.asarray(buf[s]).at[idx[s]].set(7, mode="drop")))
    mapped = torch.func.vmap(lambda i, v: set_drop(
        torch.zeros((L,), dtype=torch.int32), i, v, last_wins=True))(
        torch.from_numpy(idx), torch.from_numpy(vals))
    for s in range(S):
        assert np.array_equal(mapped[s].numpy(), np.asarray(
            jnp.zeros((L,), jnp.int32).at[idx[s]].set(vals[s], mode="drop")))


# ---------------------------------------------------------------------------
# ELL pack and in-place patches, slot for slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 8])
def test_pack_and_patches_slot_exact(k):
    """pack_ell, tombstone and revive patches and structural repacks,
    lane2slot included, slot for slot."""
    rng = np.random.default_rng(11 + k)
    n = 50
    e, w = random_edges(rng, n, 200)
    g_ref, g_port = both_graphs(n, e, w, 32)
    repack_ref = functools.partial(rell.pack_ell, k=k)
    repack_port = functools.partial(tell.pack_ell, k=k)
    ell_ref, ell_port = R_PACK(g_ref, k=k), repack_port(g_port)
    assert_same(ell_ref, ell_port, "pack")
    for step in range(4):
        # deletes of existing edges, then adds: revivals of half of them
        # plus fresh edges on odd steps (a structural repack)
        rows = e[rng.integers(0, len(e), B)]
        (a, b, c, m), (a2, b2, c2, m2) = lanes(*padded(rng, n, rows))
        ell_ref = R_ELL_DEL(ell_ref, g_ref, a, b, m)
        ell_port = tell.ell_apply_del(ell_port, g_port, a2, b2, m2)
        g_ref = R_DEL(g_ref, a, b, m)
        g_port = td.update_csr_del(g_port, a2, b2, m2)
        assert_same(ell_ref, ell_port, f"tombstone {step}")
        adds = rows[: B // 2]
        if step % 2:
            adds = np.concatenate([adds, rng.integers(0, n, (3, 2))])
        (a, b, c, m), (a2, b2, c2, m2) = lanes(*padded(rng, n, adds))
        g1_ref = R_ADD(g_ref, a, b, c, m)
        g1_port = td.update_csr_add(g_port, a2, b2, c2, m2)
        ell_ref = R_ELL_ADD(ell_ref, g_ref, g1_ref, a, b, c, m, a,
                            repack=repack_ref)
        ell_port = tell.ell_apply_add(ell_port, g_port, g1_port, a2, b2, c2,
                                      m2, slot_value=a2, repack=repack_port)
        g_ref, g_port = g1_ref, g1_port
        assert_same(ell_ref, ell_port, f"add {step}")
    assert_same(R_PACK(g_ref, k=k), repack_port(g_port), "repack")


# ---------------------------------------------------------------------------
# Package rules: no JAX, no repro; no silent CPU
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    """Import every repro_torch module and chip_smoke.py in a fresh
    interpreter, and compile a DSL program there; neither jax nor repro
    may load.  Also scan their import statements."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import repro_torch.core.dsl, repro_torch.dsl_programs\n"
        "import repro_torch.ckpt.checkpoint, repro_torch.algos.triangles\n"
        "prog = repro_torch.compile(repro_torch.dsl_programs.path('tc'))\n"
        "assert prog.functions[-1] == 'DynTC', prog.functions\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(sum(m.startswith('repro_torch') for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path, name)


def test_entry_points_refuse_cpu_without_asking(monkeypatch):
    """With no CUDA device and no device='cpu', entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csr = repro_torch.build_csr(4, np.array([[0, 1]]), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.bind_graph(csr, backend="torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.bind_graph(csr)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.build_csr(4, np.array([[0, 1]]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.UpdateStream(adds=np.zeros((1, 3), np.int32),
                                 dels=np.zeros((0, 2), np.int32)).batch(0, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.make_engine("cuda")
    # failover never trades the card for the CPU: a missing card is no
    # backend fault
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.bind_graph(csr, failover=True)
    assert repro_torch.bind_graph(csr, device="cpu",
                                  failover=True).backend_name == "cuda"
    assert repro_torch.bind_graph(csr, device="cpu").device.type == "cpu"
