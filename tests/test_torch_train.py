"""The port's training path (``repro_torch.data``, ``repro_torch.optim``,
``Model.train_step``, ``launch/train.py``) against repro's on the CPU,
float32, reduced configs, inputs made with numpy from a seed.

* the data pipeline: batches bit-identical to repro's;
* AdamW and Adafactor: 3 updates from the same params, gradients and
  state within rtol 1e-6 (params, state, grad norm; plus 4 ulps of each
  array's largest magnitude where an update cancels), with stacked leaves
  of (2, 128, 256) so that Adafactor's factored branch and its RMS over a
  whole stacked leaf are exercised (the reduced configs' width of 64
  never factors);
* ``_ce_loss`` at one chunk (S 96) and two (S 1,024), rtol 1e-6;
* gradients of every parameter against ``jax.value_and_grad`` of the
  reference's loss (the body of its ``_train_step``), within 1e-4 of each
  leaf's largest magnitude, on both port backends (``cuda`` on the CPU:
  the ``FlashAttention`` Function over the plain forward and backward),
  then 3 ``train_step``s, each from the reference's params and optimizer
  state before it, with loss and grad norm within rtol 1e-4 (the
  parameters are held through the gradients and the optimizer tests:
  Adam's first step turns a sign flip of a near-zero gradient into a
  2 * lr difference, and Adafactor's into 2 * lr on every unfactored
  weight, so runs left to themselves drift apart);
* ``launch/train.py``: resume from a mid-run checkpoint bit-identical to
  an uninterrupted run, the elastic restart, and a repro float32 run's
  checkpoint resumed in the port.

One JAX jit per arch (its train step, returning the gradients too),
reused across the steps and both backends.
"""
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.archs import get_arch as r_get_arch
from repro.configs.reduced import reduced as r_reduced
from repro.data import pipeline as RP
from repro.models import transformer as RT
from repro.models.model import Model as RModel
from repro.models.tuning import use_tuning
from repro.optim import opt as RO
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.configs.archs import get_arch
from repro_torch.configs.reduced import reduced
from repro_torch.data import pipeline as TP
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.models.model import (Model, opt_state_from_jax,
                                      opt_state_to_jax, params_from_jax,
                                      params_to_jax)
from repro_torch.optim import opt as TO

B, S = 2, 32
ARCHS = ["starcoder2-7b", "gemma2-9b", "whisper-large-v3",
         "jamba-v0.1-52b", "xlstm-125m"]
_REF = {}


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,hosts,host", [
    (0, 0, 1, 0), (1, 5, 1, 0), (1, 5, 2, 1), (7, 123, 4, 3)])
def test_synthetic_batches_match_reference(seed, step, hosts, host):
    kw = dict(vocab=300, seq_len=24, global_batch=8, seed=seed,
              n_hosts=hosts, host_id=host)
    want = RP.SyntheticSource(RP.DataConfig(**kw)).batch(step)
    got = TP.SyntheticSource(TP.DataConfig(**kw)).batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_corpus_batches_and_iterate_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, rows in enumerate((5, 9)):
        paths.append(tmp_path / f"shard{i}.npy")
        np.save(paths[-1], rng.integers(0, 100, (rows, 20)))
    kw = dict(vocab=100, seq_len=16, global_batch=4, n_hosts=2, host_id=1)
    rs = RP.CorpusSource(RP.DataConfig(**kw), paths)
    ts = TP.CorpusSource(TP.DataConfig(**kw), paths)
    for step in range(4):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(ts.batch(step)[k],
                                          rs.batch(step)[k])
    it = TP.iterate(ts, start_step=2)
    for want_step in (2, 3, 4):
        step, batch = next(it)
        assert step == want_step
        np.testing.assert_array_equal(batch["tokens"],
                                      rs.batch(step)["tokens"])
    it.close()


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

def opt_tree(rng):
    """A params tree with stacked leaves (the reference's units) that
    factor (trailing (128, 256) and (130, 128)) and that do not, and
    unstacked ones."""
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"emb": f(40, 48), "norm": f(48),
            "units": ({"ffn": {"x": f(2, 130, 128)},
                       "mixer": {"b": f(2, 64), "w": f(2, 128, 256)}},)}


def port_leaves(tree):
    """The tree's leaves as the port holds them (one tensor a layer)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    leaves = []
    for path, arr in flat:
        stacked = getattr(path[0], "key", None) == "units"
        ts = [torch.nn.Parameter(torch.from_numpy(a.copy()))
              for a in (arr if stacked else [arr])]
        leaves.append(TT.Leaf(tuple(str(p) for p in path), ts, stacked))
    return leaves


def close(got, want, rtol):
    """Elementwise within ``rtol``, and 4 float32 ulps of the array's
    largest magnitude where an update cancels (a weight near 0 minus a
    step of lr is rounded at lr's scale, not its own)."""
    want = np.asarray(want)
    atol = 4 * float(np.spacing(np.float32(np.abs(want).max())))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(11)
    params = opt_tree(rng)
    ropt, topt = RO.make_optimizer(name), TO.make_optimizer(name)
    rparams = jax.tree_util.tree_map(jnp.asarray, params)
    rstate = ropt.init(rparams)
    leaves = port_leaves(params)
    tstate = topt.init(leaves)
    rflat = lambda t: jax.tree_util.tree_leaves(t)
    for step, gscale in enumerate((1.0, 1e-3, 3.0)):   # clipped or not
        grads = jax.tree_util.tree_map(
            lambda a: (gscale * rng.standard_normal(a.shape)).astype(
                np.float32), params)
        rparams, rstate, rnorm = ropt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), rparams, rstate,
            jnp.asarray(step, jnp.int32))
        for leaf, g in zip(leaves, jax.tree_util.tree_leaves(grads)):
            for r, p in enumerate(leaf.tensors):
                p.grad = torch.from_numpy((g[r] if leaf.stacked else g)
                                          .copy())
        tstate, tnorm = topt.update(leaves, tstate, step)
        close(tnorm, rnorm, 1e-6)
        for leaf, want in zip(leaves, rflat(rparams)):
            assert all(p.grad is None for p in leaf.tensors)
            got = torch.stack(leaf.tensors) if leaf.stacked else \
                leaf.tensors[0]
            close(got.detach(), want, 1e-6)
        # the state, stacked back into the reference's layout
        if name == "adamw":
            for k in ("m", "v"):
                for leaf, ts, want in zip(leaves, tstate[k],
                                          rflat(rstate[k])):
                    close(torch.stack(ts) if leaf.stacked else ts[0], want,
                          1e-6)
        else:
            for leaf, ss, want in zip(leaves, tstate,
                                      jax.tree_util.tree_leaves(
                                          rstate, is_leaf=lambda x:
                                          isinstance(x, dict) and
                                          ("v" in x or "r" in x))):
                assert sorted(ss[0]) == sorted(want)
                for k in want:
                    got = [s[k] for s in ss]
                    close(torch.stack(got) if leaf.stacked else got[0],
                          want[k], 1e-6)
    if name == "adafactor":      # the factored branch ran
        assert sum("r" in ss[0] for ss in tstate) == 2


# ---------------------------------------------------------------------------
# the loss and the gradients, against the reference's
# ---------------------------------------------------------------------------

def batch_for(cfg, step, seq=S):
    data = RP.SyntheticSource(RP.DataConfig(vocab=cfg.vocab, seq_len=seq,
                                            global_batch=B, seed=3))
    batch = dict(data.batch(step))
    T = {"vlm": cfg.n_img_tokens, "audio": cfg.enc_seq}.get(cfg.family)
    if T is not None:
        batch["src"] = np.random.default_rng(step).standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
    return batch


def ref_step(model):
    """jit of repro's ``_train_step`` that also returns the gradients:
    (loss, grads, params, state, grad norm)."""
    cfg = model.cfg

    def loss_fn(p, batch):
        with use_tuning(model.tuning):
            x = model._embed(p, batch["tokens"])
            aux = model._aux(batch)
            if cfg.enc_layers:
                aux = {"src": RT.encoder_pass(cfg, p, aux["src"],
                                              model.policy.shard)}
            h, _ = RT.backbone_full(cfg, p, x, model.policy.shard, aux,
                                    collect_cache=False, use_remat=True)
            return model._ce_loss(p, h, batch["labels"])

    def step(params, state, step, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        params, state, gnorm = model.optimizer.update(grads, params, state,
                                                      step)
        return loss, grads, params, state, gnorm

    return jax.jit(step)


def reference(arch):
    """repro's float32 params, step-0 gradients, and for 3 steps the
    params and optimizer state before the step, its loss and grad norm
    (numpy)."""
    if arch not in _REF:
        cfg = r_reduced(r_get_arch(arch))
        model = RModel(cfg=cfg, dtype=jnp.float32)
        params = model.init(jax.random.PRNGKey(4))
        state = model.init_opt(params)
        run = ref_step(model)
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        steps = []
        for step in range(3):
            batch = {k: jnp.asarray(v)
                     for k, v in batch_for(cfg, step).items()}
            before = (host(params), host(state))
            loss, grads, params, state, gnorm = run(
                params, state, jnp.asarray(step, jnp.int32), batch)
            if step == 0:
                grads0 = host(grads)
            steps.append((*before, float(loss), float(gnorm)))
        _REF[arch] = (steps[0][0], grads0, steps)
    return _REF[arch]


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_and_steps_match_reference(arch, backend):
    tree, grads0, steps = reference(arch)
    cfg = reduced(get_arch(arch))
    model = params_from_jax(cfg, tree, device="cpu", backend=backend)
    assert model.optimizer is not None and model.dtype == torch.float32
    batch = {k: torch.from_numpy(v) for k, v in batch_for(cfg, 0).items()}
    loss = model.loss_and_grad(batch)
    np.testing.assert_allclose(float(loss), steps[0][2], rtol=1e-5)
    for leaf in model.leaves():
        want = np.asarray(at(grads0, leaf.path))
        gs = [p.grad for p in leaf.tensors]
        assert all(g is not None for g in gs), leaf.path
        got = (torch.stack(gs) if leaf.stacked else gs[0]).numpy()
        assert got.shape == want.shape, leaf.path
        top = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-4 * top, leaf.path
    # three steps, each from the reference's params and optimizer state
    # before it (carried across by params_from_jax / opt_state_from_jax):
    # run on, the two would drift apart by the sign flips that Adam's and
    # Adafactor's first steps make of near-zero gradients
    for step, (params, rstate, want_loss, want_norm) in enumerate(steps):
        model = params_from_jax(cfg, params, device="cpu", backend=backend)
        state = opt_state_from_jax(model, rstate)
        batch = {k: torch.from_numpy(v)
                 for k, v in batch_for(cfg, step).items()}
        state, metrics = model.train_step(state, step, batch)
        np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch,seq", [("starcoder2-7b", 96),
                                      ("starcoder2-7b", 1024),
                                      ("gemma2-9b", 1024)])
def test_ce_loss_matches_reference(arch, seq):
    """One chunk (S 96) and two of 512 (S 1,024); gemma2's final
    softcap."""
    tree = reference(arch)[0] if arch in _REF else None
    cfg = r_reduced(r_get_arch(arch))
    rmodel = RModel(cfg=cfg, dtype=jnp.float32)
    if tree is None:
        tree = jax.tree_util.tree_map(np.asarray,
                                      rmodel.init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(seq)
    h = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    want = rmodel._ce_loss(jax.tree_util.tree_map(jnp.asarray, tree),
                           jnp.asarray(h), jnp.asarray(labels))
    model = params_from_jax(reduced(get_arch(arch)), tree, device="cpu")
    got = model._ce_loss(torch.from_numpy(h), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)


def tensors(tree) -> list:
    return jax.tree_util.tree_leaves(tree, is_leaf=torch.is_tensor)


def test_state_trees_round_trip():
    """params_to_jax / opt_state_to_jax give the reference's trees (its
    leaf count and shapes) and opt_state_from_jax takes the state back
    unchanged, for AdamW (starcoder2) and Adafactor (jamba)."""
    for arch in ("starcoder2-7b", "jamba-v0.1-52b"):
        model = Model(reduced(get_arch(arch)), dtype=torch.float32,
                      device="cpu")
        model.init(torch.Generator().manual_seed(0))
        state = model.init_opt()
        for i, x in enumerate(tensors(state)):    # a value for each tensor
            x.add_(i + 1.0)
        rm = RModel(cfg=r_reduced(r_get_arch(arch)), dtype=jnp.float32)
        rp = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
        rs = jax.eval_shape(rm.init_opt, rp)
        for mine, ref in ((params_to_jax(model), rp),
                          (opt_state_to_jax(model, state), rs)):
            assert [tuple(x.shape) for x in tensors(mine)] == \
                [x.shape for x in jax.tree_util.tree_leaves(ref)]
        back = tensors(opt_state_from_jax(model,
                                          opt_state_to_jax(model, state)))
        assert len(back) == len(tensors(state))
        for x, y in zip(back, tensors(state)):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def run(*argv):
    return ttrain.train(ttrain.parser().parse_args(list(argv)))


def same_params(a, b):
    assert len(tensors(a)) == len(tensors(b))
    for x, y in zip(tensors(a), tensors(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch,dtype", [("xlstm-125m", ["--f32"]),
                                        ("starcoder2-7b", [])])
def test_train_resume_and_elastic_restart(tmp_path, arch, dtype):
    """As tests/test_runtime.py holds repro: a run resumed from its step-3
    checkpoint ends with parameters bit-identical to an uninterrupted run
    (bf16 ones through the checkpoint's raw bits), and an injected failure
    at step 3 restarts from the latest checkpoint and finishes."""
    from repro_torch.launch.elastic import run_elastic
    common = ["--arch", arch, "--reduced", "--steps", "6", "--batch", "4",
              "--seq", "32", "--log-every", "100", "--device", "cpu",
              "--backend", "cuda", *dtype]
    full = run(*common, "--ckpt", str(tmp_path / "a"), "--ckpt-every", "3")
    run(*common, "--ckpt", str(tmp_path / "b"), "--ckpt-every", "3")
    shutil.rmtree(tmp_path / "b" / "step_00000006")
    resumed = run(*common, "--ckpt", str(tmp_path / "b"), "--ckpt-every",
                  "100")
    want = torch.bfloat16 if not dtype else torch.float32
    assert full["params"]["embed"].dtype == want
    same_params(full["params"], resumed["params"])
    if not dtype:
        assert tckpt.read_manifest(tmp_path / "b", 6)["dtypes"]
    args = ttrain.parser().parse_args(
        [*common, "--steps", "5", "--ckpt", str(tmp_path / "c"),
         "--ckpt-every", "2", "--fail-at", "3"])
    out = run_elastic(ttrain.train, args)
    assert tckpt.latest_step(tmp_path / "c") == 5
    assert all(np.isfinite(out["losses"]))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """repro trains reduced starcoder2 in float32 for 6 steps with a
    checkpoint after step 3; the port resumes from it (its final
    checkpoint removed) and runs steps 4 and 5: their losses within rtol
    1e-4 of repro's, and the parameters within 4 * lr of repro's after
    step 5 (two AdamW steps from the same state, each moving a weight by
    about lr)."""
    from repro.launch.train import parser as rparser, train as rtrain
    argv = ["--arch", "starcoder2-7b", "--reduced", "--steps", "6",
            "--batch", "4", "--seq", "32", "--f32", "--ckpt",
            str(tmp_path), "--ckpt-every", "3", "--log-every", "1"]
    ref = rtrain(rparser().parse_args(argv))
    shutil.rmtree(tmp_path / "step_00000006")
    got = run(*argv, "--device", "cpu")
    np.testing.assert_allclose(got["losses"], ref["losses"][4:], rtol=1e-4)
    lr = 3e-4
    mine = dict(jax.tree_util.tree_leaves_with_path(
        got["params"], is_leaf=torch.is_tensor))
    for path, want in jax.tree_util.tree_leaves_with_path(ref["params"]):
        d = np.abs(mine[path].numpy() - np.asarray(want)).max()
        assert d <= 4 * lr, (path, d)


def test_bf16_checkpoints(tmp_path):
    """A bf16 leaf that repro saves (ml_dtypes' bfloat16) restores in the
    port bit for bit; the port's own bf16 leaves (raw bits, named in the
    manifest) round-trip, float32 leaves beside them as they were."""
    from repro.ckpt import checkpoint as rckpt
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    want = torch.from_numpy(x).bfloat16()
    rckpt.save(tmp_path / "r", 1, {"w": jnp.asarray(x, jnp.bfloat16),
                                   "b": jnp.asarray(x)})
    ex = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
          "b": torch.zeros((3, 5))}
    got, _ = tckpt.restore(tmp_path / "r", 1, ex)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], want)
    assert torch.equal(got["b"], torch.from_numpy(x))
    tckpt.save(tmp_path / "t", 1, {"w": want, "b": torch.from_numpy(x)})
    assert tckpt.read_manifest(tmp_path / "t", 1)["dtypes"] == {"1": \
        "bfloat16"}
    got, _ = tckpt.restore(tmp_path / "t", 1, ex)
    assert torch.equal(got["w"], want) and torch.equal(
        got["b"], torch.from_numpy(x))


def test_train_cli_refuses_the_mesh():
    with pytest.raises(NotImplementedError, match="14f"):
        run("--arch", "starcoder2-7b", "--reduced", "--steps", "1",
            "--device", "cpu", "--mesh")
    with pytest.raises(NotImplementedError, match="14f"):
        run("--arch", "starcoder2-7b", "--reduced", "--steps", "1",
            "--device", "cpu", "--model-parallel", "2")
