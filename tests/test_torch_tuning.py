"""The tuning knobs (``repro_torch.models.tuning``) and the dry run
(``repro_torch.launch.dryrun``) on the CPU.

tests/test_tuning.py's three tests on the port, each side also held
against repro under the same ``Tuning`` (float32, reduced configs):

* the MoE's ``'scatter'`` and ``'gather'`` dispatches (and
  ``'shard_map'``, which falls back to ``'gather'`` without a mesh) give
  the same output bit for bit, each within 1e-4 of repro's ``moe`` under
  that dispatch, relative to its largest value (as tests/test_torch_moe);
* gemma2's decode with the windowed cache read on (``OPTIMIZED``) and
  off (``BASELINE``: full-length logits, masked) after a 12-token prompt,
  at position 12 past the window of 8: logits within 1e-6 of each other
  (the reference's test's limit: the masked keys add zeros, in another
  order), each within 1e-4 of repro's ``serve_step`` under that tuning;
* one llama4 train step under both tunings: the same loss bit for bit
  (the dispatches build the same buffer), each within rtol 1e-4 of
  repro's ``train_step`` loss under that tuning (tests/test_torch_train's
  limit).

The dry run: two cells at full size on the meta device,
``starcoder2-7b|prefill_32k`` and ``jamba-v0.1-52b|decode_32k``: their
argument bytes are the port's tensors' (parameters built again and
summed), and two runs give the same record; the CLI writes one record a
cell, skips it on a second run and refuses ``--mesh``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import get_reduced as r_get_reduced
from repro.models import layers as RL
from repro.models.model import Model as RModel
from repro.models import tuning as RTU
from repro_torch.configs.archs import REGISTRY, SHAPES
from repro_torch.configs.reduced import get_reduced
from repro_torch.launch import dryrun
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import params_from_jax
from repro_torch.models.tuning import BASELINE, OPTIMIZED, Tuning, use_tuning

noshard = lambda a, *_: a
TUNINGS = {"baseline": (BASELINE, RTU.BASELINE),
           "opt": (OPTIMIZED, RTU.OPTIMIZED)}


def test_moe_dispatch_equivalence():
    """'gather' == 'scatter' bit for bit in f32; each against repro's."""
    cfg = get_reduced("qwen3-moe-235b-a22b")
    rcfg = r_get_reduced("qwen3-moe-235b-a22b")
    p = {k: np.array(v) for k, v in RL.init_moe(
        jax.random.PRNGKey(0), rcfg, jnp.float32).items()}
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (2, 16, cfg.d_model), jnp.float32))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    outs = {}
    for dispatch in ("scatter", "gather", "shard_map"):
        with use_tuning(Tuning(moe_dispatch=dispatch)):
            outs[dispatch] = TL.moe(tp, torch.from_numpy(x), cfg)
        with RTU.use_tuning(RTU.Tuning(moe_dispatch=dispatch)):
            want = np.asarray(RL.moe({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x), rcfg,
                                     noshard))
        np.testing.assert_allclose(outs[dispatch].numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    assert torch.equal(outs["scatter"], outs["gather"])
    assert torch.equal(outs["shard_map"], outs["gather"])
    with use_tuning(Tuning(moe_dispatch="all_to_all")):
        with pytest.raises(ValueError, match="moe_dispatch"):
            TL.moe(tp, torch.from_numpy(x), cfg)


def test_decode_equal_with_and_without_the_window_slice():
    """gemma2's serve_step logits with the windowed cache read on and off
    (the port's one-card counterpart of the reference's test across its
    two cache shardings); each against repro's under the same tuning."""
    arch, B, P, total = "gemma2-9b", 2, 12, 16
    rcfg = r_get_reduced(arch)
    prompts = np.random.default_rng(0).integers(
        0, rcfg.vocab, (B, P)).astype(np.int32)
    tok = np.random.default_rng(1).integers(
        0, rcfg.vocab, (B, 1)).astype(np.int32)
    params = RModel(cfg=rcfg, dtype=jnp.float32).init(jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, params)
    outs = {}
    for name, (tun, rtun) in TUNINGS.items():
        rm = RModel(cfg=rcfg, dtype=jnp.float32, tuning=rtun)
        _, caches = jax.jit(rm.prefill_step)(
            params, {"tokens": jnp.asarray(prompts)})
        caches = jax.tree.map(lambda c: jnp.pad(
            c, ((0, 0),) * 3 + ((0, total - P),) + ((0, 0),)), caches)
        want, _ = jax.jit(rm.serve_step)(params, caches, jnp.asarray(tok),
                                         jnp.asarray(P))
        model = params_from_jax(get_reduced(arch), tree, device="cpu",
                                backend="torch")
        model.tuning = tun
        _, tcaches = tserve.prefill(model, torch.from_numpy(prompts), total)
        outs[name], _ = model.serve_step(tcaches, torch.from_numpy(tok), P)
        np.testing.assert_allclose(outs[name].numpy(), np.asarray(want),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(outs["baseline"].numpy(),
                               outs["opt"].numpy(), rtol=1e-6, atol=1e-6)


def test_train_step_equal_under_dispatch():
    """One reduced MoE train step: the same loss under both tunings, each
    against repro's."""
    arch = "llama4-maverick-400b-a17b"
    rcfg = r_get_reduced(arch)
    key = jax.random.PRNGKey(3)
    tokens = np.array(jax.random.randint(key, (2, 17), 0, rcfg.vocab))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    params = RModel(cfg=rcfg, dtype=jnp.float32).init(key)
    tree = jax.tree.map(np.asarray, params)
    losses = {}
    for name, (tun, rtun) in TUNINGS.items():
        rm = RModel(cfg=rcfg, dtype=jnp.float32, tuning=rtun)
        _, _, metrics = jax.jit(rm.train_step)(
            params, rm.init_opt(params), jnp.zeros((), jnp.int32),
            {k: jnp.asarray(v) for k, v in batch.items()})
        model = params_from_jax(get_reduced(arch), tree, device="cpu",
                                backend="torch")
        model.tuning = tun
        _, got = model.train_step(model.init_opt(), 0, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        losses[name] = got["loss"]
        np.testing.assert_allclose(float(got["loss"]),
                                   float(metrics["loss"]), rtol=1e-4)
    assert torch.equal(losses["baseline"], losses["opt"]), losses


@pytest.mark.parametrize("arch,shape", [("starcoder2-7b", "prefill_32k"),
                                        ("jamba-v0.1-52b", "decode_32k")])
def test_dryrun_counts_a_full_size_cell_on_meta(arch, shape):
    rec = dryrun.count_cell(arch, shape)
    cfg = REGISTRY[arch]
    params = TT.init_params(cfg, torch.bfloat16, "meta")
    args = rec["argument_bytes"]
    assert args["params"] == sum(p.numel() * p.element_size()
                                 for p in params.parameters())
    B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    if shape.startswith("decode"):
        cache = TT.init_cache(cfg, B, S, torch.bfloat16, "meta")
        assert args["cache"] == sum(t.numel() * 2 for c in cache
                                    for t in c.values()
                                    if t.dtype == torch.bfloat16) + sum(
            t.numel() * 4 for c in cache for t in c.values()
            if t.dtype == torch.float32)
        assert args["inputs"] == B * 4
    else:
        assert args["inputs"] == B * S * 4
    assert rec["model_flops"] == dryrun.model_flops(cfg, SHAPES[shape]) > 0
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["peak_bytes_estimate"] > sum(args.values())
    assert rec["n_chips"] == 1
    assert dryrun.count_cell(arch, shape) == rec


def test_dryrun_cli_writes_resumes_and_refuses_a_mesh(tmp_path, capsys):
    out = tmp_path / "dry.json"
    argv = ["--arch", "starcoder2-7b", "--shape", "decode_32k", "--out",
            str(out)]
    assert dryrun.main(argv) == 0
    res = json.loads(out.read_text())
    assert list(res) == ["starcoder2-7b|decode_32k"]
    assert res["starcoder2-7b|decode_32k"]["ok"]
    assert dryrun.main(argv) == 0
    assert "[skip] starcoder2-7b|decode_32k" in capsys.readouterr().out
    assert dryrun.main(argv + ["--tuning", "opt"]) == 0
    assert sorted(json.loads(out.read_text())) == [
        "starcoder2-7b|decode_32k", "starcoder2-7b|decode_32k|opt"]
    with pytest.raises(NotImplementedError, match="14f"):
        dryrun.main(["--mesh", "single", "--out", str(out)])
