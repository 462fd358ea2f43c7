"""The port's MoE ffn (``repro_torch.models.layers.moe`` and its routing
``moe_route``) and the MoE archs (qwen3-moe-235b-a22b, llama4-maverick-
400b-a17b) against repro's on the CPU, with the reference's weights and
inputs drawn with numpy from a seed.

* Routing, bit for bit: the reference's ``moe`` runs op by op
  (``jax.disable_jit``) and its integer routing is read where it is made
  (``slot`` and ``keep`` at its first ``jnp.where``, ``tok_for_slot`` at
  its first ``jnp.minimum``, the sorted tokens at its ``segment_sum``).
  Cases: random routing; a router that sends every token to expert 0
  first, so that expert overflows its capacity and pairs are dropped;
  two equal router columns, so scores tie (the lower expert wins, as
  ``lax.top_k``); top-1 (llama4); bf16 activations against the float32
  router.
* The MoE's output within 1e-4 of the reference's, relative to its
  largest value in float32 (readings 1e-8 to 1.4e-7 of it), 2e-2 in bf16
  (4.6e-3: the two frameworks round bf16 at other points).
* Whole models (reduced, float32): prefill logits within 1e-4 and 8
  greedy steps with identical tokens, on both backends, through
  tests/test_torch_ssm.py's reference driver.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.archs import get_arch as r_get_arch
from repro.configs.reduced import reduced as r_reduced
from repro.models import layers as RL
from repro_torch.configs.archs import get_arch
from repro_torch.configs.reduced import reduced
from repro_torch.models import layers as TL
from test_torch_ssm import check_model_f32

noshard = lambda a, *_: a


def reference_moe(monkeypatch, p, x, cfg):
    """repro's ``moe`` op by op: (output, its integer routing)."""
    seen = {}

    def spy(name, real, pick):
        def call(*a, **k):
            out = real(*a, **k)
            if name not in seen:
                seen[name] = pick(a, out)
            return out
        return call

    monkeypatch.setattr(jnp, "where", spy(
        "where", jnp.where, lambda a, out: (np.asarray(a[0]),
                                            np.asarray(out))))
    monkeypatch.setattr(jnp, "minimum", spy(
        "minimum", jnp.minimum, lambda a, out: np.asarray(a[0])))
    monkeypatch.setattr(jax.ops, "segment_sum", spy(
        "segment_sum", jax.ops.segment_sum, lambda a, out: np.asarray(a[1])))
    with jax.disable_jit():
        y = RL.moe({k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x), cfg, noshard)
    monkeypatch.undo()
    keep, slot = seen["where"]
    return np.asarray(y.astype(jnp.float32)), {
        "keep": keep, "slot": slot, "tok_for_slot": seen["minimum"],
        "tok_s": seen["segment_sum"]}


def case(name):
    """(reference cfg, port cfg, params as numpy, x as numpy, dtype)."""
    arch = "llama4-maverick-400b-a17b" if name == "top1" else \
        "qwen3-moe-235b-a22b"
    rcfg, tcfg = r_reduced(r_get_arch(arch)), reduced(get_arch(arch))
    if name == "overflow":          # the capacity factor of the full archs
        rcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=1.25)) for c in (rcfg, tcfg))
    dtype = "bfloat16" if name == "bf16" else "float32"
    p = {k: np.array(v.astype(jnp.float32)) for k, v in RL.init_moe(
        jax.random.PRNGKey(4), rcfg, getattr(jnp, dtype)).items()}
    x = np.random.default_rng(9).standard_normal(
        (2, 32, rcfg.d_model)).astype(np.float32)
    if name == "overflow":          # every token's first choice: expert 0
        x = np.abs(x)
        p["router"][:, 0] = 1.0
    if name == "ties":              # experts 1 and 2 score alike
        p["router"][:, 2] = p["router"][:, 1]
    return rcfg, tcfg, p, x, dtype


@pytest.mark.parametrize("name", ["random", "overflow", "ties", "top1",
                                  "bf16"])
def test_moe_routing_and_output_match_reference(monkeypatch, name):
    rcfg, tcfg, p, x, dtype = case(name)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    rp = {k: v if k == "router" else np.asarray(jnp.asarray(v).astype(jd))
          for k, v in p.items()}
    want, route = reference_moe(monkeypatch, rp, jnp.asarray(x).astype(jd),
                                rcfg)
    tp = {k: torch.from_numpy(v) if k == "router" else
          torch.from_numpy(v).to(td) for k, v in p.items()}
    tx = torch.from_numpy(x).to(td)
    mc = tcfg.moe
    T = x.shape[0] * x.shape[1]
    C = max(int(T * mc.top_k / mc.n_experts * mc.capacity_factor), 8)
    r = TL.moe_route(tp["router"], tx.reshape(T, -1), mc.n_experts,
                     mc.top_k, C)
    for field in ("keep", "slot", "tok_for_slot", "tok_s"):
        got = getattr(r, field).numpy()
        np.testing.assert_array_equal(got, route[field].astype(got.dtype),
                                      err_msg=field)
    drops = int((~r.keep).sum())
    assert (drops > 0) == (name == "overflow"), drops
    if name == "ties":              # the tie broke for expert 1 somewhere
        chose = torch.zeros((T, mc.n_experts), dtype=torch.bool)
        chose[r.tok_s, r.eid_s] = True
        assert bool((chose[:, 1] & ~chose[:, 2]).any())
    got = TL.moe(tp, tx, tcfg).float().numpy()
    scale = float(np.abs(want).max())
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_serving_matches_reference_f32(arch, backend):
    check_model_f32(arch, backend)
