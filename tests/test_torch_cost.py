"""The port's op counter (``repro_torch.launch.op_cost``) against the
reference's HLO counter (``repro.launch.hlo_cost``) on the CPU.

* Prefill and decode FLOPs, exactly: each of the ten archs' reduced
  configs at B 2, S 32, float32, prefill and one decode step at pos 3 of
  a 32-slot cache: the port's counter on the ``torch`` backend against
  ``cost_record(jit(step).lower(...).compile().as_text())`` of repro's
  ``Model`` (one prefill / decode sequence of ops each; the reference's
  chunked attention is dense in both, one KV block at S 32).
* The ``cuda`` backend (the flash kernel's plain version on the CPU): its
  flash term equals the closed form 4 · dh · B·H · (unmasked pairs),
  summed over its calls, and with that term replaced by the dense
  4 · dh · B·H · Sq·Sk its total equals the ``torch`` backend's.
* Train steps of starcoder2-7b, gemma2-9b and qwen3-moe: the port counts
  the reference's FLOPs plus one named term, its cross-entropy chunk's
  logits product 2 · B·S · D · V, which the port's ``checkpoint`` of the
  chunk recomputes in the backward (the reference does not remat it).
* The rules op by op: matrix products, views, gathers, scatters, slice
  writes, a collective (gloo, one rank); the live-storage peak.
* The meta device counts what the CPU counts, record for record, on the
  ``cuda`` backend (kernel entries' rules, their insides hidden).
* PERF.md §6's ``bound_ms`` of rows 1-7e from the kernels' rules at each
  row's shape (``chip_smoke.PERF_BOUNDS``), to the printed digits.

repro's counts are compiled once per module, in a thread pool (XLA
compiles outside the interpreter lock).
"""
import concurrent.futures
import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.configs.archs import REGISTRY as R_REGISTRY
from repro.configs.reduced import get_reduced as r_get_reduced
from repro.launch.hlo_cost import cost_record as hlo_cost_record
from repro.models import transformer as RT
from repro.models.model import Model as RModel
from repro_torch.configs.reduced import get_reduced
from repro_torch.kernels import csr_relax as TC
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels import repair as TK
from repro_torch.kernels import segment as TS
from repro_torch.launch import op_cost
from repro_torch.launch.op_cost import CostCounter
from repro_torch.models import transformer as TT
from repro_torch.models.model import CE_CHUNK, Model

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (PERF_BOUNDS, perf_bounds)

B, S, POS = 2, 32, 3
ARCHS = sorted(R_REGISTRY)
TRAIN_ARCHS = ["starcoder2-7b", "gemma2-9b", "qwen3-moe-235b-a22b"]


def src_len(cfg) -> int:
    return {"vlm": cfg.n_img_tokens, "audio": cfg.enc_seq}.get(cfg.family, 0)


def ref_counts(arch: str) -> dict:
    """repro's HLO FLOPs of the prefill, a decode step and (for
    TRAIN_ARCHS) a train step."""
    cfg = r_get_reduced(arch)
    model = RModel(cfg=cfg, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0))
    tok = jnp.zeros((B, S), jnp.int32)
    T_src = src_len(cfg)
    src = jnp.zeros((B, T_src, cfg.d_model)) if T_src else None
    batch = {"tokens": tok} if src is None else {"tokens": tok, "src": src}
    flops = lambda fn, *a: hlo_cost_record(jax.jit(fn).lower(*a).compile()
                                           .as_text())["flops_per_device"]
    out = {"prefill": flops(model.prefill_step, params, batch),
           "decode": flops(lambda p, c, t, pos: model.serve_step(
               p, c, t, pos, src=src), params,
               RT.init_cache(cfg, B, S, jnp.float32),
               jnp.zeros((B, 1), jnp.int32), jnp.asarray(POS))}
    if arch in TRAIN_ARCHS:
        out["train"] = flops(model.train_step, params,
                             model.init_opt(params),
                             jnp.zeros((), jnp.int32),
                             {"tokens": tok, "labels": tok})
    return out


@pytest.fixture(scope="module")
def refs():
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        return dict(zip(ARCHS, pool.map(ref_counts, ARCHS)))


def port_model(arch: str, device="cpu", backend="torch") -> Model:
    cfg = get_reduced(arch)
    model = Model(cfg, dtype=torch.float32, device=device, backend=backend)
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    model.params = TT.init_params(cfg, torch.float32, device, gen)
    return model


def port_step(model: Model, kind: str):
    """(the step as a thunk) on zero tokens, as ``ref_counts`` feeds."""
    cfg, dev = model.cfg, model.device
    tok = torch.zeros((B, S), dtype=torch.int32, device=dev)
    T_src = src_len(cfg)
    src = torch.zeros((B, T_src, cfg.d_model), device=dev) if T_src \
        else None
    if kind == "prefill":
        return lambda: model.prefill_step(tok, src)
    if kind == "decode":
        cache = TT.init_cache(cfg, B, S, torch.float32, dev)
        one = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        return lambda: model.serve_step(cache, one, POS, src)
    opt = model.init_opt()
    return lambda: model.train_step(opt, 0, {"tokens": tok, "labels": tok})


def count(model: Model, kind: str) -> dict:
    step = port_step(model, kind)
    with CostCounter() as c:
        step()
    return c.cost_record()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_flops_equal_the_reference(refs, arch):
    model = port_model(arch)
    for kind in ("prefill", "decode"):
        assert count(model, kind)["flops_per_device"] == refs[arch][kind], \
            kind


def unmasked_pairs(S_: int, causal: bool, window=None) -> int:
    """Row i sees keys j <= i (causal), within ``window`` of it."""
    if not causal:
        return S_ * S_
    return sum(min(i + 1, window or S_) for i in range(S_))


def flash_calls(cfg) -> list:
    """(BH, S, dh, causal, window) of each flash call of a prefill."""
    H, dh = cfg.n_heads, cfg.dh
    calls = [(B * H, src_len(cfg), dh, False, None)] * cfg.enc_layers
    for spec in TT.layer_specs(cfg):
        if spec["mixer"] in ("attn", "attn_local"):
            window = cfg.local_window if spec["mixer"] == "attn_local" \
                else None
            calls.append((B * H, S, dh, True, window))
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_backend_counts_the_flash_rule(arch):
    cfg = get_reduced(arch)
    torch_rec = count(port_model(arch), "prefill")
    cuda_rec = count(port_model(arch, backend="cuda"), "prefill")
    calls = flash_calls(cfg)
    rule = sum(4 * dh * BH * unmasked_pairs(S_, c, w)
               for BH, S_, dh, c, w in calls)
    dense = sum(4 * dh * BH * S_ * S_ for BH, S_, dh, c, w in calls)
    got = cuda_rec["by_kernel"].get("flash_attention",
                                    {"calls": 0, "flops": 0})
    assert (got["calls"], got["flops"]) == (len(calls), rule)
    assert cuda_rec["flops_per_device"] - rule + dense == \
        torch_rec["flops_per_device"]
    assert "flash_attention" not in torch_rec["by_kernel"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_flops_equal_the_reference_but_the_ce_remat(refs, arch):
    """The port = the reference + one logits product of the whole batch:
    ``Model._ce_loss`` checkpoints each chunk, so the backward recomputes
    its ``h @ head`` (2 · B·S · D · V, an ``mm``); the reference's chunk
    scan is not rematerialised."""
    cfg = get_reduced(arch)
    rec = count(port_model(arch), "train")
    ce_remat = 2 * B * S * cfg.d_model * cfg.vocab
    assert rec["flops_per_device"] == refs[arch]["train"] + ce_remat
    # the same step with the chunk's recompute taken out counts exactly
    # the reference's: the named term is the only one
    model = port_model(arch)
    model._ce_loss = lambda h, labels: ce_loss_no_remat(model, h, labels)
    assert count(model, "train")["flops_per_device"] == refs[arch]["train"]


def ce_loss_no_remat(model, h, labels):
    """``Model._ce_loss`` without the checkpoint around each chunk."""
    Bh, Sh, _ = h.shape
    labels = labels.long()
    tot = torch.zeros((), dtype=torch.float32)
    for c in range(0, Sh, CE_CHUNK):
        tot = tot + model._ce_chunk(h[:, c:c + CE_CHUNK],
                                    labels[:, c:c + CE_CHUNK])
    return tot / (Bh * Sh)


# -- the rules, op by op -----------------------------------------------------

def counted(fn) -> dict:
    with CostCounter() as c:
        fn()
    return c.cost_record()


def test_matrix_products_count_two_flops_a_multiply_add():
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    x, y = torch.ones(2, 3, 5), torch.ones(2, 5, 7)
    bias = torch.ones(7)
    cases = [(lambda: a @ b, 2 * 3 * 5 * 7, (15 + 35 + 21) * 4),
             (lambda: torch.bmm(x, y), 2 * 2 * 3 * 5 * 7,
              (30 + 70 + 42) * 4),
             (lambda: torch.einsum("bij,bjk->bik", x, y), 2 * 2 * 3 * 5 * 7,
              (30 + 70 + 42) * 4),
             (lambda: torch.addmm(bias, a, b), 2 * 3 * 5 * 7,
              (7 + 15 + 35 + 21) * 4)]
    for fn, flops, moved in cases:
        rec = counted(fn)
        assert rec["flops_per_device"] == flops
        assert rec["bytes_per_device"] == moved
        assert rec["flops_by_dtype"] == {"float32": flops}
    assert counted(lambda: a * 2.0)["flops_per_device"] == 0   # elementwise
    rec = counted(lambda: F.linear(torch.ones(4, 5), torch.ones(7, 5)))
    assert rec["flops_per_device"] == 2 * 4 * 5 * 7


def test_views_move_nothing_and_copies_move_both_ways():
    x = torch.ones(4, 6)
    rec = counted(lambda: (x.view(6, 4), x.t(), x[1:3], x[2], x.reshape(24),
                           x.expand(2, 4, 6), x.as_strided((2, 2), (1, 1)),
                           x.unsqueeze(0), torch.empty(10)))
    assert rec["bytes_per_device"] == 0 and rec["flops_per_device"] == 0
    rec = counted(lambda: x.t().reshape(24))      # needs a copy
    assert rec["bytes_per_device"] == 2 * 24 * 4


def test_gathers_scatters_and_slice_writes():
    x = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    idx = torch.tensor([1, 3, 3])
    gather = 2 * 3 * 4 * 4 + 3 * 8          # 2 · result + int64 indices
    assert counted(lambda: x.index_select(0, idx))["bytes_per_device"] == \
        gather
    assert counted(lambda: x[idx])["bytes_per_device"] == gather
    upd = torch.ones(10, 2)

    def slice_write():
        x[:, 1:3] = upd
    assert counted(slice_write)["bytes_per_device"] == 2 * 20 * 4
    src = torch.ones(3, 4)
    assert counted(lambda: x.index_copy_(0, idx[:2], src[:2]))[
        "bytes_per_device"] == 2 * 8 * 4

    def put():
        x[idx] = src
    assert counted(put)["bytes_per_device"] == 2 * 12 * 4 + 3 * 8


def test_collectives_count_result_bytes_by_kind(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        t = torch.ones(1000)
        rec = counted(lambda: dist.all_reduce(t))
    finally:
        dist.destroy_process_group()
    assert rec["collective_count"] == 1
    assert rec["collective_bytes_per_device"] == 4000
    assert rec["coll_all-reduce"] == 4000
    assert rec["bytes_per_device"] == 8000


def test_peak_of_live_storages():
    def run():
        a = torch.ones(1000)                  # 4,000 live
        b = torch.ones(2000)                  # 12,000
        del a
        c = torch.ones(500)                   # 10,000
        d = c.view(10, 50)                    # a view: no new storage
        c.add_(1.0)                           # in place: no new storage
        return b, d
    assert counted(run)["peak_live_bytes"] == 12000


def test_kernel_entries_record_their_rule_and_hide_their_inside():
    R, K, n = 256, 8, 100
    g = torch.Generator().manual_seed(0)
    src = torch.randint(0, n + 1, (R, K), generator=g, dtype=torch.int32)
    w = torch.randint(1, 9, (R, K), generator=g, dtype=torch.int32)
    vals = torch.randint(0, 99, (n + 1,), generator=g, dtype=torch.int32)
    rec = counted(lambda: TK.fused_relax_rows(src, w, vals, block=128))
    want = (2 * R * K + n + 1) * 4 + (3 * R + R // 128) * 4
    assert rec["bytes_per_device"] == want
    assert list(rec["by_kernel"]) == ["fused_relax_rows"]
    assert [k for k in rec if k.startswith("bytes_")] == [
        "bytes_per_device", "bytes_fused_relax_rows"]
    # on meta: the rule, empty outputs of the kernel's shapes, no compute
    m = [t.to("meta") for t in (src, w, vals)]
    out = TK.fused_relax_rows(*m, block=128)
    assert [(o.shape, o.dtype, o.device.type) for o in out] == [
        ((R,), torch.int32, "meta")] * 3 + [((2,), torch.int32, "meta")]
    q = torch.empty(6, 40, 16, dtype=torch.bfloat16, device="meta")
    o, lse = TF.flash_attention(q, q, q, window=8, return_lse=True)
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == (
        q.shape, q.dtype, (6, 40), torch.float32)
    dq, dk, dv = TF.flash_attention_backward(q, q, q, o, lse, q)
    assert all(t.shape == q.shape for t in (dq, dk, dv))
    assert TS.segment_sum_sorted(torch.empty(9, device="meta"), None,
                                 torch.empty(4, dtype=torch.int32,
                                             device="meta")).shape == (3,)
    assert TC.relax_rowmin(*m).shape == (R,)
    assert TF.pairs(40, True, 8) == unmasked_pairs(40, True, 8)


@pytest.mark.parametrize("arch,kind", [("starcoder2-7b", "train"),
                                       ("gemma2-9b", "prefill"),
                                       ("jamba-v0.1-52b", "decode"),
                                       ("whisper-large-v3", "prefill")])
def test_meta_counts_what_the_cpu_counts(arch, kind):
    """One step on the ``cuda`` backend (the kernel entries' rules) on
    the CPU and on meta: the same record, key for key."""
    cpu = count(port_model(arch, backend="cuda"), kind)
    meta = count(port_model(arch, "meta", backend="cuda"), kind)
    assert cpu == meta
    assert bool(cpu["by_kernel"]) == (kind != "decode")   # decode: no flash


@pytest.fixture(scope="module")
def bounds():
    return chip_smoke.perf_bounds(torch, TK, TC, TF)


@pytest.mark.parametrize("i", range(len(chip_smoke.PERF_BOUNDS)),
                         ids=[r[0] for r in chip_smoke.PERF_BOUNDS])
def test_rules_give_perf_md_bounds(bounds, i):
    row, kernel, got, want = bounds[i]
    assert got == want, (row, kernel)


def test_bound_takes_the_larger_term():
    rec = {"bytes_per_device": 3_350_000_000,
           "flops_by_dtype": {"bfloat16": 989_400_000_000}}
    assert op_cost.bound_s(rec) == pytest.approx(1e-3)
    rec["bytes_per_device"] *= 2
    assert op_cost.bound_s(rec) == pytest.approx(2e-3)
    rec["flops_by_dtype"]["float32"] = 66_900_000_000 * 3
    assert op_cost.bound_s(rec) == pytest.approx(4e-3)
