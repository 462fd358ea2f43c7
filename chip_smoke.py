#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # RMAT scale 22, degree 16, 1% updates
    python3 chip_smoke.py --scale 16      # a quick, small run
    python3 chip_smoke.py --profile       # + a torch.profiler breakdown
    python3 chip_smoke.py --tc-log2 16    # a smaller uniform TC graph

Phases (any failure exits non-zero):

1. Device: the card's name and power limit, the CUDA version, and the
   build of the kernels in ``src/repro_torch/csrc`` with ``nvcc`` (one
   process per source, all at once).
2. Paths, each driven through ``repro_torch.bind_graph`` over the same
   graph and ``random_updates(csr, percent=1, seed=1)`` in batches of
   65,536, each in a window of its own: every kernel's launch count and
   the peak memory are reset just before it and read just after.
   a. SSSP on ``cuda`` — ``static_sssp`` from vertex 0, then
      ``stream_step``: ``fused_relax_rows`` and ``merge_pool_sorted``
      (once per add batch) must launch, the chained kernels must not.
   b. PageRank on ``cuda`` — ``static_pr``, then ``make_stream_step``
      with the conformance knobs (beta 1e-4, delta 0.85, 100 sweeps at
      most): ``fused_spmv_rows``, ``segment_sum_sorted`` (the vertex
      combine) and ``merge_pool_sorted`` (once per add batch) must
      launch, the chained kernels must not.
   c. SSSP on ``cuda_chained`` (``relax_rowmin`` and ``relax_rowargmin``
      must launch), then PageRank on it (``spmv_rowsum`` and
      ``segment_sum_sorted`` must launch); neither runs a fused kernel
      or the other algorithm's chained kernels.
   d. Triangle counting on its own graph, the reference's TC family: a
      uniform graph of 2^20 vertices and degree 8, self-loops dropped,
      symmetrized (16,777,040 edge lanes, max degree 39), with 0.4%
      updates made symmetric in pairs, in batches of 65,536.
      ``static_tc``, then ``dyn_tc`` through ``bind_graph(...).call`` and
      ``stream_step`` through ``run_stream``, on ``cuda``: only
      ``merge_pool_sorted`` launches, once per add batch.  The counts
      (int32) equal the ``torch`` backend's, ``cuda_chained``'s, the
      DSL's ``DynTC`` (phase e) and scipy's exact count over the edge
      sets; a symmetrized ``rmat_graph(14, 16)`` with 1% updates is
      checked against scipy too, not timed.
   e. The DSL on the card, after step 4's checks (it reuses their
      references): ``repro_torch.compile`` of ``sssp.sp`` bound on
      ``cuda`` runs ``DynSSSP`` one-shot over the same graph and stream
      (``dist`` equal to 2a's bit for bit) and armed (``run`` without the
      stream, then the stream through ``apply``; equal to one-shot);
      ``DynPR`` armed and one-shot, bit-identical, within step 4's
      bounds of the float64 PageRank; ``merge_pool_sorted`` launches per
      add batch, ``segment_sum_sorted`` in PageRank, no row kernel (DSL
      sweeps declare no gather form, as in the reference).  An armed
      ``DynSSSP`` at RMAT scale 16, in batches of 2,048, is saved midway
      into a temporary directory, restored and finished: ``dist`` and
      every DynGraph and ELL array equal the uninterrupted run's.
   f. Failover and serving, after 2e.  SSSP on the graph and stream of
      2a through ``bind_graph(failover=True)`` on ``cuda``, with a fault
      planted at the ``kernel_launch`` seam of ``update_add`` from the
      third batch on: the session must hop to ``cuda_chained`` (same
      engine name, so it fails too) and then to ``torch`` (2 failovers)
      and end with dist, parent and every DynGraph array equal to 2a's;
      a fault that only the fused regime meets must stop it on
      ``cuda_chained``, whose ``relax_rowmin`` and ``relax_rowargmin``
      then launch; one more batch with the re-probe due must bring it
      back to ``cuda`` (``fused_relax_rows`` launches again; dist and
      parent equal the ``torch`` session's); without ``failover=`` the
      fault must raise ``KernelFailure`` with every array as before the
      batch.  Each migration's wall time is printed.  Then the serving
      pool: ``SessionPool`` on ``cuda``, 32 tenants on ``rmat_graph(16,
      8, seed=1)`` without self-loops, each with its own
      ``random_updates(percent=30, seed=t)`` in batches of 2,048, 8
      armed ``DynSSSP`` tenants and 24 structural ones, ``max_resident``
      24, 8 ticks through ``apply_many``, in ``vmap``, ``scan`` and
      ``off`` modes: every tenant's DynGraph, ELL and property arrays
      equal across the modes and to solo sessions; in ``vmap``
      ``merge_pool_sorted_batched`` launches once a tick (one group) and
      ``merge_pool_sorted`` only for the armed tenants, in ``scan`` and
      ``off`` ``merge_pool_sorted`` once a tenant a tick; a mega-call
      makes at most 2 host syncs.  Tick p50/p99 and µs a session are
      printed per mode.
   g. The fused stream executor and the frontier engine, after 2f.  Every
      path of 2a-2c so far ran ``run_stream`` fused: a segment of up to 8
      batches, run uncaptured at its first use (so each of those one-segment
      streams), one captured CUDA graph from its second, its loops
      conditional nodes.  Here SSSP and PageRank on ``cuda`` and
      ``cuda_chained`` (2a's graph and stream) and TC on ``cuda`` (2d's)
      run from one start state through the per-batch driver
      (``Engine.run_stream``), then through the fused executor three
      times (uncaptured; capture and replay; replay alone): carries,
      every DynGraph array and the ELL pack equal bit for bit, every
      kernel's launches equal in the four runs, host syncs counted (a
      replayed SSSP segment at most ``SSSP_REPLAY_SYNCS``; it must launch
      ``graph_cond_set``), capture time, wall time and peak memory
      printed; on SSSP ``cuda`` a replay continuing from the last one's
      handle equals the per-batch driver's continuation, and the device's
      busy share of the per-batch run and of a replay (torch.profiler).
      Then SSSP and PageRank on ``frontier`` through ``bind_graph``
      (static runs with sparse steps and dense chunks counted, streams
      fused): dist, parent and pr equal the ``torch`` backend's of step 4
      bit for bit.
   h. The distributed backends, after 2g.  ``dist`` and ``dist_sharded``
      (block partitioner) with ``DIST_SHARDS`` shards stacked on the card
      run 2a's SSSP and 2b's PageRank through ``bind_graph(...,
      num_shards=4).run_stream`` (fused): SSSP dist and parent bit for
      bit against 2a's ``cuda``, PageRank within step 4's float64 bound
      and the cuda-vs-torch limits of 2b's run; SSSP once more on the
      degree partitioner; TC per batch on ``dist`` (``DIST_TC_SHARDS``
      shards, 2d's graph) equal to scipy's counts; one NCCL rank
      (``comm="group"``, a world of one) bit for bit against the stacked
      P = 1 run; an armed DynSSSP (``SAVE_SCALE``) saved on
      ``DIST_SHARDS`` shards, restored onto 2 and onto ``cuda`` and run
      on, equal to the uninterrupted run.  Each window prints wall time,
      peak memory, emax against E, one shard's bytes against one
      DynGraph's and, for ``dist_sharded``, the halo sizes and rebuilds.
      No kernel of the row path or the merge may launch there.
   The main paths (2a-2c, step 4, 2g) must end on their own backend with
   no failover.  The ``torch`` backend's runs (step 4) stream through the
   per-batch driver (``Engine.run_stream``), so the reference shares no
   captured graph with the code it checks, and launch no kernel but the
   float segment sum.  Each window of 2d-2f prints its wall time, launches
   and peak memory; each kernel's JSON record lists its launches by
   window (``launches_by_path``; the LM prefill and decode are windows
   too).
3. Kernels against their plain PyTorch versions on the card, at the
   shapes of those runs, bit for bit (float row sums too: both add in one
   fixed order), with their times beside the bound (bytes each input read
   once and each output written once, over 3.35 TB/s, or operations over
   the float32 peak, whichever is larger) and a one-call PyTorch
   yardstick where one exists.  The five row kernels must take their
   warp-loaded path at these shapes (their records name it) and also run
   ``ROW_CASES`` (tiles of 128 to 512, K 4 to 16, one tile, an RMAT pack,
   misaligned views, and for the chained kernels an R that is no
   multiple of 32), bit for bit; ``merge_pool_sorted`` runs
   ``MERGE_CASES`` (ties with rows that differ, D at and around its tile's
   edges, B above the tile and above D, an empty pool, a batch before or
   after the whole pool, negative source ids), bit for bit, before it is
   timed.  ``merge_pool_sorted_batched`` (phase 2f) runs ``MERGE_CASES``
   stacked 1, 3 and 32 sessions wide against its plain version and as
   many solo launches, bit for bit, and is timed at the pool's shape
   beside the solo launches and its bound.  ``graph_cond_set`` (the
   conditional nodes' set kernel, launched by every captured segment:
   2g's replayed SSSP segment must launch it, and gives its count) takes,
   in a captured segment of ``COND_NODES`` branches, the branch its plain
   version (a host read) names, and is timed as one set-and-branch
   against one host read.
4. Correctness of the runs: SSSP ``dist``, ``parent`` and every DynGraph
   array equal the ``torch`` backend's, ``cuda_chained``'s dist and parent
   equal ``cuda``'s, and dist equals scipy's Dijkstra over the
   post-update edge set.  PageRank on ``cuda`` is bit-identical across
   two runs and to ``cuda_chained``, close to the ``torch`` backend
   (another summation order: max 1e-6 and 1e-4 of max(pr), L1 1e-4 and
   1e-5 of sum(pr)), and within a stated L1 bound of a float64 power
   iteration by scipy over the post-update edge set.
5. LM serving, after the graph paths' memory is freed: starcoder2-7b at
   full width and depth (32 layers, 10.12 B parameters, bf16, weights
   from a seeded ``torch.Generator`` on the card) through
   ``repro_torch.launch.serve``'s calls on the ``cuda`` backend: a
   prefill of 4 prompts of 2,048 tokens, which must launch
   ``flash_attention`` once per layer (32 times) and no graph kernel,
   then 32 greedy decode steps, which launch no kernel of ours.  Prefill
   and decode times, peak memory, and the prefill's last-position logits
   against the ``torch`` backend's (the same weights with the reference's
   chunked attention, a bf16 accumulator) within 0.25 of their std;
   every layer's kernel launch against the plain version on that layer's
   own q, k, v (bf16, relative: see below); and the logits against the
   same model with the plain version in the kernel's place, within 0.25
   std and a mean |d| at most twice that of the plain version against
   itself over 256-key blocks; every decoded token in range.  ``flash_attention`` against its
   plain version at the prefill's shape and seven small ones (float32
   2e-5; bf16 3e-2 and, relative to the values, 2^-7 * A + 2^-6 * |want|
   elementwise, A the attention of |v|, and 1e-2 normwise; softcap rtol
   1e-4 / atol 1e-5; bf16 down to one row and under one 128-key tile),
   timed at the prefill's shape beside its bound and
   ``scaled_dot_product_attention`` as the yardstick (the ratio and the
   TFLOP/s reached go into its record).  The graph paths must not
   launch it.  With ``--profile`` the prefill and decode run under
   torch.profiler, and the copies around the kernel (``repeat_kv`` and
   the head transposes in and out) are timed at the prefill's shapes.
   The kernel also runs ``WINDOW_FLASH_CASES`` (a window of 1 to past S,
   on the tensor cores and the CUDA cores, rows whose first KV tile is
   wholly masked): every output finite, within the limits above.
   b. gemma2-9b at full width and depth (42 layers, 21 local ones windowed
      to 4,096 keys, dh 256, softcaps 50 and 30; 9.24 B parameters,
      bf16): 2 prompts of 7,168 tokens, which must launch
      ``flash_attention`` 42 times (windowed and global in turn, each on
      the tensor cores by the library's route count), then 31 decode
      steps, then a warm prefill and 31
      ``long_mode`` decode steps (the global layers windowed too), none of
      which launches; times, peak memory, tokens in range.  Every launch
      against the plain version on its own q, k, v (``BF16_REL``); the
      logits against the ``torch`` backend's and against the plain
      version in the kernel's place, each within ``LM_YARD_MEAN`` /
      ``LM_YARD_MAX`` times the same reference against itself in another
      block order (see the limits' comment).
   c. whisper-large-v3 at full size (32 encoder layers over 1,500 frames
      drawn from a seeded generator, 32 decoder layers of self-attention
      and cross-attention + MLP): 4 prompts of 416 tokens, 64 flash
      launches a prefill (32 not causal in the encoder, on the tensor
      cores, then 32 causal), 31 decode steps whose cross-attention reads
      the raw source (the reference's ``serve_step`` does); the checks of
      phase 5 with its limits.
   d. xlstm-125m at full width and depth (12 layers: 3 sLSTM, 9 mLSTM;
      bf16): 4 prompts of 2,048 tokens and 31 decode steps, no kernel of
      ours launched (no attention layer); times, peak memory, tokens in
      range; a warm prefill split by CUDA events into the sLSTM loop and
      the mLSTM chunks, and under torch.profiler into GEMMs and the rest;
      then in float32 (the same weights) the prefill's last-position
      logits against a token-by-token ``serve_step`` pass from the zero
      state over the same 2,048 positions, max |d| within 1e-3.
   e. jamba-v0.1-52b at full width, one unit of its pattern deep (8
      layers: 7 Mamba, 1 attention, 4 MoE ffns of 16 experts, top-2;
      13.26 B parameters, bf16): 4 prompts of 2,048 tokens, one flash
      launch a prefill (causal, bf16, dh 128: the tensor cores) and 31
      decode steps; times, peak memory, the MoE's dropped (token, expert)
      pairs by layer, the warm prefill's split (Mamba, MoE, attention,
      MLP; GEMMs); the launch against the plain version on its own q, k,
      v (``BF16_REL``); the logits against the ``torch`` backend and the
      plain version in the kernel's place by phase 5b's yardsticks, with
      the tokens whose top-2 experts differ between the runs counted by
      MoE layer; then the kernel timed at this shape beside SDPA.
   Each warm prefill times its flash launches by CUDA events around each
   (their sum and share of the prefill).
   Between c and d the kernel is timed at 5b's and 5c's shapes beside
   its bound and plain version: gemma2's global and windowed prefill attention beside
   ``flex_attention`` (compiled, with the softcap as its ``score_mod``
   and a causal or windowed block mask; SDPA causal without softcap
   stands beside it as a named yardstick of another function) and
   whisper's encoder attention beside SDPA.  Each library call is held
   to the plain version as the kernel is; the records go under
   ``shapes`` in the flash kernel's JSON record.

6. Training (``launch/train.py``'s step function on the ``cuda``
   backend), after the LM phases.
   a. First the backward kernel against its plain version at
      ``BWD_FLASH_CASES`` (``bwd_rel``; the tensor cores at bf16 dh 64
      and 128, the CUDA cores otherwise) and two launches at the training
      shape bit-identical.  Then
      starcoder2-7b at full width cut to 8 of its 32 layers (2.87 B
      parameters, bf16, AdamW at ``TRAIN_LR``), 6 steps on
      ``SyntheticSource`` batches of 4 x 2,048 tokens: first the ``torch`` backend's loss and grad norm
      on step 0's weights and batch; then step 0 with every forward flash
      launch (8, and 8 more recomputed under remat) held to the plain
      version on its own q, k, v (``BF16_REL``, lse within 1e-2) and
      every backward call (8) to the plain backward (``BWD_REL``); each
      step launches ``flash_attention`` 16 times and
      ``flash_attention_backward`` 8 times, all on the tensor cores (the
      library's route count); step 0's loss and grad norm
      within ``TRAIN_LOSS_RTOL`` / ``TRAIN_GNORM_RTOL`` of the ``torch``
      backend's; the last step's loss below step 0's; step time (warm
      median), its forward + backward and optimizer split (CUDA events),
      tokens/s and peak memory; two backward launches on the same inputs
      bit-identical.  The backward kernel is timed at this shape (BH 144,
      S 2,048, dh 128) beside its bound, its plain version and SDPA's
      backward (``is_causal``; its distance from the plain version
      printed), and the forward with lse beside it without.
   b. The reduced starcoder2 through ``launch/train.py`` on ``cuda``
      (bf16, both kernels launched: the backward on the CUDA cores at dh
      16): step 0 of the uninterrupted run with every forward launch held
      to the plain version (``BF16_REL``, lse within 1e-2) and every
      backward call to the plain backward (``BWD_REL``), as in 6a; a run
      resumed from its step-3 checkpoint ends with parameters
      bit-identical to an uninterrupted run's; ``--elastic --fail-at 3``
      restarts and reaches step 5.

7. Counts (``repro_torch.launch.op_cost``), after 6.
   b. PERF.md §6's ``bound_ms`` of rows 1-7e: each kernel entry's rule on
      meta tensors of the row's shape (``PERF_BOUNDS``) equals the stated
      bound to its printed digits.
   a. starcoder2-7b's phase-5 prefill (4 x 2,048), a decode step after
      it and 6a's train step (8 layers, 4 x 2,048), each counted with
      real tensors on the card and again on the meta device: identical
      FLOPs and bytes; each step's counted FLOPs over its warm time as a
      share of 989.4 TFLOP/s (bf16), beside the card's name and power
      limit.
   d. The counted argument bytes of that prefill (parameters, prompts)
      and of the train step (parameters, AdamW state, batch) within 1% of
      the growth of ``memory_allocated`` while building them; the
      counter's peak estimate beside ``max_memory_allocated``.
   c. SSSP on 2a's graph and stream through ``CudaEngine(autotune=
      True)``: each row block that divides R timed on synthetic slots
      (``repair_config(measure=True)``), the fastest kept; ``dist`` and
      ``parent`` equal to 2a's bit for bit.

The last two lines are the kernels' JSON record and the device record.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the paths: RMAT degree 16, 1% of the edges updated, batches of 65,536
# updates (the admission guard's DEFAULT_MAX_BATCH); PageRank's knobs are
# tests/conformance.py's (beta, delta, max_iter)
DEGREE, PERCENT, BATCH = 16, 1.0, 65536
PR_KNOBS = (1e-4, 0.85, 100)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
TENSOR_BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# LM serving: starcoder2-7b at full width and depth, 4 prompts of 2,048
# tokens, 32 greedy tokens
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "starcoder2-7b", 4, 2048, 32
# windowed attention (phase 5b): gemma2-9b at full width and depth, its
# local layers windowed to 4,096 keys; 2 prompts of 7,168 tokens (longer
# than the window, a multiple of the reference's 1,024-key block) and 32
# greedy tokens: 7,200 positions, inside its published 8,192
WIN_ARCH, WIN_BATCH, WIN_PROMPT, WIN_GEN = "gemma2-9b", 2, 7168, 32
# an encoder and cross-attention (phase 5c): whisper-large-v3 at full
# size, its encoder over 1,500 frames; 4 prompts of 416 tokens and 32
# greedy tokens: 448 positions, its published max_target_positions
ENC_ARCH, ENC_BATCH, ENC_PROMPT, ENC_GEN = "whisper-large-v3", 4, 416, 32
# recurrent mixers (phase 5d): xlstm-125m at full width and depth, 4
# prompts of 2,048 tokens (32 chunks of 64; not the mLSTM head width of
# 384, the axis the reference launcher's pad test would take for the
# prompt's) and 32 greedy tokens
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_GEN = "xlstm-125m", 4, 2048, 32
# its float32 check: the prefill's last-position logits against a
# token-by-token serve_step pass from the zero state over the same
# SSM_RECUR positions, max |d| at most SSM_RECUR_ATOL (logits of std
# ~0.56; the chunked and the step forms add in other orders: 3.3e-5 on an
# H100, PERF.md §6)
SSM_RECUR, SSM_RECUR_ATOL = 2048, 1e-3
# a hybrid with MoE ffns (phase 5e): jamba-v0.1-52b at full width, one
# unit of its pattern deep (8 layers: 7 mamba, 1 attention, 4 MoE ffns;
# 13.26 B parameters; the whole model's 95.8 GiB does not fit the card),
# 4 prompts of 2,048 tokens and 32 greedy tokens
HYB_ARCH, HYB_BATCH, HYB_PROMPT, HYB_GEN = "jamba-v0.1-52b", 4, 2048, 32
# training (phase 6a): starcoder2-7b at full width cut to 8 of its 32
# layers (2.87 B parameters, bf16, AdamW), 6 steps on SyntheticSource
# batches of 4 x 2,048 tokens (seed 0)
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = \
    "starcoder2-7b", 8, 4, 2048, 6
# AdamW's learning rate there: a thirtieth of the reference's default
# 3e-4, as in the first steps of a warmup.  The reference has no warmup,
# and Adam's first steps move every weight by about lr whatever its
# gradient, so each output of a layer of fan-in 4,608 moves by up to
# ~4,608 lr.  On an H100 (PERF.md §6, tools/train_lr_sweep.py) the
# loss over 6 steps rose at 3e-4 (11.61 to 13.28, through 41.52) and
# swung at 3e-5 (11.61, 17.81, ..., 15.36); it fell at 1e-5 (11.61 to
# 9.90) and barely at 3e-6 (to 11.16).  The rise at 3e-4 is the
# reference's own dynamics, not the kernels' or bf16's: a float32 copy
# on the torch backend (no kernel) read 11.61, 20.87, 13.63 there, the
# bf16 cuda run 11.61, 20.74, 13.64.  At 1e-5 a bf16 weight takes the
# update only where it exceeds half an ulp, |w| below ~3.9e-3 (and
# embedding rows of tokens outside the batch get none): steps 0 and 1
# changed 23.3% and 15.3% of the parameter elements (92.5% and 89.5% at
# 3e-4), so the loss's fall checks those updates and not the rest.  The
# reference updates a bf16 parameter the same way (ROADMAP, limits).
TRAIN_LR = 1e-5
# step 0's loss and grad norm on cuda against the torch backend, the same
# weights and batch.  The backends differ in attention only: the kernels
# keep a float32 accumulator and differentiate by the hand-written
# backward, the reference's chunked schedule keeps a bf16 accumulator and
# goes through autograd.  Those roundings are unbiased and move each
# layer's attention by a few 2^-9 of it; over 8 layers they move a mean of
# 32,768 cross-entropies (~10.8 nats) by far less than TRAIN_LOSS_RTOL of
# it, and the norm of 2.87 B gradients, most of them in the embedding,
# head and MLPs, by far less than TRAIN_GNORM_RTOL.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 2e-3, 2e-2
L2_FLUSH_BYTES = 256 << 20
HOST_LEAD_CYCLES = 500_000      # ~0.25 ms at the H100's 1.98 GHz
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Wall time of one step that ends in a device synchronize."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.s = time.perf_counter() - self.t0


def median_ms(torch, fn, reps: int, flush) -> float:
    """Median of ``reps`` launches, each timed by CUDA events with a cold
    L2 (the main path meets these inputs once per sweep or batch).  The
    card idles ``HOST_LEAD_CYCLES`` after the flush, so that a wrapper's
    host work before its launch (tens of µs through ctypes and checks)
    falls before the first event and a kernel of a few µs is timed
    alone."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def outputs(x) -> tuple:
    """A kernel's outputs as a tuple (the chained kernels return one)."""
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(torch, got, want) -> float:
    """The largest |got - want| over the outputs; raises unless every
    output is bit-identical (same shape, dtype and bits)."""
    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype mismatch {a.shape} {a.dtype} "
                                 f"vs {b.shape} {b.dtype}")
        wide = torch.float64 if a.dtype.is_floating_point else torch.int64
        err = max(err, float((a.to(wide) - b.to(wide)).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"outputs differ from the plain version "
                                 f"(max abs err {err})")
    return err


def bound(bytes_moved: int, ops: int, ops_per_s=CUDA_CORE_OPS_PER_S):
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def check_kernel(torch, args, flush, name, source, replaces, launches, fn,
                 plain, moved, ops, library=None, plain_reps=None,
                 **shape) -> dict:
    """Hold a kernel against its plain version on the same inputs (bit for
    bit), then time both and the library yardstick (the plain version over
    ``plain_reps`` launches where it is too slow for ``--reps``)."""
    got, want = outputs(fn()), outputs(plain())
    torch.cuda.synchronize()
    try:
        err = max_abs_err(torch, got, want)
    except AssertionError as exc:
        raise AssertionError(f"{name}: {exc}") from None
    b_ms, b_by = bound(moved + nbytes(*got), ops)
    rec = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=launches, max_abs_err=err,
               ms=median_ms(torch, fn, args.reps, flush),
               plain_ms=median_ms(torch, plain, plain_reps or args.reps,
                                  flush),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=(None if library is None else
                           median_ms(torch, library, args.reps, flush)),
               shape=shape)
    log(f"[kernel] {name}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
        f"bound {b_ms:.4f} by {b_by}, library {rec['library_ms']}) "
        f"bit-exact, {launches} launches on its path | {shape}")
    return rec


# The five row kernels (the two fused ones of repair.cu, the three chained
# ones of csr_relax.cu) against their plain versions, bit for bit, on
# packs the main path does not reach: name, pack (an RMAT graph's, skewed
# with hub sources and vacant rows, or (n, R) of a random pack), K, tile
# rows (None: R is no multiple of 32, which the fused kernels' tiles
# refuse, so only the chained kernels run, on their slot-by-slot path),
# and whether ell_src and the side array are views 4 bytes into a buffer
# (the kernels then load slot by slot; aligned K = 8 packs with whole
# warps of rows take the warp-loaded path).  vals[n] is a sentinel that
# is no identity (12345, 0.5), so a padding slot dropped instead of
# taking vals[n] shows; every case runs on two draws of vals, each launch
# into outputs filled with junk (junk_outputs).
ROW_CASES = [
    ("rmat, K 8, tiles of 128", "rmat", 8, 128, False),
    ("one tile", (50, 128), 8, 128, False),
    ("K 4, tiles of 256", (3000, 256 * 37), 4, 256, False),
    ("K 16, tiles of 128", (2000, 128 * 9), 16, 128, False),
    ("K 16, tiles of 512", (3000, 512 * 11), 16, 512, False),
    ("K 8, tiles of 512", (5000, 512 * 13), 8, 512, False),
    ("misaligned views", (3000, 128 * 20), 8, 128, True),
    ("K 8, R no multiple of 32", (3000, 256 * 10 + 13), 8, None, False),
]
ROW_SENTINELS = (12345, 0.5)
ROW_KERNELS = ("fused_relax_rows", "fused_spmv_rows", "relax_rowmin",
               "spmv_rowsum", "relax_rowargmin")
GRAPH_KERNELS = ROW_KERNELS + ("merge_pool_sorted",)


def row_pack(torch, repro_torch, pack, K, scale):
    """(n, ell_src, ell_w, row2dst) of a case on the card.  A random pack
    fills each row's first c ~ U[0, K] slots (c = 0: a vacant row, at the
    end with row2dst n, as a real pack keeps them) and pads the rest with
    src n, w 0."""
    import numpy as np
    if pack == "rmat":
        from repro_torch.kernels.ell import pack_ell
        n, edges, w = repro_torch.rmat_graph(scale, DEGREE, seed=5)
        g = repro_torch.graph.from_csr(repro_torch.build_csr(
            n, edges, w, device=DEV), 4)
        ell = pack_ell(g, k=K)
        return n, ell.ell_src, ell.ell_w, ell.row2dst
    n, R = pack
    rng = np.random.default_rng(n + R + K)
    fill = np.sort(rng.integers(0, K + 1, R))[::-1]
    live = np.arange(K)[None, :] < fill[:, None]
    src = np.where(live, rng.integers(0, n, (R, K)), n).astype(np.int32)
    w = np.where(live, rng.integers(1, 50, (R, K)), 0).astype(np.int32)
    r2d = np.where(fill > 0, np.sort(rng.integers(0, n, R)), n)
    return n, *(torch.from_numpy(x.astype(np.int32)).to(DEV)
                for x in (src, w, r2d))


def row_vals(torch, n, seed):
    """int vals (30% unreached) and float vals (20% zero), each with the
    non-identity sentinel of ROW_SENTINELS at slot n."""
    import numpy as np
    from repro_torch.graph.csr import INF_W
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1000, n + 1).astype(np.int32)
    v[:n][rng.random(n) < 0.3] = INF_W
    f = (rng.random(n + 1) / n).astype(np.float32)
    f[:n][rng.random(n) < 0.2] = 0.0
    v[n], f[n] = ROW_SENTINELS
    return (torch.from_numpy(v).to(DEV), torch.from_numpy(f).to(DEV))


@contextlib.contextmanager
def junk_outputs(torch):
    """Inside the block ``torch.empty`` (with which the kernel wrappers
    allocate their outputs) hands out tensors filled with -7, so an output
    that a launch leaves unwritten shows as junk, not as an earlier
    launch's right answer in reused memory."""
    empty = torch.empty
    torch.empty = lambda *a, **k: empty(*a, **k).fill_(-7)
    try:
        yield
    finally:
        torch.empty = empty


class RowMismatch(AssertionError):
    """Graph kernels (the row kernels, the merge) that differ from their
    plain versions; ``failed`` maps each to its first difference."""

    def __init__(self, failed: dict):
        super().__init__("; ".join(f"{k}, {v}" for k, v in failed.items()))
        self.failed = failed


def row_launches(torch, FK, CK, src, w, r2d, n, bt, vals, fvals) -> dict:
    """{name: (kernel, plain)} of the row kernels on one pack, the fused
    ones only where ``bt`` tiles it.  relax_rowargmin's targets are the
    row minima, plus one on every third row, so some rows reach them and
    others miss."""
    rmin = CK.relax_rowmin_plain(src, w, vals)
    tgt = torch.where(torch.arange(src.shape[0], device=DEV) % 3 == 0,
                      rmin + 1, rmin)
    out = {
        "relax_rowmin": (lambda: CK.relax_rowmin(src, w, vals),
                         lambda: rmin),
        "spmv_rowsum": (lambda: CK.spmv_rowsum(src, fvals),
                        lambda: CK.spmv_rowsum_plain(src, fvals)),
        "relax_rowargmin": (
            lambda: CK.relax_rowargmin(src, w, vals, tgt, n=n),
            lambda: CK.relax_rowargmin_plain(src, w, vals, tgt, n)),
    }
    if bt is not None:
        out["fused_relax_rows"] = (
            lambda: FK.fused_relax_rows(src, w, vals, block=bt),
            lambda: FK.fused_relax_rows_plain(src, w, vals, bt))
        out["fused_spmv_rows"] = (
            lambda: FK.fused_spmv_rows(src, r2d, fvals, block=bt),
            lambda: FK.fused_spmv_rows_plain(src, r2d, fvals, bt))
    return out


def check_rows(torch, repro_torch, FK, CK, scale=16,
               kernels=ROW_KERNELS) -> list:
    """ROW_CASES through the row kernels in ``kernels`` against their
    plain versions; raises RowMismatch naming every kernel that differs.
    Returns a line a case."""
    lines, failed = [], {}
    for name, pack, K, block, misaligned in ROW_CASES:
        n, src, w, r2d = row_pack(torch, repro_torch, pack, K, scale)
        R = src.shape[0]
        bt = block and FK._row_block("fused_relax_rows", R, block)
        if misaligned:
            def view(x):
                buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=DEV)
                return buf[1:].view(x.shape).copy_(x)
            src, w, r2d = view(src), view(w), view(r2d)
        for seed in (1, 2):
            vals, fvals = row_vals(torch, n, seed + K)
            launches = row_launches(torch, FK, CK, src, w, r2d, n, bt, vals,
                                    fvals)
            ran = [k for k in kernels if k in launches]
            for kname in ran:
                if kname in failed:
                    continue
                fn, plain = launches[kname]
                with junk_outputs(torch):
                    got = fn()
                try:
                    max_abs_err(torch, outputs(got), outputs(plain()))
                except AssertionError as exc:
                    failed[kname] = f"{name}: {exc}"
        tiles = f"tile {bt}, {R // bt} tiles" if bt else "no tile"
        lines.append(f"{name}: n={n} R={R} K={K} {tiles}, "
                     f"{', '.join(ran)} bit-exact on 2 draws")
    if failed:
        raise RowMismatch(failed)
    return lines


# merge_pool_sorted against its plain version, bit for bit, on lists the
# main path does not give it: its own merges draw batch keys that miss the
# pool, so no tie there has rows that differ, and D is far from a tile's
# edge.  name, D, B, pool rows used, batch rows used (the rest of each
# list is vacant: (n, 0, 0, dead)), the share of the batch's keys taken
# from the pool's (ties, with their own w and alive), and where the
# batch's keys lie: None (among the pool's), "before" or "after" every
# pool key, or "negative" (pool sources in [-n, n), as an unchecked
# session's pool can hold), with the batch's sources there too.  T is the
# kernel's tile of output slots (``repair.MERGE_TILE``; check_merge holds
# the two equal).
T = MERGE_TILE = 1024
MERGE_CASES = [
    ("heavy ties", 3000, 1000, 2000, 1000, 0.5, None),
    ("D 1, B 1", 1, 1, 1, 1, 0.0, None),
    ("D 1, B 1, the batch row first", 1, 1, 1, 1, 0.0, "before"),
    ("D T - 1", T - 1, 500, 1500, 400, 0.25, None),
    ("D T", T, 500, 1500, 500, 0.25, None),
    ("D T + 1", T + 1, 700, 1400, 700, 0.25, None),
    ("D 3T + 5", 3 * T + 5, 3000, 3000, 2500, 0.25, None),
    ("B > T", 9000, 5000, 4000, 5000, 0.5, None),
    ("B > D", 100, 3000, 40, 3000, 0.25, None),
    ("pool all vacant", 4096, 1000, 0, 1000, 0.0, None),
    ("batch before the pool", 5000, 1000, 3000, 1000, 0.0, "before"),
    ("batch after the pool", 5000, 1000, 3000, 1000, 0.0, "after"),
    ("negative pool source ids", 5000, 2000, 3000, 2000, 0.25, "negative"),
    ("many tiles", 40000, 8192, 30000, 8000, 0.5, None),
]
MERGE_N = 5000


def merge_case(np, seed, D, B, pool_used, batch_used, ties, where,
               n=MERGE_N) -> list:
    """The eight input arrays (pool src, dst, w, alive; batch src, dst, w,
    alive) of one MERGE_CASES entry, as numpy arrays, each list sorted by
    (src, dst) with its vacant rows at the end."""
    rng = np.random.default_rng(seed)
    half = {"before": ((n // 2, n), (0, n // 2)),
            "after": ((0, n // 2), (n // 2, n)),
            "negative": ((-n, n), (-n, n))}
    (pl, ph), (bl, bh) = half.get(where, ((0, n), (0, n)))
    pk = rng.permutation(np.unique(rng.integers(
        pl * n, ph * n, 2 * pool_used + 1)))[:pool_used]
    tie = rng.choice(pk, min(int(batch_used * ties), pk.shape[0]),
                     replace=False)
    new = np.unique(rng.integers(bl * n, bh * n, 2 * batch_used + 1))
    new = rng.permutation(new[~np.isin(new, pk)])[:batch_used - len(tie)]
    fk = np.concatenate([tie, new])

    def rows(keys, size):
        keys = np.sort(keys)[:size]
        used = np.arange(size) < keys.shape[0]
        k = np.concatenate([keys, np.zeros(size - keys.shape[0], np.int64)])
        return [np.where(used, np.floor_divide(k, n), n).astype(np.int32),
                np.where(used, np.mod(k, n), 0).astype(np.int32),
                np.where(used, rng.integers(1, 50, size), 0).astype(np.int32),
                used & (rng.random(size) < 0.8)]

    return rows(pk, D) + rows(fk, B)


def check_merge(torch, FK, cases=MERGE_CASES) -> list:
    """``cases`` through merge_pool_sorted against its plain version, bit
    for bit, each launch into outputs filled with junk; raises RowMismatch
    naming merge_pool_sorted at the first case that differs.  Returns a
    line a case."""
    import numpy as np
    if FK.MERGE_TILE != MERGE_TILE:
        raise AssertionError(f"MERGE_CASES are cut for tiles of "
                             f"{MERGE_TILE} slots, the kernel's are "
                             f"{FK.MERGE_TILE}")
    lines = []
    for i, (name, D, B, pool_used, batch_used, ties, where) in \
            enumerate(cases):
        arrays = [torch.from_numpy(x).to(DEV) for x in merge_case(
            np, i, D, B, pool_used, batch_used, ties, where)]
        with junk_outputs(torch):
            got = FK.merge_pool_sorted(*arrays, n=MERGE_N)
        want = FK.merge_pool_sorted_plain(*arrays, MERGE_N)
        torch.cuda.synchronize()
        try:
            max_abs_err(torch, got, want)
        except AssertionError as exc:
            raise RowMismatch({"merge_pool_sorted": f"{name}: {exc}"}) \
                from None
        ties_n = int(torch.isin(arrays[4].long() * MERGE_N + arrays[5],
                                arrays[0].long() * MERGE_N + arrays[1])
                     [:batch_used].sum())
        lines.append(f"{name}: D={D} B={B}, {pool_used} pool and "
                     f"{batch_used} batch rows used, {ties_n} ties, "
                     f"bit-exact")
    return lines


def merge_batch(torch, np, g, n) -> list:
    """An admitted batch of BATCH fresh edges for the pool of ``g`` (keys
    that miss the pool, sorted, all alive), as the main path merges
    one."""
    rng = np.random.default_rng(2)
    pool_keys = (g.d_src.long() * n + g.d_dst.long()).cpu().numpy()
    fk = np.unique(rng.integers(0, n, size=2 * BATCH) * np.int64(n)
                   + rng.integers(0, n, size=2 * BATCH))
    fk = fk[~np.isin(fk, pool_keys)][:BATCH]
    if fk.shape[0] != BATCH:
        raise AssertionError(f"drew {fk.shape[0]} fresh edges, wanted "
                             f"{BATCH}")
    fresh = [torch.from_numpy(x.astype(np.int32)).to(DEV)
             for x in (fk // n, fk % n, rng.integers(1, 100, size=BATCH))]
    fresh.append(torch.ones(BATCH, dtype=torch.bool, device=DEV))
    return fresh


def merge_ops(D: int) -> int:
    """The merge kernel's operations: a lexicographic compare (4 integer
    operations) for each output slot, and log2(T) more for each thread's
    split inside its tile of T slots, 8 slots a thread (the two warp
    searches a tile are a few hundred more)."""
    return 4 * D * (8 + MERGE_TILE.bit_length() - 1) // 8


def warp_loaded(mod, rec, ell_src, ell_w=None) -> None:
    """A row kernel with a warp-loaded path (the fused ones of ``FK``, the
    chained ones of ``CK``) must take it at the main path's shapes; its
    record names the path."""
    if not mod.warp_loads(ell_src, ell_w):
        raise AssertionError(f"{rec['name']}: the main path's slots do not "
                             f"take the warp-loaded path")
    rec["variant"] = "warp-loaded slots, smallest shared-memory carveout"


class Launches:
    """Every kernel module's launch counts, reset and read together: the
    tables each module registers in ``_build.LAUNCH_TABLES``, which the
    captured segments' tallies read too."""

    def __init__(self, build):
        self.build = build

    def reset(self):
        self.build.reset_all_launches()

    def read(self) -> dict:
        return self.build.all_launches()


def run_path(repro_torch, csr, stream, backend, static, step, clock,
             per_batch_driver=False):
    """Bind, prepare, the static run, then the stream; returns the
    session, the final props and the three wall times.  With
    ``per_batch_driver`` the session's stream goes through
    ``Engine.run_stream``, the per-batch baseline, instead of the fused
    executor (a reference independent of the captured graphs)."""
    sess = repro_torch.bind_graph(csr, backend=backend,
                                  capacity=2 * stream.num_adds, device=DEV)
    if per_batch_driver:
        from repro_torch.core.engine import Engine
        eng = sess.engine
        eng.run_stream = functools.partial(Engine.run_stream, eng)
    with clock() as t_prep:
        sess.handle                             # prepare: pool + ELL pack
    with clock() as t_static:
        props = sess.call(*static)
    with clock() as t_stream:
        props = sess.run_stream(stream, BATCH, step, props)
    return sess, props, (t_prep.s, t_static.s, t_stream.s)


def drive(torch, repro_torch, counts, csr, stream, tag, backend, static,
          step, clock, launched=(), silent=(), per_batch=None,
          per_batch_driver=False):
    """One path in a window of its own: every launch count and the peak
    memory reset just before it, the counts read just after; prints its
    times and launches and checks which kernels it ran."""
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    sess, props, times = run_path(repro_torch, csr, stream, backend, static,
                                  step, clock, per_batch_driver)
    launches = counts.read()
    if sess.backend_name != backend or sess.health.failovers:
        raise AssertionError(f"[{tag}] the session left {backend}: now on "
                             f"{sess.backend_name}, "
                             f"{sess.health.failovers} failovers")
    WINDOWS[tag], TIMES[tag] = launches, times
    ups = (stream.num_adds + stream.num_dels) / times[2]
    log(f"[{tag}] prepare {times[0]:.3f} s | static {times[1]:.3f} s | "
        f"stream {times[2]:.3f} s ({ups:.0f} updates/s) | launches "
        f"{ {k: v for k, v in launches.items() if v} } | peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(launches, launched, tuple(silent) + ("flash_attention",),
            per_batch)
    return sess, props, launches


def require(launches, launched=(), silent=(), per_batch=None):
    for name in launched:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on its path")
    for name in silent:
        if launches[name]:
            raise AssertionError(f"kernel {name} launched {launches[name]} "
                                 f"times on a path that must not use it")
    if per_batch is not None and launches["merge_pool_sorted"] != per_batch:
        raise AssertionError(f"merge_pool_sorted launched "
                             f"{launches['merge_pool_sorted']} times for "
                             f"{per_batch} add batches")


def profile_window(torch, tag, fn):
    """``fn()`` under torch.profiler: device time by kernel and the
    device's busy share of the window's wall time (kernel rows only: an
    operator's row repeats its kernels' time).  Returns fn's result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    rows = [r for r in avgs if r.device_type != DeviceType.CPU]
    dev_us = lambda r: getattr(r, "self_device_time_total",
                               getattr(r, "self_cuda_time_total", 0))
    busy = sum(dev_us(r) for r in rows) / 1e6
    launches = sum(r.count for r in rows)
    # host syncs: the runtime's stream synchronizations (each device-to-
    # host read and each copy from pageable host memory waits on one),
    # less the window's own closing synchronize
    calls = {r.key: r.count for r in avgs if r.device_type == DeviceType.CPU}
    syncs = calls.get("cudaStreamSynchronize", 0) + \
        calls.get("cudaDeviceSynchronize", 0) - 1
    log(f"[profile] {tag}: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%), {launches} kernel launches of "
        f"{len(rows)} kinds, {syncs} host syncs "
        f"({calls.get('aten::_local_scalar_dense', 0)} scalar reads)")
    for r in sorted(rows, key=dev_us, reverse=True)[:12]:
        log(f"[profile]   {dev_us(r) / 1e3:10.2f} ms  {r.count:6d} calls"
            f"  {r.key[:100]}")
    return out


def profile_path(torch, repro_torch, csr, stream, static, step, tag):
    """A cuda path once more under torch.profiler: the static run, then
    the stream."""
    sess = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=2 * stream.num_adds, device=DEV)
    sess.handle
    props = profile_window(torch, f"{tag} static", lambda: sess.call(*static))
    profile_window(torch, f"{tag} stream", lambda: sess.run_stream(
        stream, BATCH, step, props))
    del sess


def edges_after(torch, csr, stream, n):
    """(src, dst, w) of (base − dels) ∪ adds as host arrays, built on the
    card with int64 key arithmetic (on the host, numpy's isin and unique
    over 65M keys take minutes)."""
    dels = torch.from_numpy(stream.dels).to(DEV).long()
    a = torch.from_numpy(stream.adds).to(DEV)
    keep = ~torch.isin(csr.src.long() * n + csr.dst,
                       dels[:, 0] * n + dels[:, 1])
    s = torch.cat([csr.src[keep], a[:, 0]])
    d = torch.cat([csr.dst[keep], a[:, 1]])
    ww = torch.cat([csr.w[keep], a[:, 2].clamp(min=1)])
    k2 = s.long() * n + d
    if torch.unique(k2).numel() != k2.numel():
        raise AssertionError("post-update edge set has duplicate keys")
    return tuple(x.cpu().numpy() for x in (s, d, ww))


def dijkstra_dist(np, edges, n, inf_w):
    """scipy's Dijkstra from vertex 0."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    s, d, w = edges
    g = csr_matrix((w.astype(np.float64), (s, d)), shape=(n, n))
    dist = dijkstra(g, directed=True, indices=0)
    return np.where(np.isinf(dist), inf_w, dist).astype(np.int64)


def pagerank_f64(np, edges, n, delta, tol=1e-13, max_iter=1000):
    """The fixed point of the port's PageRank (pr = (1-delta)/n + delta ·
    sum over in-edges of pr[u]/outdeg[u], dangling mass dropped), by a
    float64 power iteration with scipy, to an L1 step below ``tol``."""
    from scipy.sparse import csr_matrix
    s, d, _ = edges
    outdeg = np.bincount(s, minlength=n).astype(np.float64)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    pull = csr_matrix((np.ones(s.shape[0]), (d, s)), shape=(n, n))
    x = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        nxt = (1.0 - delta) / n + delta * (pull @ (x * inv))
        step = np.abs(nxt - x).sum()
        x = nxt
        if step < tol:
            break
    return x


def close_enough(torch, got, want, atol: float, rtol: float = 0.0) -> float:
    """The largest |got - want|; raises unless every element lies within
    atol + rtol * |want| (same shape and dtype)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype mismatch {got.shape} {got.dtype} "
                             f"vs {want.shape} {want.dtype}")
    d = (got.double() - want.double()).abs()
    err = float(d.max())
    if not bool((d <= atol + rtol * want.double().abs()).all()):
        raise AssertionError(f"max abs err {err} beyond atol {atol} + rtol "
                             f"{rtol}")
    return err


# flash_attention against its plain version: the LM prefill's shape first
# (B * heads, prompt, dh), then the small shapes of tests/test_kernels.py.
# Tolerances are that file's (Pallas interpret vs the XLA oracle), but
# float32 takes 2e-5 for 1e-5: the kernel's expf and its per-tile sums
# against torch.exp and cuBLAS's order in the plain version.  bf16 is
# also held relative to the values: at the prefill's shape a causal row i
# averages v over i + 1 keys, so most outputs are ~0.03-0.05 and the flat
# 3e-2 would let a wrong rescale or a dropped tile through.  Both versions
# keep float32 state and round P to bf16 (each p_j to within 2^-9 of
# itself, against a running max that differs with the tiling) and the
# output once, so for an output o = sum_j p_j v_j / l
#     |got - want| <= 2^-8 * A + 2^-7 * |want|,  A = sum_j p_j |v_j| / l
# (A: the attention of |v|).  The limit doubles both terms, and the
# normwise ||got - want|| / ||want|| must stay below 1e-2.
BF16_REL = (2.0 ** -7, 2.0 ** -6, 1e-2)  # times A, times |want|, normwise
FLASH_CASES = [  # shape, dtype, causal, softcap, atol, rtol
    ((LM_BATCH * 36, LM_PROMPT, 128), "bfloat16", True, None, 3e-2, 0.0),
    ((2, 256, 128), "float32", True, None, 2e-5, 0.0),
    ((2, 256, 128), "float32", False, None, 2e-5, 0.0),
    ((2, 512, 64), "bfloat16", True, None, 3e-2, 0.0),
    ((2, 256, 256), "float32", True, 30.0, 1e-5, 1e-4),
    ((2, 1, 128), "bfloat16", True, None, 3e-2, 0.0),      # one row
    ((3, 100, 128), "bfloat16", False, None, 3e-2, 0.0),   # under one tile
    ((2, 256, 128), "bfloat16", True, 30.0, 3e-2, 0.0),
]
# the window (causal only), on both kernels: shape, dtype, window,
# softcap, atol, rtol.  W = 128 and 127 at S = 640 leave the last rows of
# a 128-row q tile their whole first KV tile masked (the tensor-core
# kernel's NaN hazard), W = 127 the same for the CUDA cores' 16-row tiles
# of 32 keys, and W = 63 and 64 for dh 256's 64-key tiles (rows 190-255
# and 191-255 of the q tile from row 128 have all of keys 64-127 masked);
# with W = 127 or 200 a q tile's lower edge spans two KV tiles, and at
# W = 200 and S = 600 the q tile from row 384 has its second lower-edge
# tile below the diagonal one (rows 384-511 need keys of tile 2 masked);
# W >= S masks nothing more than causal does.
WINDOW_FLASH_CASES = [
    ((2, 640, 128), "bfloat16", 128, None, 3e-2, 0.0),
    ((2, 600, 128), "bfloat16", 200, 30.0, 3e-2, 0.0),
    ((2, 300, 64), "bfloat16", 1, None, 3e-2, 0.0),
    ((2, 640, 64), "bfloat16", 127, None, 3e-2, 0.0),
    ((2, 300, 256), "bfloat16", 127, 50.0, 3e-2, 0.0),
    ((2, 640, 256), "bfloat16", 63, None, 3e-2, 0.0),
    ((2, 640, 256), "bfloat16", 64, 50.0, 3e-2, 0.0),
    ((2, 300, 128), "float32", 127, None, 2e-5, 0.0),
    ((2, 300, 256), "float32", 300, 30.0, 1e-5, 1e-4),
]
# cuda vs torch prefill logits at full depth.  The backends differ only
# in prefill attention: the kernel keeps a float32 accumulator, the
# reference's chunked schedule a bf16 one, and 32 layers carry that bf16
# rounding into the residual stream.
LM_LOGIT_TOL = 0.25            # times the std of the torch logits
# cuda vs the same model with the kernel's plain version in its place (the
# kernel's own contract: float32 state, one rounding to bf16).  Each layer
# is held to BF16_REL on its own inputs.  End to end, 32 layers of random
# weights carry an ulp that two bf16 roundings put apart to ~0.1 of the
# logits' std (0.098 on an H100), so the yardstick is the plain version
# against itself with its sums in another order (256-key KV blocks for
# 512): the kernel's mean |d| may be at most LM_PLAIN_MEAN times that, and
# its max within LM_LOGIT_TOL std.
LM_PLAIN_MEAN = 2.0


def bf16_err(FA, got, want, q, k, v, **kw) -> tuple:
    """A bf16 attention output against its plain version on q, k, v: the
    largest share of the elementwise limit of BF16_REL, the normwise error,
    and the largest share of a value-only limit, 2e-3 + 1.6e-2 * |want|
    (two ulps of the value), which leaves out P's rounding."""
    c_abs, c_want, _ = BF16_REL
    A = FA.flash_attention_plain(q, k, v.abs(), **kw).double()
    d, w = (got.double() - want.double()).abs(), want.double()
    return (float((d / (c_abs * A + c_want * w.abs())).max()),
            float(d.norm() / w.norm()),
            float((d / (2e-3 + 1.6e-2 * w.abs())).max()))


def bf16_rel(FA, got, want, q, k, v, **kw) -> tuple:
    """bf16_err, raising beyond BF16_REL."""
    err = bf16_err(FA, got, want, q, k, v, **kw)
    if not (err[0] <= 1.0 and err[1] <= BF16_REL[2]):
        raise AssertionError(f"beyond {BF16_REL[0]} * A + {BF16_REL[1]} * "
                             f"|want| ({err[0]:.3f} of it) or normwise "
                             f"{BF16_REL[2]} ({err[1]:.3e})")
    return err


def prefill_with(model, prompts, FA, attend, src=None):
    """The model's prefill with ``attend`` in the flash kernel's place
    (the model reaches the kernel through the module)."""
    real = FA.flash_attention
    FA.flash_attention = attend
    try:
        return model.prefill_step(prompts, src)[0]
    finally:
        FA.flash_attention = real


def layer_count(cfg, spec) -> int:
    """The parameters the reference's ``init_layer`` makes for one layer
    (``repro/models/layers.py`` ``init_attn`` / ``init_mlp`` /
    ``init_moe``, ``repro/models/ssm.py`` ``init_mamba`` / ``init_mlstm``
    / ``init_slstm``), norm scales included."""
    D, H, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.dh
    m, f = spec["mixer"], spec["ffn"]
    if m == "mamba":
        E, N, K = cfg.mamba.expand * D, cfg.mamba.d_state, cfg.mamba.d_conv
        # ln, in_proj, conv_w, conv_b, x_bc, x_dt, dt_bias, A_log, skip_d,
        # out_proj
        n = D + 2 * D * E + K * E + E + 2 * E * N + E + E + E * N + E + E * D
    elif m == "mlstm":
        E = 2 * D
        n = D + 3 * D * E + 2 * D * H + D * E + E * D
    elif m == "slstm":
        n = D + 8 * D * D + 4 * D + D * D
    else:
        n = 2 * D * H * dh + 2 * D * kv * dh + D
        if cfg.qkv_bias:
            n += H * dh + 2 * kv * dh
        if cfg.attn_softcap is not None:
            n += D
    if f == "mlp":
        n += 3 * D * cfg.d_ff + D
    elif f == "moe":
        E = cfg.moe.n_experts
        n += D + D * E + 3 * E * D * cfg.moe.d_ff
    return n


def init_count(cfg) -> int:
    """The parameters the reference's ``init_params`` makes.
    ``ArchConfig.param_count`` leaves out the norm scales (``ln``,
    gemma2's ``post_ln``, the final and encoder norms) and Mamba's biases,
    ``A_log`` and skip, and counts an xattn gate projection that
    ``init_attn`` never makes."""
    D = cfg.d_model
    total = cfg.vocab * D * (1 if cfg.tie_embeddings else 2) + D
    total += cfg.repeat * sum(layer_count(cfg, s) for s in cfg.pattern)
    if cfg.enc_layers:
        total += cfg.enc_layers * layer_count(
            cfg, {"mixer": "attn_bidir", "ffn": "mlp"}) + D
    return total


def check_flash(torch, args, flush, FA, launches) -> dict:
    """The flash kernel against its plain version at FLASH_CASES, timed at
    the prefill's shape with the plain version and SDPA beside it."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    errs = []
    for i, (shape, dt, causal, cap, atol, rtol) in enumerate(FLASH_CASES):
        q, k, v = (torch.randn(shape, generator=gen, device=DEV).to(
            getattr(torch, dt)) for _ in range(3))
        got = FA.flash_attention(q, k, v, causal=causal, softcap=cap)
        want = FA.flash_attention_plain(q, k, v, causal=causal, softcap=cap)
        torch.cuda.synchronize()
        rel = ""
        try:
            errs.append(close_enough(torch, got, want, atol, rtol))
            if dt == "bfloat16":
                ratio, norm, ulps = bf16_rel(FA, got, want, q, k, v,
                                             causal=causal, softcap=cap)
                rel = (f"; {ratio:.3f} of the elementwise limit, normwise "
                       f"{norm:.3e}, {ulps:.3f} of two ulps of the value")
        except AssertionError as exc:
            raise AssertionError(f"flash_attention {shape} {dt}: {exc}") \
                from None
        log(f"[flash] {shape} {dt} causal={causal} softcap={cap}: max abs "
            f"err {errs[-1]:.3e} (atol {atol}, rtol {rtol}){rel}")
        if i == 0:
            prefill_qkv = (q, k, v)
        del got, want
    for shape, dt, window, cap, atol, rtol in WINDOW_FLASH_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=DEV).to(
            getattr(torch, dt)) for _ in range(3))
        kw = dict(causal=True, softcap=cap, window=window)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        rel = ""
        try:
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("an output is not finite")
            err = close_enough(torch, got, want, atol, rtol)
            if dt == "bfloat16":
                ratio, norm, ulps = bf16_rel(FA, got, want, q, k, v, **kw)
                rel = f"; {ratio:.3f} of the elementwise limit"
        except AssertionError as exc:
            raise AssertionError(f"flash_attention {shape} {dt} window "
                                 f"{window}: {exc}") from None
        log(f"[flash] {shape} {dt} window={window} softcap={cap}: max abs "
            f"err {err:.3e} (atol {atol}, rtol {rtol}){rel}, all finite")
    q, k, v = prefill_qkv
    BH, S, dh = q.shape
    # the causal half of 4 * S^2 * dh * BH, on the bf16 tensor cores
    flop = 2 * S * S * dh * BH
    b_ms, b_by = bound(nbytes(q, k, v, q), flop, TENSOR_BF16_OPS_PER_S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:65",
               launches=launches, max_abs_err=errs[0],
               ms=median_ms(torch, lambda: FA.flash_attention(q, k, v),
                            args.reps, flush),
               plain_ms=median_ms(torch, lambda: FA.flash_attention_plain(
                   q, k, v), 5, flush),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=median_ms(torch, lambda: sdpa(
                   q[None], k[None], v[None], is_causal=True), args.reps,
                   flush),
               shape=dict(BH=BH, S=S, dh=dh, dtype="bfloat16", causal=True))
    rec["sdpa_ratio"] = rec["ms"] / rec["library_ms"]
    rec["tflops"] = flop / rec["ms"] / 1e9
    log(f"[kernel] flash_attention: {rec['ms']:.4f} ms (plain "
        f"{rec['plain_ms']:.4f}, bound {b_ms:.4f} by {b_by}, SDPA "
        f"{rec['library_ms']:.4f}; {rec['sdpa_ratio']:.2f}x SDPA, "
        f"{rec['tflops']:.1f} TFLOP/s) max abs err {errs[0]:.3e}, "
        f"{launches} launches in the prefill | {rec['shape']}")
    return rec


def attention_copies_ms(torch, args, cfg) -> float:
    """Device time of one layer's copies around the flash kernel at the
    prefill's shapes, as ``models/layers.py`` makes them: k and v repeated
    to every head (``repeat_kv``), q, k and v moved to (B * H, S, dh), and
    the output moved back to (B, S, H * dh)."""
    from repro_torch.models import layers
    B, S, H, kv, dh = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv, cfg.dh
    gen = torch.Generator(device=DEV).manual_seed(4)
    q = torch.randn((B, S, H, dh), generator=gen, device=DEV).bfloat16()
    k, v = (torch.randn((B, S, kv, dh), generator=gen, device=DEV)
            .bfloat16() for _ in range(2))
    o = torch.randn((B * H, S, dh), generator=gen, device=DEV).bfloat16()

    def copies():
        layers.to_heads(q), layers.to_heads(layers.repeat_kv(k, H // kv))
        layers.to_heads(layers.repeat_kv(v, H // kv))
        return o.reshape(B, H, S, dh).transpose(1, 2).reshape(B, S, H * dh)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    return median_ms(torch, copies, args.reps, flush)


def lm_phase(torch, args, counts, FA) -> dict:
    """starcoder2-7b served on the cuda backend: prefill, decode, the
    torch backend's prefill on the same weights, then the kernel check."""
    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    model, prompts = build_lm(torch, LM_ARCH, B, P, G)
    cfg = model.cfg
    logits = serve_timed(torch, counts, FA, model, prompts, None, P, G,
                         "lm", cfg.n_layers, long_mode=False)
    if args.profile:
        from repro_torch.launch import serve
        logits_p, caches = profile_window(
            torch, "lm prefill (warm)",
            lambda: serve.prefill(model, prompts, P + G))
        profile_window(torch, f"lm decode ({G - 1} steps)",
                       lambda: serve.decode(model, logits_p, caches, P, G))
        del logits_p, caches
        copy_ms = attention_copies_ms(torch, args, cfg)
        log(f"[profile] repeat_kv + head transposes around the flash "
            f"kernel: {copy_ms:.4f} ms a layer, {cfg.n_layers * copy_ms:.2f}"
            f" ms a prefill (CUDA events, B={B} P={P})")

    model.backend = "torch"
    counts.reset()
    with Timer(torch) as t_ref:
        ref = model.prefill_step(prompts)[0]
    model.backend = "cuda"
    require(counts.read(), silent=["flash_attention"])
    log(f"[lm] torch backend prefill {t_ref.s:.3f} s")
    logits_against("lm", logits, ref, "torch")
    del ref
    # the kernel's contract on the main path's own inputs, then end to end
    # with the plain version in the kernel's place, beside the plain
    # version against itself over 256-key KV blocks (its sums in another
    # order)
    kinds = layer_checks(torch, FA, model, prompts, None, "lm")
    if kinds != [(True, None)] * cfg.n_layers:
        raise AssertionError(f"[lm] flash launches {kinds}, expected "
                             f"{cfg.n_layers} causal ones")
    counts.reset()
    plain = prefill_with(model, prompts, FA, FA.flash_attention_plain)
    plain256 = prefill_with(model, prompts, FA, functools.partial(
        FA.flash_attention_plain, bk=PLAIN_REORDERED))
    require(counts.read(), silent=["flash_attention"])
    logits_against("lm", logits, plain, "plain attention", yard=plain256,
                   plain_mean=True)
    del model, logits, plain, plain256, prompts
    torch.cuda.empty_cache()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    return check_flash(torch, args, flush, FA,
                       WINDOWS["lm prefill"]["flash_attention"])


# Phases 5b and 5c: gemma2-9b (windowed attention, long_mode decode) and
# whisper-large-v3 (an encoder, cross-attention), each at full width and
# depth after 5.  Phase 5 runs on the same helpers below.
#
# Limits.  Every flash launch of a prefill is held to the plain version on
# its own q, k, v by BF16_REL, as in phase 5.  whisper's logits take phase
# 5's limits as they are: no softcap, no norm after attention, and every
# attention is one KV block in the reference's schedule (1,500 and 416
# keys), so the two backends differ as starcoder2's do, by bf16 roundings
# of the accumulator.  gemma2 normalises each attention output (post_ln)
# before the residual, so an attention's rounding reaches the stream at
# full size in all 42 layers, and its global layers round the reference's
# bf16 accumulator at 7 blocks; how far 42 such layers of random weights
# carry that is not known beforehand.  So its end-to-end limits are
# yardsticks of the same kind, measured in the run: the cuda backend
# against the torch backend within LM_YARD_MEAN times (mean |d|) and
# LM_YARD_MAX times (max |d|) the torch backend against itself over
# 512-key blocks, and against the plain version in the kernel's place
# within the same multiples of the plain version against itself over
# 256-key blocks.
LM_YARD_MEAN, LM_YARD_MAX = 2.0, 3.0
TORCH_REORDERED, PLAIN_REORDERED = 512, 256     # KV blocks of the yardsticks


def build_lm(torch, arch: str, B: int, P: int, G: int, cfg=None):
    """``serve.build`` at full size, its parameters checked against the
    reference's init; given ``cfg`` (a cut of the arch), the model that
    ``serve.build`` makes, of that config."""
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    ns = serve.parser().parse_args(
        ["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
         "--gen", str(G), "--seed", "0"])
    with Timer(torch) as t_init:
        if cfg is None:
            model, prompts = serve.build(ns)
        else:
            model = Model(cfg, device=DEV)
            gen = torch.Generator(device=DEV).manual_seed(ns.seed)
            model.init(gen)
            prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                                    device=DEV)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    enc = f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers else ""
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers{enc}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv} kv, dh {cfg.dh}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab} | {n_params:,} parameters "
        f"({init_count(cfg):,} by the reference's init; "
        f"{cfg.param_count():,} by param_count), {n_bytes / 1e9:.3f} GB "
        f"{model.dtype} | init {t_init.s:.2f} s")
    if n_params != init_count(cfg) or model.backend != "cuda" or \
            model.dtype != torch.bfloat16:
        raise AssertionError(f"the model is not the full {arch} in bf16 on "
                             f"the cuda backend")
    return model, prompts


def serve_timed(torch, counts, FA, model, prompts, src, P, G, tag,
                per_prefill: int, long_mode: bool):
    """A cold prefill (``per_prefill`` flash launches, no other kernel),
    G - 1 decode steps (no launch), a warm prefill with CUDA events around
    each flash launch (their sum is the kernel's share of it), and with
    ``long_mode`` G - 1 decode steps from it in long mode; times, peak
    memory and the tokens checked in range."""
    from repro_torch.launch import serve
    B, V, steps = prompts.shape[0], model.cfg.vocab, G - 1
    clock = lambda: Timer(torch)

    def decoded(name, logits, caches, lm):
        counts.reset()
        with clock() as t:
            toks = serve.decode(model, logits, caches, P, G, src, lm)
        WINDOWS[f"{tag} {name}"] = dec = counts.read()
        require(dec, silent=list(dec))
        if toks.shape != (B, G) or not bool(((toks >= 0) & (toks < V))
                                            .all()):
            raise AssertionError(f"[{tag}] {name}: tokens out of range: "
                                 f"{toks}")
        return (f"{name} {steps} steps {t.s:.3f} s ({t.s / steps * 1e3:.2f}"
                f" ms/step, {B * steps / t.s:.1f} tok/s)", toks)

    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    with clock() as t_cold:
        logits, caches = serve.prefill(model, prompts, P + G, src)
    WINDOWS[f"{tag} prefill"] = pre = counts.read()
    if pre["flash_attention"] != per_prefill:
        raise AssertionError(f"[{tag}] flash_attention launched "
                             f"{pre['flash_attention']} times in a prefill, "
                             f"expected {per_prefill}")
    require(pre, silent=[k for k in pre if k != "flash_attention"])
    runs = [decoded("decode", logits, caches, False)]
    del caches
    spans, real = [], FA.flash_attention

    def timed(q, k, v, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        o = real(q, k, v, **kw)
        b.record()
        spans.append((a, b))
        return o

    FA.flash_attention = timed
    try:
        with clock() as t_warm:
            warm, caches = serve.prefill(model, prompts, P + G, src)
    finally:
        FA.flash_attention = real
    flash_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    if long_mode:
        runs.append(decoded("long_mode decode", warm, caches, True))
    del caches
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] prefill B={B} P={P}: cold {t_cold.s:.3f} s, warm "
        f"{t_warm.s:.3f} s ({B * P / t_warm.s:.0f} tok/s), its "
        f"{len(spans)} flash launches {flash_s:.3f} s "
        f"({flash_s / t_warm.s:.1%}, CUDA events) | "
        + " | ".join(line for line, _ in runs)
        + f" | peak {peak:.2f} GiB | launches: prefill "
        f"{ {k: v for k, v in pre.items() if v} }, decode none | warm vs "
        f"cold logits max |d| {float((warm - logits).abs().max()):.3e} | "
        f"first tokens {runs[0][1][:, :8].tolist()}")
    return logits


def layer_checks(torch, FA, model, prompts, src, tag, shapes=None) -> list:
    """Every flash launch of a prefill against the plain version on the
    same q, k, v (BF16_REL), beside the plain version over 64-key blocks
    against the same; returns each launch's (causal, window), and puts
    each launch's (q's shape, dtype) into ``shapes`` if given."""
    layer_err, layer_ref, kinds = [], [], []

    def checked(q, k, v, **kw):
        if shapes is not None:
            shapes.append((tuple(q.shape), q.dtype))
        o = real(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"[{tag}] a flash output is not finite")
        layer_err.append(bf16_rel(FA, o, want, q, k, v, **kw))
        layer_ref.append(bf16_err(FA, FA.flash_attention_plain(
            q, k, v, bk=64, **kw), want, q, k, v, **kw))
        kinds.append((kw.get("causal", True), kw.get("window")))
        return o

    real = FA.flash_attention
    prefill_with(model, prompts, FA, checked, src)
    span = lambda errs: (f"at most {max(e[0] for e in errs):.3f} of the "
                         f"elementwise limit and {max(e[2] for e in errs):.3f}"
                         f" of two ulps of the value, normwise "
                         f"{min(e[1] for e in errs):.3e}-"
                         f"{max(e[1] for e in errs):.3e}")
    log(f"[{tag}] flash_attention vs its plain version on each of "
        f"{len(kinds)} launches' own q, k, v: {span(layer_err)} | plain "
        f"over 64-key blocks vs the same: {span(layer_ref)} (limits "
        f"{BF16_REL})")
    return kinds


def logits_against(tag, logits, ref, what, yard=None, plain_mean=False):
    """cuda prefill logits against a reference's: max |d| within
    LM_LOGIT_TOL of its std (with ``plain_mean`` also a mean |d| at most
    LM_PLAIN_MEAN times ``yard``'s), or, given ``yard`` (the reference
    against itself in another order) alone, within LM_YARD_MEAN /
    LM_YARD_MAX times its mean / max |d|."""
    d = (logits - ref).abs()
    max_d, mean_d, std = float(d.max()), float(d.mean()), float(ref.std())
    top1 = int((logits.argmax(-1) == ref.argmax(-1)).sum())
    line = (f"[{tag}] prefill logits, cuda vs {what}: max |d| {max_d:.4f} "
            f"= {max_d / std:.4f} std, mean |d| {mean_d:.5f} (logit std "
            f"{std:.4f}, max {float(ref.abs().max()):.4f}), top-1 {top1} "
            f"of {logits.shape[0]}")
    e = None if yard is None else (yard - ref).abs()
    if yard is None or plain_mean:
        ok = max_d <= LM_LOGIT_TOL * std
        line += f" | limits: max {LM_LOGIT_TOL} std"
        if plain_mean:
            ok &= mean_d <= LM_PLAIN_MEAN * float(e.mean())
            line += (f", mean {LM_PLAIN_MEAN} x the reordered run's "
                     f"{float(e.mean()):.5f}")
    else:
        y_max, y_mean = float(e.max()), float(e.mean())
        ok = mean_d <= LM_YARD_MEAN * y_mean and max_d <= LM_YARD_MAX * y_max
        line += (f" | the same reordered: max |d| {y_max:.4f}, mean |d| "
                 f"{y_mean:.5f}; limits {LM_YARD_MEAN} x mean, "
                 f"{LM_YARD_MAX} x max")
    log(line)
    if not ok:
        raise AssertionError(f"[{tag}] cuda and {what} prefill logits differ "
                             f"beyond their limits")


def on_tensor_cores(FA, name: str, n: int, tag: str) -> None:
    """Raises unless the library ran ``name``'s last ``n`` launches (since
    FA.reset_launches) all on the tensor cores, by its own route count."""
    seen = FA.ROUTES[name]
    if seen != {"tensor_cores": n, "cuda_cores": 0}:
        raise AssertionError(f"[{tag}] {name} launches by route {seen}, "
                             f"expected all {n} on the tensor cores")
    log(f"[{tag}] {name}: all {n} launches on the tensor cores (the "
        f"library's route count)")


def window_phase(torch, counts, FA) -> dict:
    """gemma2-9b on the cuda backend: 42 flash launches a prefill (21
    windowed, 21 global), decode and long_mode decode, checked against
    the torch backend and the plain version."""
    from repro_torch.models import layers
    B, P, G = WIN_BATCH, WIN_PROMPT, WIN_GEN
    model, prompts = build_lm(torch, WIN_ARCH, B, P, G)
    cfg = model.cfg
    logits = serve_timed(torch, counts, FA, model, prompts, None, P, G,
                         "gemma2", cfg.n_layers, long_mode=True)
    model.backend = "torch"
    counts.reset()
    with Timer(torch) as t_ref:
        ref = model.prefill_step(prompts)[0]
    block = layers.KV_BLOCK
    layers.KV_BLOCK = TORCH_REORDERED
    try:
        ref512 = model.prefill_step(prompts)[0]
    finally:
        layers.KV_BLOCK = block
    model.backend = "cuda"
    require(counts.read(), silent=["flash_attention"])
    log(f"[gemma2] torch backend prefill {t_ref.s:.3f} s")
    logits_against("gemma2", logits, ref, "torch", yard=ref512)
    del ref, ref512
    FA.reset_launches()
    kinds = layer_checks(torch, FA, model, prompts, None, "gemma2")
    want = [(True, cfg.local_window), (True, None)] * cfg.repeat
    if kinds != want:
        raise AssertionError(f"[gemma2] flash launches {kinds}, expected "
                             f"{cfg.repeat} windowed and global in turn")
    on_tensor_cores(FA, "flash_attention", len(want), "gemma2")
    counts.reset()
    plain = prefill_with(model, prompts, FA, FA.flash_attention_plain)
    plain256 = prefill_with(model, prompts, FA, functools.partial(
        FA.flash_attention_plain, bk=PLAIN_REORDERED))
    require(counts.read(), silent=["flash_attention"])
    logits_against("gemma2", logits, plain, "plain attention",
                   yard=plain256)
    del model, logits, plain, plain256, prompts
    torch.cuda.empty_cache()
    return {"windowed": cfg.repeat, "global": cfg.repeat}


def encoder_phase(torch, counts, FA) -> dict:
    """whisper-large-v3 on the cuda backend: 64 flash launches a prefill
    (32 in the encoder, not causal; 32 in the decoder), decode with the
    raw source, checked against the torch backend and the plain
    version."""
    B, P, G = ENC_BATCH, ENC_PROMPT, ENC_GEN
    model, prompts = build_lm(torch, ENC_ARCH, B, P, G)
    cfg = model.cfg
    # drawn, not the launcher's ones: ones would make every encoder row
    # alike, a weak check of the kernel
    gen = torch.Generator(device=DEV).manual_seed(5)
    src = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen,
                      device=DEV)
    logits = serve_timed(torch, counts, FA, model, prompts, src, P, G,
                         "whisper", cfg.enc_layers + cfg.repeat,
                         long_mode=False)
    model.backend = "torch"
    counts.reset()
    with Timer(torch) as t_ref:
        ref = model.prefill_step(prompts, src)[0]
    model.backend = "cuda"
    require(counts.read(), silent=["flash_attention"])
    log(f"[whisper] torch backend prefill {t_ref.s:.3f} s")
    logits_against("whisper", logits, ref, "torch")
    del ref
    kinds = layer_checks(torch, FA, model, prompts, src, "whisper")
    want = [(False, None)] * cfg.enc_layers + [(True, None)] * cfg.repeat
    if kinds != want:
        raise AssertionError(f"[whisper] flash launches {kinds}, expected "
                             f"{cfg.enc_layers} encoder then {cfg.repeat} "
                             f"decoder launches")
    counts.reset()
    plain = prefill_with(model, prompts, FA, FA.flash_attention_plain, src)
    plain256 = prefill_with(model, prompts, FA, functools.partial(
        FA.flash_attention_plain, bk=PLAIN_REORDERED), src)
    require(counts.read(), silent=["flash_attention"])
    logits_against("whisper", logits, plain, "plain attention",
                   yard=plain256, plain_mean=True)
    del model, logits, plain, plain256, prompts, src
    torch.cuda.empty_cache()
    return {"encoder": cfg.enc_layers, "decoder": cfg.repeat}


# Phases 5d and 5e: the recurrent mixers (xlstm-125m) and a hybrid of
# Mamba, attention and MoE (one unit of jamba-v0.1-52b), each after 5c.
# xlstm launches no kernel of ours (no attention layer), so its check is
# the recurrence itself, in float32.  jamba's one flash launch a prefill
# is held to the plain version by BF16_REL and its logits by phase 5b's
# yardsticks.  A bf16 rounding at the attention layer can change a
# token's top-2 experts in the MoE layers after it and so move that
# sequence's logits far more than a rounding does: the phase counts such
# tokens between each pair of runs (none on an H100 at this seed, PERF.md
# §6), and a flip that broke a yardstick would fail the phase.
# cuBLAS's kernels on Hopper, by name (nvjet: its JIT GEMMs)
GEMM_KERNELS = ("gemm", "gemv", "nvjet", "xmma", "cutlass")
TENSOR_CORE_DH = (64, 128, 256)  # the flash kernel's wgmma path: bf16 at these


@contextlib.contextmanager
def patched(mod, name, wrap):
    """``mod.name`` replaced by ``wrap(real)`` inside the block."""
    real = getattr(mod, name)
    setattr(mod, name, wrap(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def prefill_split(torch, model, prompts, P, G, tag, parts) -> dict:
    """A warm prefill with CUDA events around each call of ``parts``
    (label -> (module, function name)), their summed spans, then the same
    prefill under torch.profiler, its kernels only (operator rows would
    take a minute to aggregate over the sLSTM loop's ~100k launches): the
    device time of cuBLAS's GEMM kernels (``GEMM_KERNELS``, inside the
    parts too), the busy share, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    spans = {label: [] for label in parts}

    def timer(label):
        def wrap(real):
            def call(*a, **kw):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = real(*a, **kw)
                ev[1].record()
                spans[label].append(ev)
                return out
            return call
        return wrap

    with contextlib.ExitStack() as stack:
        for label, (mod, name) in parts.items():
            stack.enter_context(patched(mod, name, timer(label)))
        with Timer(torch) as t_warm:
            serve.prefill(model, prompts, P + G)
    part_s = {label: sum(a.elapsed_time(b) for a, b in ev) / 1e3
              for label, ev in spans.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.prefill(model, prompts, P + G)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, n = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
            n += 1
    busy = sum(by_name.values()) / 1e9
    is_gemm = lambda name: any(g in name.lower() for g in GEMM_KERNELS)
    gemm = sum(ns for name, ns in by_name.items() if is_gemm(name)) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[{tag}] warm prefill split: {t_warm.s:.3f} s, "
        + ", ".join(f"{label} {sec:.3f} s ({sec / t_warm.s:.1%}, "
                    f"{len(spans[label])} calls)"
                    for label, sec in part_s.items())
        + f" (CUDA events) | under torch.profiler: wall {wall:.3f} s, "
        f"device busy {busy:.3f} s ({busy / wall:.1%}), GEMMs "
        f"{gemm:.3f} s ({gemm / max(busy, 1e-12):.1%} of busy), {n} "
        f"device activities | top: "
        + "; ".join(f"{ns / 1e6:.1f} ms{' GEMM' if is_gemm(name) else ''} "
                    f"{name[:60]}" for name, ns in top))
    return dict(warm_s=t_warm.s, parts_s=part_s, gemm_s=gemm, busy_s=busy,
                profiled_wall_s=wall)


def ssm_phase(torch, counts, FA) -> dict:
    """xlstm-125m on the cuda backend: prefill, decode, the split of a warm
    prefill into the sLSTM loop, the mLSTM chunks and the GEMMs, then in
    float32 the prefill's last-position logits against a token-by-token
    pass of the same recurrence from the zero state."""
    from repro_torch.models import ssm, transformer
    from repro_torch.models.model import Model
    B, P, G = SSM_BATCH, SSM_PROMPT, SSM_GEN
    model, prompts = build_lm(torch, SSM_ARCH, B, P, G)
    cfg = model.cfg
    serve_timed(torch, counts, FA, model, prompts, None, P, G, "xlstm", 0,
                long_mode=False)
    split = prefill_split(torch, model, prompts, P, G, "xlstm", {
        "sLSTM loop": (ssm, "slstm_train"),
        "mLSTM chunks": (ssm, "mlstm_train")})
    f32 = Model(cfg, dtype=torch.float32, device=DEV)
    f32.params = model.params.float()       # the bf16 model's, cast in place
    del model
    x = prompts[:, :SSM_RECUR]
    counts.reset()
    with Timer(torch) as t_pre:
        want = f32.prefill_step(x)[0]
    cache = transformer.init_cache(cfg, B, SSM_RECUR, torch.float32, DEV)
    with Timer(torch) as t_steps:
        for i in range(SSM_RECUR):
            got, cache = f32.serve_step(cache, x[:, i:i + 1], i)
    seen = counts.read()
    require(seen, silent=list(seen))
    d = (got - want).abs()
    err, std = float(d.max()), float(want.std())
    log(f"[xlstm] float32 recurrence over {SSM_RECUR} positions: prefill "
        f"{t_pre.s:.3f} s against {SSM_RECUR} serve steps {t_steps.s:.3f} s "
        f"from the zero state: last-position logits max |d| {err:.3e}, mean "
        f"|d| {float(d.mean()):.3e} (logit std {std:.4f}; limit "
        f"{SSM_RECUR_ATOL}), top-1 {int((got.argmax(-1) == want.argmax(-1)).sum())}"
        f" of {B}")
    if not err <= SSM_RECUR_ATOL:
        raise AssertionError(f"[xlstm] the prefill and the step-by-step "
                             f"recurrence differ by {err:.3e}")
    del f32, cache, got, want, prompts, x
    torch.cuda.empty_cache()
    return dict(split, recur_max_abs=err, recur_std=std)


def routes_into(recs):
    """A wrap of ``layers.moe_route`` that keeps each call's token count
    and its sorted (token, expert) pairs and keep flags."""
    def wrap(real):
        def call(router, xt, E, K, C):
            r = real(router, xt, E, K, C)
            recs.append((xt.shape[0], E, r.tok_s, r.eid_s, r.keep))
            return r
        return call
    return wrap


def expert_flips(a, b, T: int, layers: int) -> list:
    """Per MoE layer, the tokens whose expert choice differs between two
    runs' first prefills (the first ``layers`` calls over T tokens)."""
    pick = lambda recs: [r for r in recs if r[0] == T][:layers]
    flips = []
    for (_, E, ta, ea, _), (_, _, tb, eb, _) in zip(pick(a), pick(b)):
        chose = []
        for tok, eid in ((ta, ea), (tb, eb)):
            m = tok.new_zeros((T, E), dtype=bool)
            m[tok, eid] = True
            chose.append(m)
        flips.append(int((chose[0] != chose[1]).any(1).sum()))
    return flips


def hybrid_phase(torch, args, counts, FA) -> dict:
    """One unit of jamba-v0.1-52b at full width on the cuda backend: one
    flash launch a prefill (tensor cores), Mamba and MoE layers; the
    MoE's dropped pairs, the split of a warm prefill, the launch against
    the plain version, the logits against the torch backend and the plain
    version with the expert flips counted; then the flash kernel timed at
    the prefill's shape (PERF.md row 7d)."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.models import layers, ssm
    B, P, G = HYB_BATCH, HYB_PROMPT, HYB_GEN
    full = get_arch(HYB_ARCH)
    cfg = dataclasses.replace(full, repeat=1, n_layers=len(full.pattern))
    model, prompts = build_lm(torch, HYB_ARCH, B, P, G, cfg=cfg)
    n_attn = sum(s["mixer"] == "attn" for s in cfg.pattern)
    n_moe = sum(s["ffn"] == "moe" for s in cfg.pattern)
    T, K = B * P, cfg.moe.top_k
    routes = {name: [] for name in ("cuda", "torch", "torch512", "plain",
                                    "plain256")}
    with patched(layers, "moe_route", routes_into(routes["cuda"])):
        logits = serve_timed(torch, counts, FA, model, prompts, None, P, G,
                             "jamba", n_attn, long_mode=False)
    drops = [int((~r[4]).sum()) for r in routes["cuda"] if r[0] == T][:n_moe]
    C = max(int(T * K / cfg.moe.n_experts * cfg.moe.capacity_factor), 8)
    log(f"[jamba] MoE in the cold prefill: {T * K} (token, expert) pairs a "
        f"layer, capacity {C} an expert; dropped by layer {drops}")
    split = prefill_split(torch, model, prompts, P, G, "jamba", {
        "mamba": (ssm, "mamba_train"), "MoE": (layers, "moe"),
        "attention": (layers, "attention_full"), "MLP": (layers, "mlp")})
    model.backend = "torch"
    counts.reset()
    with patched(layers, "moe_route", routes_into(routes["torch"])):
        ref = model.prefill_step(prompts)[0]
    with patched(layers, "KV_BLOCK", lambda real: TORCH_REORDERED), \
            patched(layers, "moe_route", routes_into(routes["torch512"])):
        ref512 = model.prefill_step(prompts)[0]
    model.backend = "cuda"
    require(counts.read(), silent=["flash_attention"])
    shapes = []
    kinds = layer_checks(torch, FA, model, prompts, None, "jamba", shapes)
    H, dh = cfg.n_heads, cfg.dh
    if kinds != [(True, None)] * n_attn or shapes != \
            [((B * H, P, dh), torch.bfloat16)] * n_attn or \
            dh not in TENSOR_CORE_DH:
        raise AssertionError(f"[jamba] flash launches {kinds} of {shapes}, "
                             f"expected {n_attn} causal bf16 ones at dh 64 "
                             f"or 128 (the tensor-core path)")
    counts.reset()
    with patched(layers, "moe_route", routes_into(routes["plain"])):
        plain = prefill_with(model, prompts, FA, FA.flash_attention_plain)
    with patched(layers, "moe_route", routes_into(routes["plain256"])):
        plain256 = prefill_with(model, prompts, FA, functools.partial(
            FA.flash_attention_plain, bk=PLAIN_REORDERED))
    require(counts.read(), silent=["flash_attention"])
    flips = {name: expert_flips(routes[base], routes[name], T, n_moe)
             for base, name in (("cuda", "torch"), ("torch", "torch512"),
                                ("cuda", "plain"), ("plain", "plain256"))}
    log(f"[jamba] tokens whose experts differ, by MoE layer: cuda vs torch "
        f"{flips['torch']}, torch vs its {TORCH_REORDERED}-key reordering "
        f"{flips['torch512']}, cuda vs plain {flips['plain']}, plain vs its "
        f"{PLAIN_REORDERED}-key reordering {flips['plain256']} (of {T} "
        f"tokens)")
    logits_against("jamba", logits, ref, "torch", yard=ref512)
    logits_against("jamba", logits, plain, "plain attention", yard=plain256)
    del model, logits, ref, ref512, plain, plain256, prompts, routes
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_causal(q, k, v):
        return sdpa(q[None], k[None], v[None], is_causal=True)[0]

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    BH = B * H
    # 4 * dh * BH * the keys in reach of each row, on the bf16 tensor cores
    rec = time_flash(torch, args, flush, FA, "jamba prefill", (BH, P, dh),
                     dict(causal=True), 4 * dh * BH * P * (P + 1) // 2,
                     n_attn, sdpa_causal)
    rec.update(dropped=drops, expert_flips=flips, split=split)
    return rec


def time_flash(torch, args, flush, FA, name, shape, kw, flop, launches,
               library, yardstick=None) -> dict:
    """The flash kernel at one shape of the slice: it and ``library`` (one
    PyTorch call computing the same function, (q, k, v) -> o) against the
    plain version (BF16_REL, every output finite), each timed beside the
    bound (bf16 tensor cores), and a named yardstick of another function
    beside them."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen, device=DEV).bfloat16()
               for _ in range(3))
    want = FA.flash_attention_plain(q, k, v, **kw)
    errs = []
    for who, fn in (("flash_attention", FA.flash_attention),
                    ("library", library)):
        got = fn(q, k, v, **kw) if fn is FA.flash_attention else fn(q, k, v)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{who} at {name}: not finite")
        try:
            ratio = bf16_rel(FA, got, want, q, k, v, **kw)[0]
        except AssertionError as exc:
            raise AssertionError(f"{who} at {name}: {exc}") from None
        errs.append((ratio, float((got.double() - want.double()).abs()
                                  .max())))
        del got
    del want
    b_ms, b_by = bound(nbytes(q, k, v, q), flop, TENSOR_BF16_OPS_PER_S)
    rec = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:65",
               launches=launches, max_abs_err=errs[0][1],
               ms=median_ms(torch, lambda: FA.flash_attention(q, k, v, **kw),
                            args.reps, flush),
               plain_ms=median_ms(torch, lambda: FA.flash_attention_plain(
                   q, k, v, **kw), 3, flush),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=median_ms(torch, lambda: library(q, k, v),
                                    args.reps, flush),
               library=library.__name__, library_max_abs_err=errs[1][1],
               at=name, shape=dict(BH=shape[0], S=shape[1], dh=shape[2],
                                   dtype="bfloat16", **kw))
    rec["library_ratio"] = rec["ms"] / rec["library_ms"]
    if yardstick is not None:
        rec["yardstick"] = yardstick.__name__
        rec["yardstick_ms"] = median_ms(torch, lambda: yardstick(q, k, v),
                                        args.reps, flush)
    rec["tflops"] = flop / rec["ms"] / 1e9
    log(f"[kernel] flash_attention at {name}: {rec['ms']:.4f} ms (plain "
        f"{rec['plain_ms']:.4f}, bound {b_ms:.4f} by {b_by}, library "
        f"{rec['library']} {rec['library_ms']:.4f}, "
        f"{rec['library_ratio']:.2f}x it; {rec.get('yardstick')} "
        f"{rec.get('yardstick_ms')}; {rec['tflops']:.1f} TFLOP/s) "
        f"{errs[0][0]:.3f} of the elementwise limit, max abs err "
        f"{errs[0][1]:.3e} | library {errs[1][0]:.3f} of the limit, max "
        f"abs err {errs[1][1]:.3e} | {launches} launches a prefill | "
        f"{rec['shape']}")
    return rec


def flex_softcap(torch, S: int, dh: int, cap: float, window=None):
    """``flex_attention`` computing the kernel's function on (BH, S, dh)
    inputs: a tanh softcap on the scaled scores and a causal block mask,
    with ``window`` also keys ``window`` or more behind the row.  Compiled
    (Triton, through inductor, caches under build/) and its mask built
    before it is timed."""
    from torch._inductor import config
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    config.compile_threads = 1      # no compile workers outlive the smoke

    def score_mod(s, b, h, qi, ki):
        return torch.tanh(s / cap) * cap

    def mask_mod(b, h, qi, ki):
        m = qi >= ki
        return m if window is None else m & (qi - ki < window)

    block = create_block_mask(mask_mod, None, None, S, S, device=DEV)
    flex = torch.compile(flex_attention, dynamic=False)

    def flex_attention_softcap(q, k, v):
        return flex(q[None], k[None], v[None], score_mod=score_mod,
                    block_mask=block)[0]

    with Timer(torch) as t:
        flex_attention_softcap(*(torch.zeros((1, S, dh), device=DEV,
                                              dtype=torch.bfloat16)
                                 for _ in range(3)))
    log(f"[kernel] flex_attention softcap {cap} window {window}: compiled "
        f"in {t.s:.1f} s")
    return flex_attention_softcap


def slice_flash_shapes(torch, args, FA, win: dict, enc: dict) -> list:
    """The flash kernel at gemma2's prefill (global and windowed: BH 32,
    S 7,168, dh 256, softcap 50, on the tensor cores) and whisper's encoder
    (BH 80, S 1,500, dh 64, not causal, on the tensor cores), each beside
    the one PyTorch call computing the same function: flex_attention with
    the softcap and the (windowed) causal mask for gemma2, SDPA for
    whisper."""
    from repro_torch.configs.archs import get_arch
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_causal(q, k, v):
        return sdpa(q[None], k[None], v[None], is_causal=True)[0]

    def sdpa_full(q, k, v):
        return sdpa(q[None], k[None], v[None])[0]

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    g, w = get_arch(WIN_ARCH), get_arch(ENC_ARCH)
    S, W, BH = WIN_PROMPT, g.local_window, WIN_BATCH * g.n_heads
    cap = g.attn_softcap
    # 4 * dh * BH * the keys in reach of each row, on the bf16 tensor cores
    flop_g = 4 * g.dh * BH * sum(min(i + 1, S) for i in range(S))
    flop_w = 4 * g.dh * BH * sum(min(i + 1, W) for i in range(S))
    return [
        time_flash(torch, args, flush, FA, "gemma2 global prefill",
                   (BH, S, g.dh), dict(causal=True, softcap=cap), flop_g,
                   win["global"], flex_softcap(torch, S, g.dh, cap),
                   yardstick=sdpa_causal),
        time_flash(torch, args, flush, FA, "gemma2 windowed prefill",
                   (BH, S, g.dh), dict(causal=True, softcap=cap, window=W),
                   flop_w, win["windowed"],
                   flex_softcap(torch, S, g.dh, cap, W),
                   yardstick=sdpa_causal),
        time_flash(torch, args, flush, FA, "whisper encoder",
                   (ENC_BATCH * w.n_heads, w.enc_seq, w.dh),
                   dict(causal=False),
                   4 * w.dh * ENC_BATCH * w.n_heads * w.enc_seq ** 2,
                   enc["encoder"], sdpa_full),
    ]

# The backward kernel against its plain version on the same q, k, v, o,
# lse and do (phase 6a and tests/test_torch_cuda.py).  float32: within
# BWD_F32 of each gradient's largest magnitude (the card's expf, another
# summation order).  bf16: both versions round P and dS to bf16 from
# float32 values whose last bits differ, so a term of a product may differ
# by one bf16 ulp (at most 2^-7 of it) and the output by one more; and
# dS = P (do.v - D) is a difference of two float32 sums of dh terms, whose
# rounding (at most dh 2^-24 of their terms' magnitudes, dh <= 256) is all
# that is left where they cancel (a window of one key leaves dS nothing
# else).  So elementwise
#     |got - want| <= 2^-6 (A + |want|) + 2^-16 A_t
# with A the products over the magnitudes of their terms (|P|^T |do|,
# |dS|^T |qs|, scale |dS| |k|) and A_t the same with |dS| in place of
# P (|do|.|v| + |do|.|o|), the magnitudes of dS's terms; and normwise
# ||got - want|| <= 1e-2 ||want|| + 2^-16 ||A_t|| (where dS cancels to
# rounding everywhere, as with a window of one key, the gradient itself is
# that rounding).
BWD_REL = (2.0 ** -6, 2.0 ** -16, 1e-2)
BWD_F32 = 2e-5


def bwd_yard(q, k, v, o, lse, do, causal=True, softcap=None, window=None,
             bk=512):
    """(A, A_t) of BWD_REL for (dq, dk, dv), float32, blockwise over keys
    as the plain backward."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    f32 = torch.float32
    BH, S, dh = q.shape
    scale = FA.rounded(dh ** -0.5, q.dtype)
    qs = FA.scaled(q, dh ** -0.5).to(f32)
    dof, of = do.to(f32), o.to(f32)
    delta = (dof * of).sum(-1)
    d_terms = (dof.abs() * of.abs()).sum(-1)
    qa, da = qs.abs(), dof.abs()
    A, At = ([torch.zeros((BH, S, dh), dtype=f32, device=q.device)
              for _ in range(3)] for _ in range(2))
    for k0 in range(0, S, bk):
        kb, vb = k[:, k0:k0 + bk].to(f32), v[:, k0:k0 + bk].to(f32)
        ok = FA._mask(S, k0, kb.shape[1], causal, window, q.device)
        p, ds = FA._p_ds(qs, kb, vb, dof, lse, delta, softcap, ok)
        p = p.to(v.dtype).to(f32).abs()
        ds = ds.to(q.dtype).to(f32).abs()
        terms = p * (da @ vb.abs().transpose(1, 2) + d_terms[..., None])
        for out, d in ((A, ds), (At, terms)):
            out[0] += (d @ kb.abs()) * scale
            out[1][:, k0:k0 + bk] = d.transpose(1, 2) @ qa
        A[2][:, k0:k0 + bk] = p.transpose(1, 2) @ da
    return A, At


def bwd_rel(FA, got, case, check=True, **kw) -> tuple:
    """The backward kernel's (dq, dk, dv) on ``case`` = (q, k, v, o, lse,
    do) against its plain version: (the largest share of the elementwise
    limit, the largest normwise error, the max abs error); with ``check``
    raises beyond BWD_F32 / BWD_REL."""
    import torch
    want = FA.flash_attention_backward_plain(*case, **kw)
    bf16 = case[0].dtype != torch.float32
    yard = bwd_yard(*case, **kw) if bf16 else None
    share = norm = top_err = 0.0
    for i, (name, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)}, "
                                 f"expected {w.dtype} {tuple(w.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} is not finite")
        d, w = (g.double() - w.double()).abs(), w.double()
        top = float(w.abs().max())
        if bf16:
            c_a, c_t, c_n = BWD_REL
            lim = c_a * (yard[0][i].double() + w.abs()) + \
                c_t * yard[1][i].double()
            r = float(torch.where(d == 0, 0.0, d / lim).max())
            n = float(d.norm() / max(float(w.norm()), 1e-30))
            n_lim = c_n * float(w.norm()) + \
                c_t * float(yard[1][i].double().norm())
            if check and not (r <= 1.0 and float(d.norm()) <= n_lim):
                raise AssertionError(f"{name}: {r:.3f} of the elementwise "
                                     f"limit, normwise {n:.3e}")
        else:
            r = float(d.max()) / (BWD_F32 * max(top, 1e-30))
            n = float(d.norm() / max(float(w.norm()), 1e-30))
            if check and not r <= 1.0:
                raise AssertionError(f"{name}: max |d| {float(d.max()):.3e}"
                                     f" beyond {BWD_F32} of {top:.3e}")
        share, norm = max(share, r), max(norm, n)
        top_err = max(top_err, float(d.max()))
    return share, norm, top_err


# the backward kernel against its plain version (bwd_rel) on its own
# inputs: shape, dtype, causal, window, softcap.  The tensor cores (bf16,
# dh 64 and 128) at one and two tiles, ragged S, softcaps of 30 and of 2
# (at 2 the factor 1 - tanh^2 moves dS by ~20%: a dS without it fails;
# at 30 by ~0.1%, inside BWD_REL), a window of one key (dS is rounding
# only) and of 128 and 200 (tiles at the window's lower edge), whisper's
# encoder and the training shape of phase 6a; the CUDA cores at bf16 dh
# 96 and float32.  Two launches at BWD_TRAIN_SHAPE must agree bit for bit.
BWD_TRAIN_SHAPE = (TRAIN_BATCH * 36, TRAIN_SEQ, 128)
BWD_FLASH_CASES = [
    ((2, 256, 128), "bfloat16", True, None, None),
    ((2, 200, 128), "bfloat16", False, None, 30.0),
    ((2, 256, 64), "bfloat16", True, None, 30.0),
    ((2, 256, 128), "bfloat16", True, None, 2.0),
    ((2, 200, 64), "bfloat16", False, None, 2.0),
    ((2, 300, 64), "bfloat16", True, 1, 30.0),
    ((2, 700, 128), "bfloat16", True, 128, None),
    ((3, 600, 128), "bfloat16", True, 200, 50.0),
    ((2, 1500, 64), "bfloat16", False, None, None),
    (BWD_TRAIN_SHAPE, "bfloat16", True, None, None),
    ((2, 200, 96), "bfloat16", True, None, 50.0),
    ((2, 256, 128), "float32", True, None, 30.0),
]


def check_flash_bwd(torch, FA) -> list:
    """The backward kernel against its plain version at BWD_FLASH_CASES
    (each from the forward kernel's o and lse on the same q, k, v), and two
    launches at BWD_TRAIN_SHAPE bit-identical; a line for each case."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    lines = []
    for shape, dt, causal, window, cap in BWD_FLASH_CASES:
        q, k, v, do = (torch.randn(shape, generator=gen, device=DEV).to(
            getattr(torch, dt)) for _ in range(4))
        kw = dict(causal=causal, softcap=cap, window=window)
        o, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
        got = FA.flash_attention_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        try:
            share, norm, err = bwd_rel(FA, got, (q, k, v, o, lse, do), **kw)
        except AssertionError as exc:
            raise AssertionError(f"flash_attention_backward {shape} {dt} "
                                 f"{kw}: {exc}") from None
        lines.append(f"{shape} {dt} {kw}: {share:.3f} of the elementwise "
                     f"limit, normwise {norm:.3e}, max abs err {err:.3e}")
        log(f"[flash bwd] {lines[-1]}")
    q, k, v, do = (torch.randn(BWD_TRAIN_SHAPE, generator=gen,
                               device=DEV).bfloat16() for _ in range(4))
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    a = FA.flash_attention_backward(q, k, v, o, lse, do)
    again = FA.flash_attention_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, again)):
        raise AssertionError("flash_attention_backward: two launches on the "
                             "same inputs differ")
    log("[flash bwd] two launches at the training shape bit-identical")
    return lines


def checked_flash(FA, fwd_errs, bwd_errs, first=None):
    """Stand-ins for ``FA.flash_attention`` and
    ``FA.flash_attention_backward`` that launch the kernels and hold each
    launch to the plain version on its own inputs: the forward by
    BF16_REL and its lse within 1e-2, the backward by BWD_REL (bwd_rel).
    Each appends its errors to its list; ``first`` keeps the first
    backward call's inputs and outputs."""
    real_f, real_b = FA.flash_attention, FA.flash_attention_backward

    def fwd_checked(q, k, v, return_lse=False, **kw):
        o, lse = real_f(q, k, v, return_lse=True, **kw)
        want, want_lse = FA.flash_attention_plain(q, k, v, return_lse=True,
                                                  **kw)
        d_lse = float((lse - want_lse).abs().max())
        if not d_lse <= 1e-2:
            raise AssertionError(f"a forward's lse is {d_lse:.3e} from the "
                                 f"plain version's, beyond 1e-2")
        fwd_errs.append(bf16_rel(FA, o, want, q, k, v, **kw)[:2] + (d_lse,))
        return (o, lse) if return_lse else o

    def bwd_checked(q, k, v, o, lse, do, **kw):
        got = real_b(q, k, v, o, lse, do, **kw)
        bwd_errs.append(bwd_rel(FA, got, (q, k, v, o, lse, do), **kw))
        if first is not None and not first:
            first.update(case=tuple(t.clone() for t in (q, k, v, o, lse,
                                                         do)),
                         got=tuple(t.clone() for t in got), kw=kw)
        return got

    return fwd_checked, bwd_checked


def train_model(torch, layers: int, lr=TRAIN_LR, dtype=None,
                backend="cuda"):
    """starcoder2-7b at full width cut to ``layers`` layers, bf16 unless
    ``dtype`` says otherwise, AdamW at ``lr``, weights from a seeded
    generator on the card (drawn in float32, then cast), as
    ``launch/train.py``'s ``build`` makes the whole arch."""
    from repro_torch.configs.archs import get_arch
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), repeat=layers,
                              n_layers=layers)
    model = Model(cfg, dtype=dtype or torch.bfloat16, device=DEV,
                  backend=backend, lr=lr)
    model.init(torch.Generator(device=DEV).manual_seed(0))
    return cfg, model


def train_phase(torch, args, counts, FA) -> dict:
    """starcoder2-7b at full width cut to TRAIN_LAYERS layers, trained on
    the cuda backend through ``launch/train.py``'s step function: step 0
    with every flash launch held to the plain versions, the launches of a
    step, the loss and grad norm against the torch backend, the loss
    falling over TRAIN_STEPS steps, step time and its split, peak memory;
    then the backward kernel timed at this shape beside its bound, its
    plain version and SDPA's backward, and the forward with lse beside it
    without."""
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import train
    from repro_torch.optim.opt import global_norm
    bwd_cases = check_flash_bwd(torch, FA)
    torch.cuda.empty_cache()
    with Timer(torch) as t_init:
        cfg, model = train_model(torch, TRAIN_LAYERS)
    n_params = sum(p.numel() for p in model.parameters())
    H, dh, L = cfg.n_heads, cfg.dh, cfg.n_layers
    B, S, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    log(f"[train] {cfg.name} cut to {L} layers: d_model {cfg.d_model}, "
        f"{H} heads / {cfg.n_kv} kv, dh {dh}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab} | {n_params:,} parameters ({init_count(cfg):,} by the "
        f"reference's init), {model.dtype}, {cfg.optimizer} | init "
        f"{t_init.s:.2f} s")
    if n_params != init_count(cfg) or model.backend != "cuda" or \
            model.dtype != torch.bfloat16 or L != TRAIN_LAYERS:
        raise AssertionError("the model is not starcoder2-7b's full width "
                             "in bf16 on the cuda backend")
    data = SyntheticSource(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B, seed=0))
    batches = [data.batch(step) for step in range(steps)]

    # the torch backend on step 0's weights and batch
    b0 = {k: torch.from_numpy(v).to(DEV) for k, v in batches[0].items()}
    model.backend = "torch"
    counts.reset()
    with Timer(torch) as t_ref:
        ref_loss = float(model.loss_and_grad(b0))
        ref_norm = float(global_norm([p.grad for p in model.parameters()]))
    require(counts.read(), silent=["flash_attention",
                                   "flash_attention_backward"])
    for p in model.parameters():
        p.grad = None
    model.backend = "cuda"
    del b0
    torch.cuda.empty_cache()

    # step 0 with every launch checked; each step split by CUDA events
    fwd_errs, bwd_errs, first = [], [], {}
    real_f, real_b = FA.flash_attention, FA.flash_attention_backward
    fwd_checked, bwd_checked = checked_flash(FA, fwd_errs, bwd_errs, first)
    marks = []
    real_lg = model.loss_and_grad

    def timed_loss_and_grad(batch):
        loss = real_lg(batch)
        marks[-1][1].record()
        return loss

    model.loss_and_grad = timed_loss_and_grad
    state = model.init_opt()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, walls = [], [], []
    counts.reset()
    FA.reset_launches()
    for step, batch in enumerate(batches):
        marks.append([torch.cuda.Event(enable_timing=True)
                      for _ in range(3)])
        if step == 0:
            FA.flash_attention, FA.flash_attention_backward = \
                fwd_checked, bwd_checked
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            marks[-1][0].record()
            state, metrics = train.step_fn(model, state, step, batch)
            marks[-1][2].record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        finally:
            FA.flash_attention, FA.flash_attention_backward = real_f, real_b
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if step == 0:
            WINDOWS["train step 0"] = step0 = counts.read()
    WINDOWS["train steps"] = seen = counts.read()
    del model.loss_and_grad
    peak = torch.cuda.max_memory_allocated() / 2**30
    want0 = {"flash_attention": 2 * L, "flash_attention_backward": L}
    for name, n in want0.items():
        if step0[name] != n or seen[name] != steps * n:
            raise AssertionError(f"[train] {name}: {step0[name]} launches in "
                                 f"step 0, {seen[name]} in {steps} steps; "
                                 f"expected {n} a step ({L} layers, the "
                                 f"forward once more under remat)")
    require(seen, silent=[k for k in seen if k not in want0])
    for name, n in want0.items():
        on_tensor_cores(FA, name, steps * n, "train")
    span = lambda errs, i: (min(e[i] for e in errs), max(e[i] for e in errs))
    log(f"[train] step 0's {len(fwd_errs)} forward launches vs the plain "
        f"version on their own q, k, v: at most {span(fwd_errs, 0)[1]:.3f} "
        f"of BF16_REL's elementwise limit, normwise {span(fwd_errs, 1)}, lse"
        f" max |d| {span(fwd_errs, 2)[1]:.3e} | its {len(bwd_errs)} backward "
        f"calls vs the plain backward: at most {span(bwd_errs, 0)[1]:.3f} of"
        f" BWD_REL's elementwise limit, normwise {span(bwd_errs, 1)} "
        f"(limits {BWD_REL})")
    d_loss = abs(losses[0] - ref_loss) / abs(ref_loss)
    d_norm = abs(norms[0] - ref_norm) / abs(ref_norm)
    log(f"[train] step 0 on cuda vs the torch backend ({t_ref.s:.2f} s): "
        f"loss {losses[0]:.6f} vs {ref_loss:.6f} (rel {d_loss:.3e}, limit "
        f"{TRAIN_LOSS_RTOL}), grad norm {norms[0]:.6f} vs {ref_norm:.6f} "
        f"(rel {d_norm:.3e}, limit {TRAIN_GNORM_RTOL})")
    if not (d_loss <= TRAIN_LOSS_RTOL and d_norm <= TRAIN_GNORM_RTOL):
        raise AssertionError("[train] cuda and torch step 0 differ beyond "
                             "their limits")
    if not (losses[-1] < losses[0] and all(map(math.isfinite, losses))):
        raise AssertionError(f"[train] the loss did not fall: {losses}")
    warm = sorted(range(1, steps), key=lambda i: walls[i])
    mid = warm[len(warm) // 2]
    fb = marks[mid][0].elapsed_time(marks[mid][1]) / 1e3
    opt = marks[mid][1].elapsed_time(marks[mid][2]) / 1e3
    tok_s = B * S / walls[mid]
    log(f"[train] {steps} steps: losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]} | step (warm median of "
        f"{steps - 1}) {walls[mid]:.3f} s ({tok_s:.0f} tok/s): forward + "
        f"backward {fb:.3f} s, optimizer {opt:.3f} s (CUDA events) | step 0 "
        f"{walls[0]:.3f} s with its checks | peak {peak:.2f} GiB")

    # two launches on the same inputs, then the timings at this shape
    case, kw = first["case"], first["kw"]
    again = real_b(*case, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(again, first["got"])):
        raise AssertionError("[train] two backward launches on the same "
                             "inputs differ")
    del model, state, again, batches
    torch.cuda.empty_cache()
    q, k, v, o, lse, do = case
    BH = q.shape[0]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    # 5 products over the keys in reach of each row, on the tensor cores
    flop = 5 * 2 * dh * BH * S * (S + 1) // 2
    moved = nbytes(q, k, v, o, lse, do) + nbytes(q, k, v)
    b_ms, b_by = bound(moved, flop, TENSOR_BF16_OPS_PER_S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qq, kk, vv = (t[None].detach().requires_grad_() for t in (q, k, v))
    oo = sdpa(qq, kk, vv, is_causal=True)

    def sdpa_backward():
        return torch.autograd.grad(oo, (qq, kk, vv), do[None],
                                   retain_graph=True)

    # SDPA's backward starts from its own forward's o and lse, and rounds
    # P and dS elsewhere: its distance from the plain version is printed,
    # not held to BWD_REL
    lib = [g[0] for g in sdpa_backward()]
    lib_share = bwd_rel(FA, lib, case, check=False, **kw)
    del lib
    rec = dict(name="flash_attention_backward", route="cuda",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/models/layers.py:86",
               replaces_note="no Pallas kernel: the reference's training "
                             "step differentiates this chunked attention "
                             "with XLA",
               launches=seen["flash_attention_backward"],
               max_abs_err=max(e[2] for e in bwd_errs),
               ms=median_ms(torch, lambda: real_b(*case, **kw), args.reps,
                            flush),
               plain_ms=median_ms(torch, lambda: FA.
                                  flash_attention_backward_plain(*case, **kw),
                                  3, flush),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=median_ms(torch, sdpa_backward, args.reps, flush),
               library="scaled_dot_product_attention backward",
               library_share_of_limit=lib_share[0],
               library_normwise=lib_share[1], cases=bwd_cases,
               shape=dict(BH=BH, S=S, dh=dh, dtype="bfloat16", causal=True))
    del oo, qq, kk, vv
    rec["library_ratio"] = rec["ms"] / rec["library_ms"]
    rec["tflops"] = flop / rec["ms"] / 1e9
    # the forward with lse (the training forward) beside it without, in
    # turns
    fw = {"without": [], "with": []}
    for which in ("without", "with", "with", "without"):
        fw[which].append(median_ms(torch, lambda: real_f(
            q, k, v, return_lse=which == "with"), args.reps, flush))
    rec["forward_ms"] = min(fw["without"])
    rec["forward_lse_ms"] = min(fw["with"])
    rec.update(step_s=walls[mid], tokens_per_s=tok_s, fwd_bwd_s=fb,
               optimizer_s=opt, peak_gib=peak, losses=losses,
               grad_norms=norms, torch_loss=ref_loss, torch_grad_norm=ref_norm)
    log(f"[kernel] flash_attention_backward: {rec['ms']:.4f} ms (plain "
        f"{rec['plain_ms']:.4f}, bound {b_ms:.4f} by {b_by}, SDPA backward "
        f"{rec['library_ms']:.4f}, {rec['library_ratio']:.2f}x it, "
        f"{rec['tflops']:.1f} TFLOP/s; SDPA's backward at "
        f"{lib_share[0]:.3f} of BWD_REL's elementwise limit, normwise "
        f"{lib_share[1]:.3e}) | forward {fw['without']} "
        f"ms, with lse {fw['with']} ms | {rec['launches']} calls in "
        f"{steps} steps | {rec['shape']}")
    del case, first, q, k, v, o, lse, do, flush
    torch.cuda.empty_cache()
    return rec


def reduced_train_phase(torch, counts, FA) -> None:
    """The reduced starcoder2 trained on the cuda backend through
    ``launch/train.py``: step 0 of an uninterrupted run with every flash
    launch held to the plain versions (checked_flash), a run resumed from
    its step-3 checkpoint ends with parameters bit-identical to the
    uninterrupted run's, and ``--elastic --fail-at 3`` restarts from the
    latest checkpoint and finishes."""
    import shutil
    import tempfile
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import elastic, train
    common = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "6", "--batch",
              "4", "--seq", "64", "--log-every", "100"]
    run = lambda *a: train.train(train.parser().parse_args(common + list(a)))
    fwd_errs, bwd_errs = [], []
    real_step = train.step_fn
    real_f, real_b = FA.flash_attention, FA.flash_attention_backward

    def checked_step(model, state, step, batch):
        if step == 0:
            FA.flash_attention, FA.flash_attention_backward = \
                checked_flash(FA, fwd_errs, bwd_errs)
        try:
            return real_step(model, state, step, batch)
        finally:
            FA.flash_attention, FA.flash_attention_backward = real_f, real_b

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        counts.reset()
        train.step_fn = checked_step
        try:
            with Timer(torch) as t:
                full = run("--ckpt", os.path.join(d, "a"), "--ckpt-every",
                           "3")
        finally:
            train.step_fn = real_step
        WINDOWS["train reduced"] = seen = counts.read()
        L = full["model"].cfg.n_layers
        if len(fwd_errs) != 2 * L or len(bwd_errs) != L:
            raise AssertionError(f"[train reduced] step 0 checked "
                                 f"{len(fwd_errs)} forward and "
                                 f"{len(bwd_errs)} backward calls; expected "
                                 f"{2 * L} and {L}")
        require(seen, ["flash_attention", "flash_attention_backward"])
        run("--ckpt", os.path.join(d, "b"), "--ckpt-every", "3")
        shutil.rmtree(os.path.join(d, "b", "step_00000006"))
        resumed = run("--ckpt", os.path.join(d, "b"), "--ckpt-every", "100")
        pairs = list(zip(ckpt._flatten(full["params"])[0],
                         ckpt._flatten(resumed["params"])[0]))
        if not pairs or not all(a.dtype == b.dtype and torch.equal(a, b)
                                for a, b in pairs):
            raise AssertionError("[train reduced] the resumed run's "
                                 "parameters differ from the uninterrupted "
                                 "run's")
        args = train.parser().parse_args(
            common + ["--steps", "5", "--ckpt", os.path.join(d, "c"),
                      "--ckpt-every", "2", "--fail-at", "3"])
        out = elastic.run_elastic(train.train, args)
        last = ckpt.latest_step(os.path.join(d, "c"))
        if last != 5 or not all(map(math.isfinite, out["losses"])):
            raise AssertionError(f"[train reduced] the elastic run ended at "
                                 f"step {last}")
    log(f"[train reduced] {TRAIN_ARCH} reduced, bf16, B 4 x S 64 on cuda: 6 "
        f"steps in {t.s:.2f} s (step 0 with its checks), launches "
        f"{ {k: v for k, v in seen.items() if v} }; step 0's "
        f"{len(fwd_errs)} forward launches at most "
        f"{max(e[0] for e in fwd_errs):.3f} of BF16_REL's elementwise limit "
        f"(normwise {max(e[1] for e in fwd_errs):.3e}, lse max |d| "
        f"{max(e[2] for e in fwd_errs):.3e}), its {len(bwd_errs)} backward "
        f"calls at most {max(e[0] for e in bwd_errs):.3f} of BWD_REL's "
        f"(normwise {max(e[1] for e in bwd_errs):.3e}); resumed from step 3: "
        f"{len(pairs)} parameter leaves bit-identical to the uninterrupted "
        f"run; --elastic --fail-at 3 restarted and reached step {last}")


# Triangle counting (phase 2d): the reference's TC family
# (benchmarks/dynamic_vs_static.py: run_tc), a uniform graph with its
# self-loops dropped, symmetrized, and updates made symmetric in pairs;
# wedge enumeration costs O(E * max degree), which is why the paper's TC
# times out on skewed graphs.  The skewed RMAT check is run, not timed.
TC_DEGREE, TC_PERCENT, TC_SEEDS = 8, 0.4, (2, 3)
TC_SKEWED = (14, 16, 1.0)          # rmat scale, degree, percent updated
# save and restore (phase 2e): an armed DynSSSP at this scale, saved
# after half of its batches of this size
SAVE_SCALE, SAVE_BATCH = 16, 2048
# every window's launches, by tag (the kernels' JSON records carry them)
WINDOWS = {}
TIMES = {}


def window(torch, counts, tag, fn, launched=(), silent=(), merges=None):
    """``fn()`` in a window of its own: every launch count and the peak
    memory reset just before it and read just after; prints its wall time,
    launches and peak memory, checks which kernels it ran (``merges``:
    the exact number of ``merge_pool_sorted`` launches) and returns
    (fn's result, launches, seconds)."""
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    with Timer(torch) as t:
        out = fn()
    launches = counts.read()
    WINDOWS[tag] = launches
    log(f"[{tag}] {t.s:.3f} s | launches "
        f"{ {k: v for k, v in launches.items() if v} } | peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(launches, launched, tuple(silent) + ("flash_attention",))
    if merges is not None and launches["merge_pool_sorted"] != merges:
        raise AssertionError(f"[{tag}] merge_pool_sorted launched "
                             f"{launches['merge_pool_sorted']} times for "
                             f"{merges} add batches")
    return out, launches, t.s


def sym_stream(np, repro_torch, ups):
    """An update stream with both directions of each update side by side
    (as run_tc makes them), so an even batch size never splits a pair."""
    adds = np.stack([ups.adds, ups.adds[:, [1, 0, 2]]], 1).reshape(-1, 3)
    dels = np.stack([ups.dels, ups.dels[:, [1, 0]]], 1).reshape(-1, 2)
    return repro_torch.UpdateStream(adds=adds, dels=dels)


def tc_graph(np, repro_torch, kind, log2):
    """The symmetrized TC graph and its paired update stream: ``uniform``
    is uniform_graph(2^log2, 8, seed=2) with 0.4% updates (seed 3),
    ``skewed`` rmat_graph(14, 16, seed=0) with 1% (seed 3)."""
    from repro_torch.algos.oracles import symmetrize
    from repro_torch.graph.csr import uniform_graph
    if kind == "uniform":
        n, edges, w = uniform_graph(1 << log2, TC_DEGREE, seed=TC_SEEDS[0])
        percent = TC_PERCENT
    else:
        n, edges, w = repro_torch.rmat_graph(TC_SKEWED[0], TC_SKEWED[1],
                                             seed=0)
        percent = TC_SKEWED[2]
    keep = edges[:, 0] != edges[:, 1]
    e, w2 = symmetrize(edges[keep], w[keep])
    csr = repro_torch.build_csr(n, e, w2, device=DEV)
    ups = repro_torch.random_updates(csr, percent=percent, seed=TC_SEEDS[1])
    return csr, sym_stream(np, repro_torch, ups)


def tc_edges_after(np, csr, stream):
    """(src, dst) of the edge set (base − dels) ∪ adds, each key once."""
    n = csr.n
    s, d = csr.src.cpu().numpy(), csr.dst.cpu().numpy()
    keys = s.astype(np.int64) * n + d
    dk = stream.dels[:, 0].astype(np.int64) * n + stream.dels[:, 1]
    ak = stream.adds[:, 0].astype(np.int64) * n + stream.adds[:, 1]
    keys = np.unique(np.concatenate([keys[~np.isin(keys, dk)], ak]))
    return keys // n, keys % n


def scipy_triangles(np, n, s, d) -> int:
    """Exact triangles of a symmetric edge set: with L its strictly lower
    triangle, each triangle k > j > i is one nonzero product of
    (L @ L) .* L."""
    from scipy.sparse import csr_matrix
    low = s > d
    L = csr_matrix((np.ones(int(low.sum()), np.int64), (s[low], d[low])),
                   shape=(n, n))
    return int((L @ L).multiply(L).sum())


def tc_phase(torch, np, repro_torch, counts, args, silent) -> dict:
    """Phase 2d: triangle counting on cuda (static_tc, then dyn_tc through
    ``bind_graph(...).call`` and through ``run_stream``), against the torch
    backend, cuda_chained and scipy; the DSL's DynTC on the same graph
    (phase 2e); the skewed RMAT check.  Returns the counts."""
    from repro_torch import dsl_programs
    from repro_torch.algos import triangles
    t0 = time.perf_counter()
    csr, stream = tc_graph(np, repro_torch, "uniform", args.tc_log2)
    n, nb = csr.n, stream.num_batches(BATCH)
    deg = (csr.offsets[1:] - csr.offsets[:-1]).max().item()
    log(f"[tc graph] uniform 2^{args.tc_log2} degree {TC_DEGREE}, "
        f"symmetrized: n={n} E={csr.num_edges} max degree {deg} | stream: "
        f"{stream.num_adds} add lanes, {stream.num_dels} del lanes, {nb} "
        f"batches of {BATCH} | generation {time.perf_counter() - t0:.2f} s")
    cap = 2 * stream.num_adds
    TC_DATA.update(csr=csr, stream=stream)

    def bind(backend):
        sess = repro_torch.bind_graph(csr, backend=backend, capacity=cap,
                                      device=DEV)
        sess.handle
        return sess

    def static_then_dyn(backend):
        sess = bind(backend)
        with Timer(torch) as t_static:
            c0 = sess.call(triangles.static_tc)
        with Timer(torch) as t_dyn:
            c1 = sess.call(triangles.dyn_tc, stream, BATCH, count=c0)
        TIMES[f"tc {backend}"] = (t_static.s, t_dyn.s)
        return sess, c0, c1

    (sess, c0, c1), _, _ = window(
        torch, counts, "tc cuda: static_tc, dyn_tc", lambda:
        static_then_dyn("cuda"), silent=silent, merges=nb)
    t_static, t_dyn = TIMES["tc cuda"]
    log(f"[tc cuda] static_tc {t_static:.3f} s, dyn_tc {t_dyn:.3f} s "
        f"({t_dyn / nb:.3f} s a batch); triangles {int(c0)} -> {int(c1)} "
        f"({c1.dtype}); max-degree reads {sess.engine.deg_syncs}")
    if c0.dtype != torch.int32 or c1.dtype != torch.int32:
        raise AssertionError("TC counts are not int32")

    def streamed():
        s2 = bind("cuda")
        with Timer(torch) as t_static:
            c = s2.call(triangles.static_tc)
        with Timer(torch) as t_stream:
            c = s2.run_stream(stream, BATCH, triangles.stream_step, c)
        TIMES["tc cuda stream"] = (t_static.s, t_stream.s)
        return c

    c2, _, _ = window(torch, counts, "tc cuda: static_tc, run_stream",
                      streamed, silent=silent, merges=nb)
    log(f"[tc cuda] run_stream {TIMES['tc cuda stream'][1]:.3f} s "
        f"({TIMES['tc cuda stream'][1] / nb:.3f} s a batch)")
    if args.profile:
        prof = bind("cuda")
        c = profile_window(torch, "tc static_tc",
                           lambda: prof.call(triangles.static_tc))
        profile_window(torch, "tc stream", lambda: prof.run_stream(
            stream, BATCH, triangles.stream_step, c))
        del prof
    for backend in ("torch", "cuda_chained"):
        (_, b0, b1), _, _ = window(
            torch, counts, f"tc {backend}: static_tc, dyn_tc",
            lambda b=backend: static_then_dyn(b), silent=silent,
            merges=0)
        if (int(b0), int(b1)) != (int(c0), int(c1)):
            raise AssertionError(f"TC on {backend} counts {int(b0)} -> "
                                 f"{int(b1)}, cuda {int(c0)} -> {int(c1)}")
    if int(c2) != int(c1):
        raise AssertionError(f"TC run_stream {int(c2)} != dyn_tc {int(c1)}")
    del sess
    torch.cuda.empty_cache()

    # the DSL's DynTC on the same graph and stream (phase 2e)
    prog = repro_torch.compile(dsl_programs.path("tc"))
    res, _, t_dsl = window(
        torch, counts, "tc dsl cuda: DynTC", lambda: prog.bind(
            csr, backend="cuda", capacity=cap, device=DEV).run(
            "DynTC", updateBatch=stream, batchSize=BATCH),
        silent=silent, merges=nb)
    log(f"[tc dsl cuda] DynTC {t_dsl:.3f} s ({t_dsl / (t_static + t_dyn):.2f}"
        f"x the hand-staged static_tc + dyn_tc); count {int(res.value)}")
    if int(res.value) != int(c1) or res.value.dtype != torch.int32:
        raise AssertionError(f"DSL DynTC {res.value} != hand-staged "
                             f"{int(c1)}")
    del res

    with Timer(torch) as t_ref:
        s, d = csr.src.cpu().numpy(), csr.dst.cpu().numpy()
        want0 = scipy_triangles(np, n, s, d)
        want1 = scipy_triangles(np, n, *tc_edges_after(np, csr, stream))
    if (int(c0), int(c1)) != (want0, want1):
        raise AssertionError(f"TC counts {int(c0)} -> {int(c1)}, scipy "
                             f"{want0} -> {want1}")
    log(f"[check] TC: static and final counts ({want0} -> {want1}) equal "
        f"on cuda, torch, cuda_chained, run_stream, the DSL and scipy "
        f"({t_ref.s:.1f} s)")
    del csr, stream
    torch.cuda.empty_cache()

    # skewed: checked, not timed
    t0 = time.perf_counter()
    csr, stream = tc_graph(np, repro_torch, "skewed", None)
    deg = (csr.offsets[1:] - csr.offsets[:-1]).max().item()
    sess = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=2 * stream.num_adds, device=DEV)
    k0 = sess.call(triangles.static_tc)
    k1 = sess.call(triangles.dyn_tc, stream, BATCH, count=k0)
    s, d = csr.src.cpu().numpy(), csr.dst.cpu().numpy()
    want = (scipy_triangles(np, csr.n, s, d),
            scipy_triangles(np, csr.n, *tc_edges_after(np, csr, stream)))
    if (int(k0), int(k1)) != want:
        raise AssertionError(f"skewed TC counts {int(k0)} -> {int(k1)}, "
                             f"scipy {want}")
    log(f"[check] TC on symmetrized rmat {TC_SKEWED[0]} (E={csr.num_edges}, "
        f"max degree {deg}, {stream.num_adds} add lanes): {want[0]} -> "
        f"{want[1]} triangles, equal to scipy "
        f"({time.perf_counter() - t0:.1f} s)")
    del sess, csr, stream
    torch.cuda.empty_cache()
    return {"static": int(c0), "final": int(c1)}


def dsl_phase(torch, np, repro_torch, counts, args, csr, stream, sssp_cuda,
              pr_ref, statics, silent) -> None:
    """Phase 2e: the DSL on the card — DynSSSP one-shot and armed against
    the hand-staged cuda run, DynPR twice against the float64 reference,
    and an armed DynSSSP saved and restored at ``SAVE_SCALE``.  A DSL
    prologue is timed against a warm hand-staged static run (``statics``,
    each program's second on this graph), a DSL stream against step 2's
    hand-staged stream."""
    import tempfile
    from repro_torch import dsl_programs
    nb = stream.num_batches(BATCH)
    cap = 2 * stream.num_adds
    prog = repro_torch.compile(dsl_programs.path("sssp"))

    def bind(p):
        sess = p.bind(csr, backend="cuda", capacity=cap, device=DEV)
        sess.handle
        return sess

    def warm_static(static):
        sess = repro_torch.bind_graph(csr, backend="cuda", capacity=cap,
                                      device=DEV)
        sess.handle
        with Timer(torch) as t:
            sess.call(*static)
        return t.s

    warm = [warm_static(st) for st in statics]
    torch.cuda.empty_cache()

    one, _, t_one = window(
        torch, counts, "dsl sssp cuda: DynSSSP one-shot", lambda: bind(
            prog).run("DynSSSP", updateBatch=stream, batchSize=BATCH, src=0),
        silent=silent, merges=nb)
    if not torch.equal(one.props["dist"], sssp_cuda["dist"]):
        raise AssertionError("DSL DynSSSP dist differs from the hand-staged "
                             "cuda run")

    def armed(p, run_args):
        sess = bind(p)
        with Timer(torch) as t_pro:
            sess.run(**run_args)
        with Timer(torch) as t_stream:
            sess.run_stream(stream, BATCH)
        TIMES[f"dsl {run_args['func']}"] = (t_pro.s, t_stream.s)
        return sess

    arm, _, _ = window(torch, counts, "dsl sssp cuda: DynSSSP armed",
                       lambda: armed(prog, dict(func="DynSSSP",
                                                batchSize=BATCH, src=0)),
                       silent=silent, merges=nb)
    for k, v in one.props.items():
        if not torch.equal(arm.props[k], v):
            raise AssertionError(f"armed DynSSSP differs from one-shot in {k}")
    pro, st = TIMES["dsl DynSSSP"]
    hand = TIMES["sssp cuda"]
    log(f"[dsl sssp cuda] one-shot {t_one:.3f} s; armed: prologue "
        f"{pro:.3f} s, stream {st:.3f} s ({st / nb:.3f} s a batch) against "
        f"hand-staged warm static {warm[0]:.3f} s (first run "
        f"{hand[1]:.3f} s), stream {hand[2]:.3f} s: {pro / warm[0]:.2f}x / "
        f"{st / hand[2]:.2f}x")
    log("[check] DSL DynSSSP dist equals the hand-staged cuda run; armed "
        "applies equal the one-shot run (dist, parent, modified)")
    if args.profile:
        prof = bind(prog)
        profile_window(torch, "dsl sssp prologue", lambda: prof.run(
            "DynSSSP", batchSize=BATCH, src=0))
        profile_window(torch, "dsl sssp stream",
                       lambda: prof.run_stream(stream, BATCH))
        del prof
    del one, arm
    torch.cuda.empty_cache()

    prog = repro_torch.compile(dsl_programs.path("pagerank"))
    beta, delta, max_iter = PR_KNOBS
    knobs = dict(batchSize=BATCH, beta=beta, delta=delta, maxIter=max_iter)
    arm, _, _ = window(torch, counts, "dsl pagerank cuda: DynPR armed",
                       lambda: armed(prog, dict(func="DynPR", **knobs)),
                       launched=("segment_sum_sorted",), silent=silent,
                       merges=nb)
    one, _, t_one = window(
        torch, counts, "dsl pagerank cuda: DynPR one-shot", lambda: bind(
            prog).run("DynPR", updateBatch=stream, **knobs),
        launched=("segment_sum_sorted",), silent=silent, merges=nb)
    pr = one.props["pageRank"]
    if not torch.equal(arm.props["pageRank"], pr):
        raise AssertionError("two DSL DynPR runs differ")
    pro, st = TIMES["dsl DynPR"]
    hand = TIMES["pagerank cuda"]
    log(f"[dsl pagerank cuda] one-shot {t_one:.3f} s; armed: prologue "
        f"{pro:.3f} s, stream {st:.3f} s ({st / nb:.3f} s a batch) against "
        f"hand-staged warm static {warm[1]:.3f} s (first run "
        f"{hand[1]:.3f} s), stream {hand[2]:.3f} s: {pro / warm[1]:.2f}x / "
        f"{st / hand[2]:.2f}x")
    got = pr.cpu().numpy().astype(np.float64)
    l1 = float(np.abs(got - pr_ref).sum())
    l1_bound = (1 + 2 * nb) * beta / (1 - delta)
    log(f"[check] DSL DynPR: two runs bit-identical; vs float64 scipy: L1 "
        f"{l1:.3e} (bound {l1_bound:.3e}), max |d| "
        f"{np.abs(got - pr_ref).max():.3e}")
    if not l1 <= l1_bound:
        raise AssertionError(f"DSL PageRank L1 error {l1} above its bound "
                             f"{l1_bound}")
    top = np.argsort(pr_ref)[-1000:]
    np.testing.assert_allclose(got[top], pr_ref[top], rtol=5e-2, atol=0,
                               err_msg="DSL PageRank's top 1,000 vertices")
    del one, arm, pr
    torch.cuda.empty_cache()

    # save midway and restore, at SAVE_SCALE in batches of SAVE_BATCH
    n, edges, w = repro_torch.rmat_graph(SAVE_SCALE, DEGREE, seed=0)
    small = repro_torch.build_csr(n, edges, w, device=DEV)
    ups = repro_torch.random_updates(small, percent=PERCENT, seed=1)
    batches = list(ups.batches(SAVE_BATCH, device=DEV))
    k = len(batches) // 2
    prog = repro_torch.compile(dsl_programs.path("sssp"))

    def armed_on(bs):
        sess = prog.bind(small, backend="cuda", capacity=2 * ups.num_adds,
                         device=DEV)
        sess.run("DynSSSP", batchSize=SAVE_BATCH, src=0)
        for b in bs:
            sess.apply(b)
        return sess

    def save_restore():
        with tempfile.TemporaryDirectory() as d:
            armed_on(batches[:k]).save(d)
            back = repro_torch.restore_session(d, device=DEV)
        if not (back.armed and back.stream_cursor == k):
            raise AssertionError("restore did not re-arm at the saved batch")
        for b in batches[k:]:
            back.apply(b)
        return back

    back, _, t_sr = window(torch, counts, "dsl save/restore", save_restore,
                           silent=silent)
    full = armed_on(batches)
    for key, v in full.props.items():
        if not torch.equal(back.props[key], v):
            raise AssertionError(f"restored DynSSSP differs in {key}")
    for part in ("g", "ell"):
        a, b = getattr(full.handle, part), getattr(back.handle, part)
        for f, x in vars(a).items():
            if isinstance(x, torch.Tensor) and not torch.equal(
                    x, getattr(b, f)):
                raise AssertionError(f"restored DynSSSP differs in "
                                     f"{part}.{f}")
    log(f"[check] DSL save after {k} of {len(batches)} batches of "
        f"{SAVE_BATCH} (rmat {SAVE_SCALE}, E={small.num_edges}), restore, "
        f"finish: dist, parent, modified, every DynGraph array and the ELL "
        f"pack bit-identical to the uninterrupted run ({t_sr:.2f} s)")
    del back, full, small
    torch.cuda.empty_cache()

# -- phase 2f: failover and the serving pool ---------------------------------
DYN_FIELDS = ("offsets", "src", "dst", "w", "alive", "d_offsets", "d_src",
              "d_dst", "d_w", "d_alive", "overflow")
# the pool: the reference's serving family at a size the card holds
# (benchmarks/serve.py: rmat degree 8, 30% updates a tenant; the mix of
# examples/multi_tenant.py: 8 armed DynSSSP tenants of 32, 24 resident)
POOL_SCALE, POOL_DEGREE, POOL_PERCENT = 16, 8, 30
POOL_TENANTS, POOL_ARMED, POOL_RESIDENT = 32, 8, 24
POOL_BATCH, POOL_TICKS = 2048, 8
# every tenant's diff pool holds all its ticks' adds: no overflow replay
POOL_CAPACITY = POOL_TICKS * POOL_BATCH
MERGE_WIDTHS = (1, 3, 32)


SYNC_SITES = {}


def count_syncs(torch, fn):
    """``fn()`` and the host syncs it made (torch's sync debug mode warns
    at every synchronizing call); each sync's Python line is tallied in
    ``SYNC_SITES``."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    for w in syncs:
        site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
        SYNC_SITES[site] = SYNC_SITES.get(site, 0) + 1
    return out, len(syncs)


def failover_phase(torch, repro_torch, counts, csr, stream, sssp_cuda,
                   g_host) -> None:
    """Phase 2f, failover: SSSP on the smoke's graph and stream through
    ``bind_graph(failover=True)`` with a fault planted at the
    ``kernel_launch`` seam of ``update_add`` once two batches are in."""
    from repro_torch.algos import sssp
    from repro_torch.runtime import faults
    from repro_torch.runtime.errors import KernelFailure
    migrations = []

    def bind(**kw):
        sess = repro_torch.bind_graph(csr, backend="cuda",
                                      capacity=2 * stream.num_adds,
                                      device=DEV, **kw)
        inner = sess._migrate

        def timed(name):
            frm = sess.backend_name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner(name)
            torch.cuda.synchronize()
            migrations.append((frm, name, time.perf_counter() - t0))
            log(f"[failover] migration {frm} -> {name}: "
                f"{migrations[-1][2]:.3f} s")
        sess._migrate = timed
        return sess

    def fault(fused_only=False):
        return lambda c: (c.get("engine") == "cuda"
                          and c.get("op") == "update_add"
                          and (c.get("fused") is True or not fused_only))

    def faulted_run(sess, match):
        props = sess.call(sssp.static_sssp, 0)
        with faults.inject("kernel_launch", times=None, after=2,
                           match=match) as inj:
            props = sess.run_stream(stream, BATCH, sssp.stream_step, props)
        return props, inj.fired

    def same_as_2a(sess, props, tag):
        for k in ("dist", "parent"):
            if not torch.equal(props[k], sssp_cuda[k]):
                raise AssertionError(f"[{tag}] {k} differs from phase 2a")
        g = sess.engine.handle_graph(sess.handle)
        for f in DYN_FIELDS:
            if not torch.equal(getattr(g, f).cpu(), g_host[f]):
                raise AssertionError(f"[{tag}] g.{f} differs from phase 2a")

    def hops_twice():
        sess = bind(failover=True)
        sess._failover.probe_base_s = 3600.0   # stays on torch below
        return sess, faulted_run(sess, fault())

    tag = "failover cuda -> cuda_chained -> torch"
    (sa, (props_a, fired)), _, _ = window(torch, counts, tag, hops_twice,
                                          launched=("fused_relax_rows",))
    h = sa.health
    if not (sa.backend_name == "torch" and h.failovers == 2 and h.degraded):
        raise AssertionError(f"[{tag}] ended on {sa.backend_name} after "
                             f"{h.failovers} failovers")
    same_as_2a(sa, props_a, tag)
    log(f"[check] {tag}: the fault fired {fired} times, 2 failovers, "
        f"{h.kernel_failures} kernel failures; dist, parent and every "
        f"DynGraph array equal phase 2a's")

    def hops_once():
        sess = bind(failover=True)
        sess._failover.probe_base_s = 0.0      # re-probe at the next call
        return sess, faulted_run(sess, fault(fused_only=True))

    tag = "failover cuda -> cuda_chained (a fused-only fault)"
    (sb, (props_b, fired)), _, _ = window(
        torch, counts, tag, hops_once,
        launched=("fused_relax_rows", "relax_rowmin", "relax_rowargmin"))
    if not (sb.backend_name == "cuda_chained" and sb.health.failovers == 1):
        raise AssertionError(f"[{tag}] ended on {sb.backend_name} after "
                             f"{sb.health.failovers} failovers")
    same_as_2a(sb, props_b, tag)
    log(f"[check] {tag}: stopped on cuda_chained, whose relax_rowmin and "
        f"relax_rowargmin carried the stream; equal to phase 2a")

    extra = repro_torch.random_updates(csr, percent=0.05, seed=3).window(
        BATCH, 0, 1)
    tag = "failover re-probe back to cuda"
    props_b, _, _ = window(
        torch, counts, tag,
        lambda: sb.run_stream(extra, BATCH, sssp.stream_step, props_b),
        launched=("fused_relax_rows", "merge_pool_sorted"),
        silent=("relax_rowmin", "relax_rowargmin"))
    h = sb.health
    if not (sb.backend_name == "cuda" and h.reprobes >= 1
            and not h.degraded):
        raise AssertionError(f"[{tag}] on {sb.backend_name}, "
                             f"{h.reprobes} re-probes")
    props_a = sa.run_stream(extra, BATCH, sssp.stream_step, props_a)
    for k in ("dist", "parent"):
        if not torch.equal(props_b[k], props_a[k]):
            raise AssertionError(f"[{tag}] {k} differs from the torch "
                                 f"session's after the same batch")
    log(f"[check] {tag}: {h.reprobes} re-probe, not degraded; dist and "
        f"parent after one more batch equal the torch session's")
    del sa, sb, props_a, props_b
    torch.cuda.empty_cache()

    def no_failover():
        sess = bind()
        props = sess.call(sssp.static_sssp, 0)
        props = sess.run_stream(stream.window(BATCH, 0, 2), BATCH,
                                sssp.stream_step, props)
        h0 = sess.handle
        before = {f: getattr(h0.g, f).clone() for f in DYN_FIELDS}
        before.update({f"ell.{f}": getattr(h0.ell, f).clone()
                       for f in ("ell_src", "ell_w", "row2dst",
                                 "lane2slot")})
        with faults.inject("kernel_launch", times=None, match=fault()):
            try:
                sess.apply(stream.batch(2, BATCH, device=DEV))
            except KernelFailure:
                pass
            else:
                raise AssertionError("the fault did not raise")
        h1 = sess.handle
        for f, x in before.items():
            part, _, name = f.rpartition(".")
            now = getattr(h1.ell if part else h1.g, name)
            if not torch.equal(now, x):
                raise AssertionError(f"the failed batch left {f} changed")
        return sess

    tag = "no failover: KernelFailure after rollback"
    sd, _, _ = window(torch, counts, tag, no_failover)
    if not (sd.backend_name == "cuda" and sd.health.kernel_failures == 1
            and sd.health.last_error_kind == "KernelFailure"):
        raise AssertionError(f"[{tag}] health {sd.health.as_dict()}")
    sd.apply(stream.batch(2, BATCH, device=DEV))       # still serving
    log(f"[check] {tag}: every DynGraph and ELL array as before the batch; "
        f"the next apply succeeds")
    log("[failover] migrations: " + "; ".join(
        f"{a} -> {b} {t:.3f} s" for a, b, t in migrations))
    del sd
    torch.cuda.empty_cache()


def pool_state(sess) -> dict:
    """A pooled or solo session's arrays: the packed handle (DynGraph and
    ELL) and its properties."""
    tree, _ = sess.engine.pack_state(sess.handle)
    out = {f"g.{k}": v for k, v in tree["g"].items()}
    out.update({f"ell.{k}": v for k, v in tree["ell"].items()})
    out.update({f"prop.{k}": v for k, v in sess.props.items()})
    return out


def same_state(torch, a: dict, b: dict, tag: str) -> None:
    if sorted(a) != sorted(b):
        raise AssertionError(f"[{tag}] arrays {sorted(a)} vs {sorted(b)}")
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"[{tag}] {k} differs")


def pool_fresh(torch, np, d_src, d_dst, n, size, seed) -> list:
    """A sorted admitted batch of ``size`` fresh edges for a pool."""
    rng = np.random.default_rng(seed)
    pool_keys = (d_src.long() * n + d_dst.long()).cpu().numpy()
    fk = np.unique(rng.integers(0, n, size=2 * size) * np.int64(n)
                   + rng.integers(0, n, size=2 * size))
    fk = fk[~np.isin(fk, pool_keys)][:size]
    fresh = [torch.from_numpy(x.astype(np.int32)).to(DEV)
             for x in (fk // n, fk % n, rng.integers(1, 100, size=size))]
    fresh.append(torch.ones(size, dtype=torch.bool, device=DEV))
    return fresh


def check_merge_batched(torch, np, FK, cases=MERGE_CASES,
                        widths=MERGE_WIDTHS) -> list:
    """Each MERGE_CASES entry stacked S wide (each session its own draw)
    through merge_pool_sorted_batched, against its plain version and S
    solo merge_pool_sorted launches, bit for bit; a line a case."""
    lines = []
    for i, (name, D, B, pool_used, batch_used, ties, where) in \
            enumerate(cases):
        for S in widths:
            sessions = [merge_case(np, 1000 * i + s, D, B, pool_used,
                                   batch_used, ties, where)
                        for s in range(S)]
            st = [torch.from_numpy(np.stack(col)).to(DEV)
                  for col in zip(*sessions)]
            with junk_outputs(torch):
                got = FK.merge_pool_sorted_batched(*st, n=MERGE_N)
                solo = [FK.merge_pool_sorted(*(x[s] for x in st),
                                             n=MERGE_N) for s in range(S)]
            want = FK.merge_pool_sorted_batched_plain(*st, MERGE_N)
            solo = tuple(torch.stack(col) for col in zip(*solo))
            torch.cuda.synchronize()
            try:
                max_abs_err(torch, got, want)
                max_abs_err(torch, got, solo)
            except AssertionError as exc:
                raise RowMismatch({"merge_pool_sorted_batched":
                                   f"{name}, S={S}: {exc}"}) from None
        lines.append(f"{name}: D={D} B={B}, S {'/'.join(map(str, widths))}"
                     f", bit-exact against the plain version and S solo "
                     f"launches")
    return lines


def pool_phase(torch, np, repro_torch, counts, args, FK) -> dict:
    """Phase 2f, the serving pool: ``POOL_TENANTS`` tenants on one RMAT
    graph in ``vmap``, ``scan`` and ``off`` modes, against each other and
    solo sessions; then the batched merge against its plain version and
    solo launches, timed at the pool's shape.  Returns its record."""
    import tempfile
    from repro_torch import dsl_programs
    from repro_torch.core import registry
    from repro_torch.serve import SessionPool
    n, edges, w = repro_torch.rmat_graph(POOL_SCALE, POOL_DEGREE, seed=1)
    keep = edges[:, 0] != edges[:, 1]
    csr = repro_torch.build_csr(n, edges[keep], w[keep], device=DEV)
    del edges, w, keep
    streams = [repro_torch.random_updates(csr, percent=POOL_PERCENT, seed=t)
               for t in range(POOL_TENANTS)]
    batches = [[s.batch(i, POOL_BATCH, device=DEV) for i in range(POOL_TICKS)]
               for s in streams]
    prog = repro_torch.compile(dsl_programs.path("sssp"))
    names = [f"t{t}" for t in range(POOL_TENANTS)]
    log(f"[pool] rmat {POOL_SCALE} degree {POOL_DEGREE}, self-loops "
        f"dropped: n={n} E={csr.num_edges} | {POOL_TENANTS} tenants "
        f"({POOL_ARMED} armed DynSSSP), {POOL_PERCENT}% updates each, "
        f"batches of {POOL_BATCH}, {POOL_TICKS} ticks, max_resident "
        f"{POOL_RESIDENT}")
    states, stats, launches = {}, {}, {}
    structural = POOL_TENANTS - POOL_ARMED
    for mode in ("vmap", "scan", "off"):
        registry.clear_shared_engines()
        spill = tempfile.TemporaryDirectory()
        pool = SessionPool(prog, backend="cuda", batch_mode=mode,
                           max_resident=POOL_RESIDENT, spill_dir=spill.name,
                           max_pending=4 * POOL_TENANTS, device=DEV)
        for t, nm in enumerate(names):
            sess = pool.bind(nm, csr, capacity=POOL_CAPACITY)
            if t < POOL_ARMED:
                sess.run("DynSSSP", batchSize=POOL_BATCH, src=0)
        ticks, syncs, spill_s = [], [], {"evict": 0.0, "_restore": 0.0,
                                           "mega": 0.0}
        run = pool._batcher.run

        def timed(name):
            inner = getattr(pool, name)

            def call(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return inner(*a, **kw)
                finally:
                    spill_s[name] += time.perf_counter() - t0
            setattr(pool, name, call)

        timed("evict")
        timed("_restore")

        def counted(*a, **kw):
            t0 = time.perf_counter()
            out, k = count_syncs(torch, lambda: run(*a, **kw))
            torch.cuda.synchronize()
            spill_s["mega"] += time.perf_counter() - t0
            syncs.append(k)
            return out

        pool._batcher.run = counted

        def serve():
            for i in range(POOL_TICKS):
                with Timer(torch) as t:
                    pool.apply_many([(nm, batches[j][i])
                                     for j, nm in enumerate(names)])
                ticks.append(t.s)

        silent = ROW_KERNELS + ("segment_sum_sorted",)
        if mode == "vmap":
            _, got, t_all = window(torch, counts, f"pool {mode}", serve,
                                   launched=("merge_pool_sorted_batched",),
                                   silent=silent)
        else:
            _, got, t_all = window(
                torch, counts, f"pool {mode}", serve,
                silent=silent + ("merge_pool_sorted_batched",))
        st = pool.stats()
        warm = np.asarray(ticks[1:])
        p50, p99 = np.percentile(warm, [50, 99])
        log(f"[pool {mode}] tick p50 {p50 * 1e3:.2f} ms p99 "
            f"{p99 * 1e3:.2f} ms ({p50 / POOL_TENANTS * 1e6:.0f} "
            f"us/session; first tick {ticks[0] * 1e3:.1f} ms) | "
            f"mega_calls {st['mega_calls']} mega_sessions "
            f"{st['mega_sessions']} sequential_fallbacks "
            f"{st['sequential_fallbacks']} evictions {st['evictions']} "
            f"restores {st['restores']} | host syncs a mega-call "
            f"{sorted(set(syncs))} | solo runs {pool.solo_runs} | of "
            f"{t_all:.3f} s: spills {spill_s['evict']:.3f} s, restores "
            f"{spill_s['_restore']:.3f} s, mega-calls {spill_s['mega']:.3f} "
            f"s")
        armed_applies = POOL_ARMED * POOL_TICKS
        if pool.solo_runs:
            raise AssertionError(f"[pool {mode}] tenants ran solo: "
                                 f"{pool.solo_runs}")
        if st["evictions"] == 0 or st["restores"] == 0:
            raise AssertionError(f"[pool {mode}] no tenant was evicted")
        if mode == "off":
            want = {"merge_pool_sorted": POOL_TENANTS * POOL_TICKS,
                    "merge_pool_sorted_batched": 0}
            if st["mega_calls"] or st["sequential_fallbacks"] != \
                    POOL_TENANTS * POOL_TICKS:
                raise AssertionError(f"[pool off] {st}")
        else:
            want = {"merge_pool_sorted": (armed_applies if mode == "vmap"
                                          else POOL_TENANTS * POOL_TICKS),
                    "merge_pool_sorted_batched": (POOL_TICKS
                                                  if mode == "vmap" else 0)}
            if not (st["mega_calls"] == POOL_TICKS
                    and st["mega_sessions"] == structural * POOL_TICKS
                    and st["sequential_fallbacks"] == armed_applies):
                raise AssertionError(f"[pool {mode}] {st}")
            if max(syncs) > 2:
                raise AssertionError(f"[pool {mode}] a mega-call made "
                                     f"{max(syncs)} host syncs, at "
                                     f"{SYNC_SITES}")
        for k, v in want.items():
            if got[k] != v:
                raise AssertionError(f"[pool {mode}] {k} launched {got[k]} "
                                     f"times, expected {v}")
        states[mode] = {nm: pool_state(pool.session(nm)) for nm in names}
        stats[mode], launches[mode] = (st, syncs, p50, p99), got
        del pool
        spill.cleanup()
    for mode in ("scan", "off"):
        for nm in names:
            same_state(torch, states[mode][nm], states["vmap"][nm],
                       f"pool {mode} vs vmap, {nm}")

    solo_syncs = []
    for t, nm in enumerate(names):
        if t < POOL_ARMED:
            solo = prog.bind(csr, backend="cuda", capacity=POOL_CAPACITY,
                             device=DEV)
            solo.run("DynSSSP", batchSize=POOL_BATCH, src=0)
        else:
            solo = repro_torch.bind_graph(csr, backend="cuda",
                                          capacity=POOL_CAPACITY, device=DEV)
        for i, b in enumerate(batches[t]):
            if t >= POOL_ARMED and i == POOL_TICKS - 1:
                admitted = solo._admit_for_apply(b)
                _, k = count_syncs(torch,
                                   lambda: solo._apply_admitted(admitted))
                solo_syncs.append(k)
            else:
                solo.apply(b)
        same_state(torch, states["vmap"][nm], pool_state(solo),
                   f"pool vs solo, {nm}")
        del solo
    log(f"[pool] host syncs by line (mega-calls and solo applies): "
        f"{SYNC_SITES}")
    log(f"[check] pool: every tenant's DynGraph, ELL and property arrays "
        f"equal across vmap, scan and off and to solo sessions; host syncs "
        f"a solo structural apply {sorted(set(solo_syncs))}, a mega-call "
        f"{sorted(set(stats['vmap'][1]))} (one round of "
        f"{structural} tenants)")

    # the batched merge against its plain version and solo launches
    for line in check_merge_batched(torch, np, FK):
        log(f"[merge batched] {line}")
    S = structural
    gs = [states["vmap"][nm] for nm in names[POOL_ARMED:]]
    pool_arrays = [torch.stack([x[f"g.d_{f}"] for x in gs])
                   for f in ("src", "dst", "w", "alive")]
    D = pool_arrays[0].shape[1]
    fresh = [torch.stack(col) for col in zip(*(
        pool_fresh(torch, np, x["g.d_src"], x["g.d_dst"], n, POOL_BATCH,
                   seed=s)
        for s, x in enumerate(gs)))]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)

    def solo_launches():
        return [FK.merge_pool_sorted(*(x[s] for x in pool_arrays + fresh),
                                     n=n) for s in range(S)]

    keys = torch.cat([pool_arrays[0].long() * (n + 1) + pool_arrays[1],
                      fresh[0].long() * (n + 1) + fresh[1]], dim=1)
    rec = check_kernel(
        torch, args, flush, "merge_pool_sorted_batched",
        "src/repro_torch/csrc/repair.cu",
        "src/repro/kernels/pallas_repair.py:217",
        launches["vmap"]["merge_pool_sorted_batched"],
        lambda: FK.merge_pool_sorted_batched(*pool_arrays, *fresh, n=n),
        lambda: FK.merge_pool_sorted_batched_plain(*pool_arrays, *fresh, n),
        nbytes(*pool_arrays, *fresh), S * merge_ops(D),
        library=lambda: torch.sort(keys, dim=1, stable=True),
        S=S, D=D, B=POOL_BATCH, n=n)
    solo = tuple(torch.stack(col) for col in zip(*solo_launches()))
    max_abs_err(torch, outputs(FK.merge_pool_sorted_batched(
        *pool_arrays, *fresh, n=n)), solo)
    rec["solo_ms"] = median_ms(torch, solo_launches, args.reps, flush)
    rec["variant"] = (f"the solo merge's tiles over a grid of (tiles, S), "
                      f"one launch for S = {S} sessions; vmap(pallas_call) "
                      f"in the reference's pool (src/repro/serve/batch.py)")
    log(f"[kernel] merge_pool_sorted_batched: {rec['ms']:.4f} ms for S={S} "
        f"against {rec['solo_ms']:.4f} ms for {S} solo launches "
        f"(bound {rec['bound_ms']:.4f} ms), bit-exact against both")
    del states, pool_arrays, fresh, keys, flush, csr, batches
    registry.clear_shared_engines()
    torch.cuda.empty_cache()
    return rec


COND_NODES = 256            # branches in check_cond's captured segment


def check_cond(torch, args, flush, GC) -> dict:
    """The conditional nodes' set kernel (``csrc/graph_cond.cu``) against
    its plain version, the host read of an eager branch: a captured segment
    of ``COND_NODES`` branches on seeded device flags must take, at every
    replay, the branch each flag names.  Timed: one set-and-branch (the
    replay over its ``2 * COND_NODES`` IF nodes, each a set launch, the
    node and a one-add body) against one host read.  Its ``launches`` are
    filled in by phase 2g, the path that launches it."""
    from repro_torch.core import device_loop as DL
    gen = torch.Generator().manual_seed(5)
    preds = (torch.rand(COND_NODES, generator=gen) > 0.5).to(DEV)
    zero = torch.zeros((), dtype=torch.int32, device=DEV)

    def body(h, c, b):
        outs = [DL.cond(h["p"][i], lambda o: o + 1, lambda o: o - 1,
                        h["z"][i:i + 1]) for i in range(COND_NODES)]
        return {**h, "z": torch.cat(outs)}, c

    seg = DL.SegmentGraph(body, lambda h: torch.stack([zero] * 3), DEV)
    h = {"p": preds, "z": torch.zeros(COND_NODES, dtype=torch.int32,
                                      device=DEV)}
    seg(h, zero, zero)                  # a segment's first use: uncaptured
    got = seg(h, zero, zero)[0]["z"]    # captured and replayed
    want = torch.tensor([1 if GC.set_condition_plain(p) else -1
                         for p in preds.cpu()], dtype=torch.int32,
                        device=DEV)
    try:
        err = max_abs_err(torch, (got,), (want,))
    except AssertionError as exc:
        raise AssertionError(f"graph_cond_set: {exc}") from None
    nodes = 2 * COND_NODES
    b_ms, b_by = bound(1, 0)
    rec = dict(name="graph_cond_set", route="cuda",
               source="src/repro_torch/csrc/graph_cond.cu",
               replaces="src/repro/core/engine.py:491 (lax.while_loop and "
                        "lax.cond predicates; no Pallas kernel)",
               launches=None, max_abs_err=err,
               ms=median_ms(torch, seg.graph.replay, args.reps, flush)
               / nodes,
               plain_ms=median_ms(torch, lambda: GC.set_condition_plain(
                   preds[0]), args.reps, flush),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               shape={"nodes": nodes})
    log(f"[kernel] graph_cond_set: {rec['ms']:.4f} ms a set-and-branch "
        f"(plain: a host read, {rec['plain_ms']:.4f} ms; bound "
        f"{b_ms:.2e} by {b_by}) every branch as its flag")
    return rec


# -- phase 2g: the fused stream executor and the frontier engine --------------
SSSP_REPLAY_SYNCS = 3          # host syncs allowed a replayed SSSP segment
TC_DATA = {}              # phase 2d's graph and stream, for 2g and 2h


def same_tree(torch, a, b, tag) -> None:
    """Two carries (a dict of tensors or one tensor) equal bit for bit."""
    a = a if isinstance(a, dict) else {"count": a}
    b = b if isinstance(b, dict) else {"count": b}
    for k in a:
        if not torch.equal(a[k], b[k]):
            raise AssertionError(f"[{tag}] {k} differs")


def same_handle(torch, eng, a, b, tag) -> None:
    """Every DynGraph array (and the ELL pack's, where the handle has one)
    equal bit for bit."""
    ga, gb = eng.handle_graph(a), eng.handle_graph(b)
    for f in DYN_FIELDS:
        if not torch.equal(getattr(ga, f), getattr(gb, f)):
            raise AssertionError(f"[{tag}] g.{f} differs")
    if hasattr(a, "ell"):
        for f in ("ell_src", "ell_w", "row2dst", "lane2slot", "offsets"):
            if not torch.equal(getattr(a.ell, f), getattr(b.ell, f)):
                raise AssertionError(f"[{tag}] ell.{f} differs")


def fused_vs_eager(torch, counts, tag, eng, h0, stream, step, carry0,
                   busy=False) -> dict:
    """The per-batch baseline (``Engine.run_stream``), then the fused
    executor from the same start three times: its first call runs the
    segment uncaptured, its second captures the segment's graph and
    replays it, the third only replays.  Results, handles and launches
    must be equal; returns the readings."""
    from repro_torch.core.engine import Engine
    # the captured runs also launch the conditional nodes' set kernel,
    # which the per-batch driver does not have
    kept = lambda d: {k: v for k, v in d.items()
                      if v and k != "graph_cond_set"}
    out = {}

    def timed(name, fn):
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        with Timer(torch) as t:
            res, syncs = count_syncs(torch, fn)
        out[name] = {"s": t.s, "syncs": syncs, "launches": counts.read(),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        WINDOWS[f"2g {tag} {name}"] = out[name]["launches"]
        return res

    he, ce = timed("eager", lambda: Engine.run_stream(
        eng, h0, stream, BATCH, step, carry0))
    for name in ("first", "capture", "replay"):
        hf, cf = timed(name, lambda: eng.run_stream(
            h0, stream, BATCH, step, carry0))
        same_tree(torch, ce, cf, f"{tag} {name}")
        same_handle(torch, eng, he, hf, f"{tag} {name}")
        runs = [r for r in eng._stream_cache.values() if r.graph is not None]
        if bool(runs) != (name != "first"):
            raise AssertionError(f"[{tag}] {name} call: {len(runs)} "
                                 f"captured segments")
    want = kept(out["eager"]["launches"])
    for name in ("first", "capture", "replay"):
        if kept(out[name]["launches"]) != want:
            raise AssertionError(
                f"[{tag}] {name} launches {kept(out[name]['launches'])} "
                f"!= the per-batch driver's {want}")
    if out["first"]["launches"]["graph_cond_set"]:
        raise AssertionError(f"[{tag}] the uncaptured run launched "
                             f"graph_cond_set")
    if busy:
        # a replay that continues from the last one's handle, against the
        # per-batch driver continuing from its own
        with Timer(torch) as t:
            hc, cc = eng.run_stream(hf, stream, BATCH, step, cf)
        out["continued_s"] = t.s
        he, ce = Engine.run_stream(eng, he, stream, BATCH, step, ce)
        same_tree(torch, ce, cc, f"{tag} continued")
        same_handle(torch, eng, he, hc, f"{tag} continued")
        del hc, cc
        profile_window(torch, f"2g {tag} per-batch driver",
                       lambda: Engine.run_stream(eng, h0, stream, BATCH,
                                                 step, carry0))
        profile_window(torch, f"2g {tag} fused replay",
                       lambda: eng.run_stream(h0, stream, BATCH, step,
                                              carry0))
    out["capture_s"] = sum(r.capture_s for r in runs)
    out["nodes"] = sum(r.cap.nodes for r in runs)
    out["segments"] = len(runs)
    out["trips"] = sum(sum(r.last_trips) for r in runs)
    out["copy_bytes"] = max(r.copy_bytes for r in runs)
    if busy:
        log(f"[2g {tag}] a replay continuing from the last one's handle "
            f"{out['continued_s']:.3f} s, equal to the per-batch driver's "
            f"continuation bit for bit; each replay copies "
            f"{out['copy_bytes']} bytes of handle in and as many out (the "
            f"leaves a segment writes)")
    e, f, c, r = (out[k] for k in ("eager", "first", "capture", "replay"))
    log(f"[2g {tag}] per-batch {e['s']:.3f} s, {e['syncs']} host syncs, "
        f"peak {e['peak_gib']:.2f} GiB | fused: first call (uncaptured) "
        f"{f['s']:.3f} s, {f['syncs']} syncs | second call {c['s']:.3f} s "
        f"({out['capture_s']:.3f} s capture of {out['segments']} "
        f"segment(s), {out['nodes']} conditional nodes), {c['syncs']} "
        f"syncs, peak {c['peak_gib']:.2f} GiB | replay {r['s']:.3f} s, "
        f"{r['syncs']} syncs, {out['trips']} body runs, "
        f"{r['launches']['graph_cond_set']} graph_cond_set | launches "
        f"{want} in all four | equal bit for bit")
    del he, hf
    eng._stream_cache.clear()
    return out


def fused_phase(torch, repro_torch, counts, csr, stream, paths,
                sssp_ref, pr_torch, cond_rec) -> dict:
    """Phase 2g: the fused stream executor against the per-batch driver
    on ``cuda`` and ``cuda_chained`` (SSSP, PageRank) and on ``cuda`` (TC,
    phase 2d's graph), then the ``frontier`` backend's SSSP and PageRank
    against step 4's ``torch`` arrays (the per-batch driver's).
    ``cond_rec``, the set kernel's record, gets its launches from the
    replayed SSSP ``cuda`` segment."""
    from repro_torch.algos import triangles
    readings = {}
    for algo, backend in (("sssp", "cuda"), ("pagerank", "cuda"),
                          ("sssp", "cuda_chained"),
                          ("pagerank", "cuda_chained")):
        static, step = paths[algo]
        sess = repro_torch.bind_graph(csr, backend=backend,
                                      capacity=2 * stream.num_adds,
                                      device=DEV)
        carry0 = sess.call(*static)
        tag = f"{algo} {backend}"
        readings[tag] = fused_vs_eager(
            torch, counts, tag, sess.engine, sess.handle, stream, step,
            carry0, busy=tag == "sssp cuda")
        del sess, carry0
        torch.cuda.empty_cache()
    cond_rec["launches"] = \
        readings["sssp cuda"]["replay"]["launches"]["graph_cond_set"]
    require(readings["sssp cuda"]["replay"]["launches"],
            ("fused_relax_rows", "graph_cond_set"))
    syncs = readings["sssp cuda"]["replay"]["syncs"]
    if syncs > SSSP_REPLAY_SYNCS:
        raise AssertionError(f"a replayed SSSP segment made {syncs} host "
                             f"syncs (at most {SSSP_REPLAY_SYNCS})")

    tcsr, tstream = TC_DATA["csr"], TC_DATA["stream"]
    sess = repro_torch.bind_graph(tcsr, backend="cuda",
                                  capacity=2 * tstream.num_adds, device=DEV)
    c0 = sess.call(triangles.static_tc)
    readings["tc cuda"] = fused_vs_eager(
        torch, counts, "tc cuda", sess.engine, sess.handle, tstream,
        triangles.stream_step, c0)
    del sess, c0
    torch.cuda.empty_cache()

    clock = lambda: Timer(torch)
    for algo, launched in (("sssp", ()), ("pagerank",
                                          ("segment_sum_sorted",))):
        tag = f"{algo} frontier"
        fsess, props, _ = drive(torch, repro_torch, counts, csr, stream,
                                tag, "frontier", paths[algo][0],
                                paths[algo][1], clock, launched=launched,
                                silent=GRAPH_KERNELS)
        want = sssp_ref if algo == "sssp" else {"pr": pr_torch}
        same_tree(torch, want, {k: props[k] for k in want}, tag)
        steps = fsess.engine.steps
        prep, t_static, t_stream = TIMES[tag]
        log(f"[2g {tag}] static {t_static:.3f} s: {steps['sparse']} sparse "
            f"steps, {steps['dense_chunks']} dense chunks; stream "
            f"{t_stream:.3f} s (dense, fused, one segment: uncaptured); "
            f"{', '.join(want)} equal the torch backend's bit for bit")
        readings[tag] = {"static_s": t_static, "stream_s": t_stream,
                         **steps}
        del fsess, props
        torch.cuda.empty_cache()
    return readings


# -- phase 2h: the distributed backends ------------------------------------

DIST_SHARDS = 4          # shards stacked on the card in 2h.1, 2h.2, 2h.5
DIST_TC_SHARDS = 2       # shards of the TC window (2h.3)


def dist_detail(sess, E: int, one_bytes: int) -> str:
    """emax against E, one shard's bytes against one DynGraph's, the halo
    sizes and rebuilds of a dist / dist_sharded session."""
    eng, h = sess.engine, sess.handle
    out = (f"P={eng.P} emax {int(h.src.shape[1])} of E={E} "
           f"({int(h.src.shape[1]) / E:.3f}); per-shard bytes "
           f"{eng.per_shard_bytes(h)} vs one DynGraph {one_bytes} "
           f"({eng.per_shard_bytes(h) / one_bytes:.3f})")
    if hasattr(h, "ghosts"):
        out += (f"; halo H={int(h.ghosts.shape[1])} "
                f"Hs={int(h.send_idx.shape[2])}; rebuilds {eng.rebuilds}")
    return out


def dist_phase(torch, np, repro_torch, counts, csr, stream, paths,
               sssp_cuda, pr_cuda, pr_ref, tc_counts) -> None:
    """Phase 2h: ``dist`` and ``dist_sharded`` on the card.  2h.1: SSSP
    and PageRank with DIST_SHARDS shards stacked, through ``bind_graph(...)
    .run_stream`` (the fused executor): SSSP bit for bit against 2a's
    cuda, PageRank against the float64 reference and 2b's run.  2h.2: SSSP
    on the degree partitioner.  2h.3: per-batch TC (dyn_tc) on 2d's graph
    against its scipy-checked counts.  2h.4: one NCCL rank (``comm=
    "group"``) against the stacked P = 1 run.  2h.5: an armed DynSSSP
    saved on DIST_SHARDS shards, restored onto 2 and onto cuda, run on."""
    import tempfile
    from repro_torch import dsl_programs
    from repro_torch.algos import triangles
    t_phase = time.perf_counter()
    silent = ROW_KERNELS + ("merge_pool_sorted",)
    n, E, nb = csr.n, csr.num_edges, stream.num_batches(BATCH)
    cap = 2 * stream.num_adds
    # one DynGraph: main lanes (src, dst, w, alive), two offsets, the pool
    one_bytes = 13 * E + 8 * (n + 1) + 13 * cap + 4
    beta, delta, _ = PR_KNOBS
    l1_bound = (1 + 2 * nb) * beta / (1 - delta)
    top = np.argsort(pr_ref)[-1000:]

    def run(tag, backend, algo, **opts):
        static, step = paths[algo]

        def go():
            sess = repro_torch.bind_graph(csr, backend=backend, capacity=cap,
                                          device=DEV, **opts)
            with Timer(torch) as t_prep:
                sess.handle
            with Timer(torch) as t_static:
                props = sess.call(*static)
            with Timer(torch) as t_stream:
                props = sess.run_stream(stream, BATCH, step, props)
            return sess, props, (t_prep.s, t_static.s, t_stream.s)

        (sess, props, times), _, _ = window(torch, counts, tag, go,
                                            silent=silent)
        TIMES[tag] = times
        log(f"[{tag}] prepare {times[0]:.3f} s | static {times[1]:.3f} s | "
            f"stream {times[2]:.3f} s | "
            f"{dist_detail(sess, E, one_bytes)}")
        return sess, props

    def same_sssp(props, want, tag):
        for k in ("dist", "parent"):
            if not torch.equal(props[k], want[k]):
                bad = int((props[k] != want[k]).sum())
                raise AssertionError(f"[{tag}] SSSP {k} differs at {bad} "
                                     f"vertices")

    # 2h.1 stacked SSSP and PageRank, 2h.2 the degree partitioner
    for backend, opts in (("dist", {}),
                          ("dist_sharded", {"partitioner": "block"})):
        tag = f"2h sssp {backend} P={DIST_SHARDS}"
        sess, props = run(tag, backend, "sssp", num_shards=DIST_SHARDS,
                          **opts)
        same_sssp(props, sssp_cuda, tag)
        del sess, props
        tag = f"2h pagerank {backend} P={DIST_SHARDS}"
        sess, props = run(tag, backend, "pagerank", num_shards=DIST_SHARDS,
                          **opts)
        got = props["pr"].cpu().numpy().astype(np.float64)[:n]
        l1 = float(np.abs(got - pr_ref).sum())
        d = (props["pr"][:n].double() - pr_cuda.double()).abs()
        max_d, l1_d = float(d.max()), float(d.sum())
        log(f"[{tag}] vs float64 scipy: L1 {l1:.3e} (bound {l1_bound:.3e})"
            f"; vs 2b's cuda: max |d| {max_d:.3e}, L1 {l1_d:.3e}")
        if not l1 <= l1_bound:
            raise AssertionError(f"[{tag}] PageRank L1 error {l1} above "
                                 f"its bound {l1_bound}")
        np.testing.assert_allclose(got[top], pr_ref[top], rtol=5e-2, atol=0,
                                   err_msg=f"[{tag}] top 1,000 vertices")
        top_pr, mass = float(pr_cuda.max()), float(pr_cuda.double().sum())
        if not (max_d <= 1e-6 and l1_d <= 1e-4 and max_d <= 1e-4 * top_pr
                and l1_d <= 1e-5 * mass):
            raise AssertionError(f"[{tag}] PageRank differs from cuda's "
                                 f"beyond the cuda-vs-torch limits")
        del sess, props, d
        torch.cuda.empty_cache()
    tag = f"2h sssp dist_sharded degree P={DIST_SHARDS}"
    sess, props = run(tag, "dist_sharded", "sssp", num_shards=DIST_SHARDS,
                      partitioner="degree")
    same_sssp(props, sssp_cuda, tag)
    log(f"[check] 2h.1-2: SSSP dist and parent on dist and dist_sharded "
        f"(block, degree), {DIST_SHARDS} shards stacked, bit-identical to "
        f"2a's cuda; PageRank within the float64 bound and the "
        f"cuda-vs-torch limits")
    del sess, props
    torch.cuda.empty_cache()

    # 2h.3 per-batch TC on 2d's graph
    tcsr, tstream = TC_DATA["csr"], TC_DATA["stream"]
    tnb = tstream.num_batches(BATCH)

    def tc():
        sess = repro_torch.bind_graph(tcsr, backend="dist",
                                      num_shards=DIST_TC_SHARDS,
                                      capacity=2 * tstream.num_adds,
                                      device=DEV)
        with Timer(torch) as t_static:
            c0 = sess.call(triangles.static_tc)
        with Timer(torch) as t_dyn:
            c1 = sess.call(triangles.dyn_tc, tstream, BATCH, count=c0)
        return c0, c1, (t_static.s, t_dyn.s)

    tag = f"2h tc dist P={DIST_TC_SHARDS}: static_tc, dyn_tc"
    (c0, c1, times), _, secs = window(torch, counts, tag, tc, silent=silent)
    log(f"[{tag}] static_tc {times[0]:.3f} s, dyn_tc {times[1]:.3f} s "
        f"({times[1] / tnb:.3f} s a batch, {tnb} batches); triangles "
        f"{int(c0)} -> {int(c1)} on n={tcsr.n} E={tcsr.num_edges}")
    if (int(c0), int(c1)) != (tc_counts["static"], tc_counts["final"]) or \
            c1.dtype != torch.int32:
        raise AssertionError(f"[{tag}] counts {int(c0)} -> {int(c1)}, "
                             f"scipy {tc_counts}")
    del tcsr, tstream
    TC_DATA.clear()

    # 2h.4 one NCCL rank against the stacked P = 1 run
    import torch.distributed as tdist
    tag = "2h sssp dist P=1 stacked"
    _, want = run(tag, "dist", "sssp", num_shards=1, comm="stacked")
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        tag = "2h sssp dist one NCCL rank"
        sess, props = run(tag, "dist", "sssp", comm="group")
        if sess.engine.comm.kind != "group":
            raise AssertionError(f"[{tag}] did not run on the group")
    finally:
        tdist.destroy_process_group()
    same_sssp(props, want, tag)
    same_sssp(props, sssp_cuda, tag)
    log("[check] 2h.3-4: dist TC equal to scipy's counts; one NCCL rank "
        "bit-identical to the stacked P = 1 run and to cuda")
    del sess, props, want
    torch.cuda.empty_cache()

    # 2h.5 elastic restore, at SAVE_SCALE in batches of SAVE_BATCH
    sn, edges, w = repro_torch.rmat_graph(SAVE_SCALE, DEGREE, seed=0)
    small = repro_torch.build_csr(sn, edges, w, device=DEV)
    ups = repro_torch.random_updates(small, percent=PERCENT, seed=1)
    batches = list(ups.batches(SAVE_BATCH, device=DEV))
    k = len(batches) // 2
    prog = repro_torch.compile(dsl_programs.path("sssp"))

    def armed_on(bs, backend="dist", **opts):
        sess = prog.bind(small, backend=backend, capacity=2 * ups.num_adds,
                         device=DEV, **opts)
        sess.run("DynSSSP", batchSize=SAVE_BATCH, src=0)
        for b in bs:
            sess.apply(b)
        return sess

    def elastic():
        with tempfile.TemporaryDirectory() as d:
            armed_on(batches[:k], num_shards=DIST_SHARDS).save(d)
            backs = [repro_torch.restore_session(d, num_shards=2,
                                                 device=DEV),
                     repro_torch.restore_session(d, backend="cuda",
                                                 device=DEV)]
        for back in backs:
            if not (back.armed and back.stream_cursor == k):
                raise AssertionError("restore did not re-arm at the saved "
                                     "batch")
            for b in batches[k:]:
                back.apply(b)
        return backs

    tag = "2h elastic restore"
    backs, _, t_el = window(torch, counts, tag, elastic, silent=ROW_KERNELS)
    full = armed_on(batches, num_shards=DIST_SHARDS)
    for back, what in zip(backs, ("dist P=2", "cuda")):
        for key in ("dist", "parent"):
            if not torch.equal(back.props[key][:sn], full.props[key][:sn]):
                raise AssertionError(f"[{tag}] restored onto {what}: "
                                     f"{key} differs")
    if backs[0].engine.P != 2 or backs[1].backend_name != "cuda":
        raise AssertionError(f"[{tag}] restored onto the wrong engines")
    log(f"[check] 2h.5: DynSSSP armed on dist P={DIST_SHARDS} (rmat "
        f"{SAVE_SCALE}, E={small.num_edges}), saved after {k} of "
        f"{len(batches)} batches of {SAVE_BATCH}, restored onto dist P=2 "
        f"and onto cuda, run on: dist and parent bit-identical to the "
        f"uninterrupted run ({t_el:.2f} s)")
    del backs, full, small
    torch.cuda.empty_cache()
    log(f"[2h] distributed backends {time.perf_counter() - t_phase:.1f} s")


# -- phase 7: counts ----------------------------------------------------------
# PERF.md §6's bound_ms of each row at its shape, the counter's rule
# recorded by the kernel's entry on meta tensors (7b; tests/test_torch_cost
# holds the same table on the CPU): the row kernels at scale 22's ELL pack
# (R 12,431,232, K 8, n 4,194,304, rows of 128), the merges at 2's and
# PR 19's batched shapes, the flash rows at their (BH, S, dh) in bf16
ROW_SHAPE = (12_431_232, 8, 4_194_304, 128)
PERF_BOUNDS = [  # row, kernel, its shape, PERF.md §6's bound_ms
    ("1", "fused_relax_rows", {}, "0.2871"),
    ("2", "merge_pool_sorted", dict(D=652_422, B=65_536), "0.0053"),
    ("2 batched S 32", "merge_pool_sorted_batched",
     dict(S=32, D=16_384, B=2_048), "0.0043"),
    ("2 batched S 24", "merge_pool_sorted_batched",
     dict(S=24, D=16_384, B=2_048), "0.0032"),
    ("3", "fused_spmv_rows", {}, "0.1684"),
    ("4", "relax_rowmin", {}, "0.2573"),
    ("5", "spmv_rowsum", {}, "0.1386"),
    ("6", "relax_rowargmin", {}, "0.2722"),
    ("7", "flash_attention", dict(BH=144, S=2048, dh=128), "0.1564"),
    ("7a", "flash_attention", dict(BH=32, S=7168, dh=256), "0.8510"),
    ("7b", "flash_attention", dict(BH=32, S=7168, dh=256, window=4096),
     "0.6946"),
    ("7c", "flash_attention", dict(BH=80, S=1500, dh=64, causal=False),
     "0.0466"),
    ("7d", "flash_attention", dict(BH=128, S=2048, dh=128), "0.1390"),
    ("7e", "flash_attention_backward", dict(BH=144, S=2048, dh=128),
     "0.3909"),
]


def perf_bounds(torch, FK, CK, FA) -> list:
    """[(row, kernel, the counter's bound_ms, PERF.md's)], each bound
    printed to PERF.md's digits: one call of the row's kernel entry on
    meta tensors of the row's shape, under a ``CostCounter``."""
    from repro_torch.launch.op_cost import CostCounter, bound_s
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16

    def e(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device="meta")

    R, K, n, bt = ROW_SHAPE
    src, w, vals, r2d, fvals = e(R, K), e(R, K), e(n + 1), e(R), \
        e(n + 1, dtype=f32)

    def merge(kernel, D, B, S=None):
        lead = () if S is None else (S,)
        pool = [e(*lead, D) for _ in range(3)] + [e(*lead, D,
                                                    dtype=torch.bool)]
        batch = [e(*lead, B) for _ in range(3)] + [e(*lead, B,
                                                     dtype=torch.bool)]
        return lambda: getattr(FK, kernel)(*pool, *batch, n=n)

    def flash(kernel, BH, S, dh, causal=True, window=None):
        q, k, v, o, do = (e(BH, S, dh, dtype=bf16) for _ in range(5))
        kw = dict(causal=causal, window=window)
        if kernel == "flash_attention":
            return lambda: FA.flash_attention(q, k, v, **kw)
        lse = e(BH, S, dtype=f32)
        return lambda: FA.flash_attention_backward(q, k, v, o, lse, do, **kw)

    calls = {
        "fused_relax_rows": lambda: FK.fused_relax_rows(src, w, vals,
                                                        block=bt),
        "fused_spmv_rows": lambda: FK.fused_spmv_rows(src, r2d, fvals,
                                                      block=bt),
        "relax_rowmin": lambda: CK.relax_rowmin(src, w, vals),
        "spmv_rowsum": lambda: CK.spmv_rowsum(src, fvals),
        "relax_rowargmin": lambda: CK.relax_rowargmin(src, w, vals, r2d,
                                                      n=n),
    }
    out = []
    for row, kernel, shape, want in PERF_BOUNDS:
        if kernel.startswith("merge"):
            call = merge(kernel, **shape)
        elif kernel.startswith("flash"):
            call = flash(kernel, **shape)
        else:
            call = calls[kernel]
        with CostCounter() as c:
            call()
        rec = c.cost_record()
        if list(rec["by_kernel"]) != [kernel]:
            raise AssertionError(f"row {row}: the counter saw "
                                 f"{list(rec['by_kernel'])}, not {kernel}")
        digits = len(want.split(".")[1])
        out.append((row, kernel, f"{bound_s(rec) * 1e3:.{digits}f}", want))
    return out


# 7a's peak rate: the counted FLOPs of a bf16 step over its time over the
# H100 SXM's dense bf16 tensor-core peak (op_cost.PEAK_FLOPS)
ARG_BYTES_RTOL = 0.01     # 7d: counted argument bytes vs allocator growth


def counted_step(torch, fn):
    """``fn()`` under a ``CostCounter``: (its result, its record)."""
    from repro_torch.launch.op_cost import CostCounter
    with CostCounter() as c:
        out = fn()
    torch.cuda.synchronize()
    return out, c.cost_record()


def same_counts(tag: str, got: dict, meta: dict) -> None:
    """The card's record and the meta twin's: identical FLOPs and bytes."""
    keys = ("flops_per_device", "bytes_per_device", "flops_by_op")
    diff = {k: (got[k], meta[k]) for k in keys if got[k] != meta[k]}
    if diff:
        raise AssertionError(f"[7a] {tag}: cuda and meta counts differ: "
                             f"{diff}")


def share_line(tag: str, rec: dict, seconds: float, peak: str) -> str:
    from repro_torch.launch.op_cost import PEAK_FLOPS, bound_s
    f = rec["flops_per_device"]
    return (f"[7a] {tag}: {f:,} FLOPs ({rec['flops_by_dtype']}), "
            f"{rec['bytes_per_device']:,} bytes counted (cuda = meta) | "
            f"{seconds * 1e3:.3f} ms warm | {f / seconds / 1e12:.1f} TFLOP/s"
            f" = {f / seconds / PEAK_FLOPS['bfloat16']:.4f} of 989.4 TFLOP/s"
            f" bf16 | bound {bound_s(rec) * 1e3:.3f} ms "
            f"({bound_s(rec) / seconds:.4f} of the time) | {peak}")


def arg_bytes_check(torch, tag: str, counted: int, grown: int) -> str:
    rel = abs(grown - counted) / counted
    if rel > ARG_BYTES_RTOL:
        raise AssertionError(f"[7d] {tag}: argument bytes {counted:,} "
                             f"counted, the allocator grew {grown:,} "
                             f"({rel:.3%}, limit {ARG_BYTES_RTOL:.0%})")
    return (f"[7d] {tag}: argument bytes {counted:,} counted, "
            f"memory_allocated grew {grown:,} while building them "
            f"({rel:.4%})")


def counts_phase(torch, counts, FA, FK, CK, graph) -> None:
    """Phase 7: the op counter on the card.  (b) PERF.md §6's bounds by
    the kernels' rules; (a) starcoder2's phase-5 prefill, a decode step
    and phase 6a's train step counted on the card and on meta (identical
    FLOPs and bytes), each over its warm time as a share of the bf16
    peak; (d) their argument bytes against the allocator's growth and the
    counter's peak estimate beside ``max_memory_allocated``; (c) SSSP on
    ``CudaEngine(autotune=True)`` at 2a's scale, each row block timed,
    ``dist`` and ``parent`` equal to 2a's."""
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.op_cost import nbytes
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    import repro_torch
    from repro_torch.algos import sssp
    t_phase = time.perf_counter()
    meta = torch.device("meta")
    smi = nvidia_smi()

    # (b)
    for row, kernel, got, want in perf_bounds(torch, FK, CK, FA):
        log(f"[7b] row {row} {kernel}: bound {got} ms by the counter's "
            f"rule | PERF.md §6 {want} ms")
        if got != want:
            raise AssertionError(f"[7b] row {row}: the counter's bound {got}"
                                 f" ms, PERF.md §6 states {want}")

    # (a) + (d): serving
    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    model, prompts = build_lm(torch, LM_ARCH, B, P, G)
    args_b = tree_bytes(list(model.parameters())) + nbytes(prompts)
    log(arg_bytes_check(torch, "starcoder2-7b prefill", args_b,
                        torch.cuda.memory_allocated() - mem0))
    serve.prefill(model, prompts, P + G)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    (logits, caches), pre = counted_step(
        torch, lambda: serve.prefill(model, prompts, P + G))
    peak = (f"peak estimate {(args_b + pre['peak_live_bytes']) / 2**30:.3f}"
            f" GiB vs max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    with Timer(torch) as t_pre:
        serve.prefill(model, prompts, P + G)
    tok = torch.argmax(logits, dim=-1)[:, None]
    dec = counted_step(torch, lambda: model.serve_step(caches, tok, P))[1]
    with Timer(torch) as t_dec:
        model.serve_step(caches, tok, P + 1)
    cfg = model.cfg
    del model, caches, logits, prompts
    torch.cuda.empty_cache()
    twin = Model(cfg, device=meta)
    twin.params = T.init_params(cfg, twin.dtype, meta)
    m_prompts = torch.empty((B, P), dtype=torch.int64, device=meta)
    (m_logits, m_caches), m_pre = counted_step(
        torch, lambda: serve.prefill(twin, m_prompts, P + G))
    m_tok = torch.argmax(m_logits, dim=-1)[:, None]
    m_dec = counted_step(
        torch, lambda: twin.serve_step(m_caches, m_tok, P))[1]
    same_counts("prefill", pre, m_pre)
    same_counts("decode", dec, m_dec)
    del twin, m_caches, m_logits
    log(f"[7a] {smi}")
    log(share_line(f"starcoder2-7b prefill {B} x {P}", pre, t_pre.s, peak))
    log(share_line(f"starcoder2-7b decode step at {P}", dec, t_dec.s,
                   "host-bound"))

    # (a) + (d): phase 6a's train step
    mem0 = torch.cuda.memory_allocated()
    cfg, model = train_model(torch, TRAIN_LAYERS)
    opt = model.init_opt()
    data = SyntheticSource(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
    batch = {k: torch.from_numpy(v).to(DEV)
             for k, v in data.batch(0).items()}
    args_b = tree_bytes(list(model.parameters())) + tree_bytes(opt) + \
        tree_bytes(batch)
    log(arg_bytes_check(torch, f"train step ({TRAIN_LAYERS} layers)",
                        args_b, torch.cuda.memory_allocated() - mem0))
    opt, _ = model.train_step(opt, 0, batch)                  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (opt, _), trn = counted_step(
        torch, lambda: model.train_step(opt, 1, batch))
    peak = (f"peak estimate {(args_b + trn['peak_live_bytes']) / 2**30:.3f}"
            f" GiB vs max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    with Timer(torch) as t_trn:
        opt, _ = model.train_step(opt, 2, batch)
    del model, opt
    torch.cuda.empty_cache()
    twin = Model(cfg, device=meta, lr=TRAIN_LR)
    twin.params = T.init_params(cfg, twin.dtype, meta)
    m_batch = {k: torch.empty(v.shape, dtype=v.dtype, device=meta)
               for k, v in batch.items()}
    m_opt = twin.init_opt()
    m_trn = counted_step(
        torch, lambda: twin.train_step(m_opt, 1, m_batch))[1]
    same_counts("train", trn, m_trn)
    del twin, batch
    log(share_line(f"train step {TRAIN_LAYERS} layers {TRAIN_BATCH} x "
                   f"{TRAIN_SEQ}", trn, t_trn.s, peak))

    # (c): the measured row block on 2a's graph and stream
    csr_host, stream, want = graph
    csr = csr_host.to(DEV)
    FK.clear_tune_cache()
    counts.reset()
    with Timer(torch) as t_sssp:
        sess = repro_torch.bind_graph(csr, backend="cuda",
                                      capacity=2 * stream.num_adds,
                                      device=DEV, autotune=True)
        props = sess.run_stream(stream, BATCH, sssp.stream_step,
                                sess.call(sssp.static_sssp, 0))
    launched = counts.read()
    for k in ("dist", "parent"):
        if not torch.equal(props[k].cpu(), want[k]):
            raise AssertionError(f"[7c] autotuned SSSP differs from 2a in "
                                 f"{k}")
    cfg_t = sess.engine._config(sess.handle.g)
    log(f"[7c] SSSP on CudaEngine(autotune=True): {t_sssp.s:.3f} s with the "
        f"tuning, row block {cfg_t.row_block}; candidates (ms, best of 3, "
        f"CUDA events): {FK.TUNE_TIMES}; {launched['fused_relax_rows']} "
        f"fused_relax_rows launches; dist and parent equal 2a's")
    if not FK.TUNE_TIMES or sess.handle.ell.R % cfg_t.row_block:
        raise AssertionError(f"[7c] no measured row block dividing R: "
                             f"{FK.TUNE_TIMES}, {cfg_t}")
    del sess, props, csr
    torch.cuda.empty_cache()
    log(f"[7] counts {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tc-log2", type=int, default=20,
                    help="log2 of the vertices of the uniform TC graph")
    ap.add_argument("--profile", action="store_true",
                    help="rerun the cuda paths (TC and the DSL's "
                         "DynSSSP among them) and the LM prefill and "
                         "decode under torch.profiler and print where the "
                         "device time goes and the host syncs")
    args = ap.parse_args(argv)

    # inductor's and Triton's caches (phase 5's flex_attention) stay in the
    # checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    import repro_torch
    from repro_torch.algos import pagerank, sssp
    from repro_torch.graph.csr import INF_W
    from repro_torch.kernels import _build
    from repro_torch.kernels import csr_relax as CK
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import graph_cond as GC
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import repair as FK
    from repro_torch.kernels import segment as SK

    stamps = [("start", time.perf_counter())]
    mark = lambda name: stamps.append((name, time.perf_counter()))
    # -- 1. device + build -----------------------------------------------
    log(nvidia_smi())
    log(f"[device] torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {len(_build.BUILD_INFO['paths'])} libraries in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, in parallel: "
        f"{_build.BUILD_INFO['seconds']} s)")
    for src, text in _build.BUILD_INFO["logs"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[ptxas] {src}: {line.strip()}")
    mark("build")
    clock = lambda: Timer(torch)
    counts = Launches(_build)
    # a float32 reference states its matmul precision: full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    FUSED = ("fused_relax_rows", "fused_spmv_rows", "merge_pool_sorted")
    CHAINED = ("relax_rowmin", "spmv_rowsum", "relax_rowargmin")
    sssp_static, sssp_step = (sssp.static_sssp, 0), sssp.stream_step
    pr_static = (pagerank.static_pr, *PR_KNOBS)
    pr_step = pagerank.make_stream_step(*PR_KNOBS)

    # -- 2. the paths --------------------------------------------------------
    with clock() as t_gen:
        n, edges, w = repro_torch.rmat_graph(args.scale, DEGREE, seed=0)
        csr = repro_torch.build_csr(n, edges, w, device=DEV)
        del edges, w
        stream = repro_torch.random_updates(csr, percent=PERCENT, seed=1)
    nb = stream.num_batches(BATCH)
    log(f"[graph] rmat scale {args.scale} degree {DEGREE}: n={n} "
        f"E={csr.num_edges} | stream: {stream.num_adds} adds, "
        f"{stream.num_dels} dels, {nb} batches of {BATCH} | "
        f"generation {t_gen.s:.2f} s")
    mark("graph")
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    kernels = []

    # 2a. SSSP on cuda
    sess, props, sssp_launches = drive(
        torch, repro_torch, counts, csr, stream, "sssp cuda", "cuda",
        sssp_static, sssp_step, clock, launched=("fused_relax_rows",),
        silent=("fused_spmv_rows",) + CHAINED, per_batch=nb)
    if args.profile:
        profile_path(torch, repro_torch, csr, stream, sssp_static,
                     sssp_step, "sssp")

    h = sess.handle
    g, ell = h.g, h.ell
    cfg = sess.engine._config(g)
    R, K = ell.R, ell.K
    dist = props["dist"]
    vals = torch.cat([torch.where(dist < INF_W, dist, INF_W).int(),
                      dist.new_full((1,), INF_W)])
    kernels.append(check_kernel(
        torch, args, flush, "fused_relax_rows",
        "src/repro_torch/csrc/repair.cu",
        "src/repro/kernels/pallas_repair.py:102",
        sssp_launches["fused_relax_rows"],
        lambda: FK.fused_relax_rows(ell.ell_src, ell.ell_w, vals,
                                    block=cfg.row_block),
        lambda: FK.fused_relax_rows_plain(ell.ell_src, ell.ell_w, vals,
                                          cfg.row_block),
        nbytes(ell.ell_src, ell.ell_w, vals), 3 * R * K,
        R=R, K=K, n=n, block=cfg.row_block))
    warp_loaded(FK, kernels[-1], ell.ell_src, ell.ell_w)

    for line in check_merge(torch, FK):
        log(f"[merge] {line}")
    pool = (g.d_src, g.d_dst, g.d_w, g.d_alive)
    D = g.diff_capacity
    fresh = merge_batch(torch, np, g, n)
    keys = torch.cat([g.d_src.long() * (n + 1) + g.d_dst.long(),
                      fresh[0].long() * (n + 1) + fresh[1].long()])
    kernels.append(check_kernel(
        torch, args, flush, "merge_pool_sorted",
        "src/repro_torch/csrc/repair.cu",
        "src/repro/kernels/pallas_repair.py:200",
        sssp_launches["merge_pool_sorted"],
        lambda: FK.merge_pool_sorted(*pool, *fresh, n=n),
        lambda: FK.merge_pool_sorted_plain(*pool, *fresh, n),
        nbytes(*pool, *fresh), merge_ops(D),
        library=lambda: torch.sort(keys, stable=True),
        D=D, B=BATCH, n=n, used=int((g.d_src < n).sum())))
    kernels[-1]["variant"] = (f"tiles of {T} output slots staged in shared "
                              f"memory, warp-searched splits")
    # its launches: phase 2g's replayed SSSP segment, its path
    cond_rec = check_cond(torch, args, flush, GC)
    kernels.append(cond_rec)
    cuda_g = g
    sssp_cuda = {k: props[k] for k in ("dist", "parent")}
    del sess, h, ell, props, vals, keys, pool, fresh, dist
    torch.cuda.empty_cache()

    mark("sssp cuda")

    # 2b. PageRank on cuda
    sess, props, pr_launches = drive(
        torch, repro_torch, counts, csr, stream, "pagerank cuda", "cuda",
        pr_static, pr_step, clock,
        launched=("fused_spmv_rows", "segment_sum_sorted"),
        silent=("fused_relax_rows",) + CHAINED, per_batch=nb)
    log(f"[pagerank cuda] {pr_launches['fused_spmv_rows']} sum sweeps, "
        f"{pr_launches['segment_sum_sorted']} float segment sums")
    if args.profile:
        profile_path(torch, repro_torch, csr, stream, pr_static, pr_step,
                     "pagerank")
    pr_cuda = props["pr"].clone()
    ell = sess.handle.ell
    cfg = sess.engine._config(sess.handle.g)
    R, K = ell.R, ell.K
    fvals = torch.cat([props["pr"] * props["inv_outdeg"],
                       props["pr"].new_zeros(1)])
    emb = torch.nn.functional.embedding_bag
    kernels.append(check_kernel(
        torch, args, flush, "fused_spmv_rows",
        "src/repro_torch/csrc/repair.cu",
        "src/repro/kernels/pallas_repair.py:123",
        pr_launches["fused_spmv_rows"],
        lambda: FK.fused_spmv_rows(ell.ell_src, ell.row2dst, fvals,
                                   block=cfg.row_block),
        lambda: FK.fused_spmv_rows_plain(ell.ell_src, ell.row2dst, fvals,
                                         cfg.row_block),
        nbytes(ell.ell_src, ell.row2dst, fvals), R * K,
        library=lambda: emb(ell.ell_src, fvals[:, None], mode="sum"),
        R=R, K=K, n=n, block=cfg.row_block))
    warp_loaded(FK, kernels[-1], ell.ell_src)
    for line in check_rows(torch, repro_torch, FK, CK):
        log(f"[rows] {line}")
    # the vertex combine after it: the deterministic float segment sum of
    # each vertex's rows (one thread per vertex; the reference leaves it
    # to XLA's segment_sum, no Pallas kernel)
    row_sum = FK.fused_spmv_rows(ell.ell_src, ell.row2dst, fvals,
                                 block=cfg.row_block)[0]
    seg_ids = ell.row2dst.long()
    rows_per = ell.offsets[1:] - ell.offsets[:-1]
    kernels.append(check_kernel(
        torch, args, flush, "segment_sum_sorted",
        "src/repro_torch/csrc/segment.cu", "src/repro/kernels/ops.py:97",
        pr_launches["segment_sum_sorted"],
        lambda: SK.segment_sum_sorted(row_sum, None, ell.offsets),
        lambda: SK.segment_sum_sorted_plain(row_sum, None, ell.offsets),
        nbytes(row_sum, ell.offsets), R,
        library=lambda: torch.zeros(n + 1, device=DEV).index_add_(
            0, seg_ids, row_sum),
        plain_reps=3,   # ~1 s a call: one step per row of the longest
        R=R, n=n, longest=int(rows_per.max())))
    del sess, ell, fvals, row_sum, seg_ids, rows_per
    torch.cuda.empty_cache()

    mark("pagerank cuda")

    # 2c. SSSP, then PageRank, on cuda_chained
    c_sess, c_props, c_launches = drive(
        torch, repro_torch, counts, csr, stream, "sssp cuda_chained",
        "cuda_chained", sssp_static, sssp_step, clock,
        launched=("relax_rowmin", "relax_rowargmin"),
        silent=("spmv_rowsum",) + FUSED)
    for k in ("dist", "parent"):
        if not torch.equal(c_props[k], sssp_cuda[k]):
            raise AssertionError(f"cuda_chained SSSP differs from cuda in "
                                 f"{k}")
    ell = c_sess.handle.ell
    R, K = ell.R, ell.K
    dist = c_props["dist"]
    vals = torch.cat([torch.where(dist < INF_W, dist, INF_W).int(),
                      dist.new_full((1,), INF_W)])
    kernels.append(check_kernel(
        torch, args, flush, "relax_rowmin",
        "src/repro_torch/csrc/csr_relax.cu",
        "src/repro/kernels/csr_relax.py:69", c_launches["relax_rowmin"],
        lambda: CK.relax_rowmin(ell.ell_src, ell.ell_w, vals),
        lambda: CK.relax_rowmin_plain(ell.ell_src, ell.ell_w, vals),
        nbytes(ell.ell_src, ell.ell_w, vals), 2 * R * K, R=R, K=K, n=n))
    warp_loaded(CK, kernels[-1], ell.ell_src, ell.ell_w)
    vmin = kops.vertex_min_plus(ell, vals)
    tgt = torch.cat([vmin, vmin.new_full((1,), INF_W)])[
        ell.row2dst.clamp(max=n)]
    kernels.append(check_kernel(
        torch, args, flush, "relax_rowargmin",
        "src/repro_torch/csrc/csr_relax.cu",
        "src/repro/kernels/csr_relax.py:99", c_launches["relax_rowargmin"],
        lambda: CK.relax_rowargmin(ell.ell_src, ell.ell_w, vals, tgt, n=n),
        lambda: CK.relax_rowargmin_plain(ell.ell_src, ell.ell_w, vals, tgt,
                                         n),
        nbytes(ell.ell_src, ell.ell_w, vals, tgt), 3 * R * K,
        R=R, K=K, n=n))
    warp_loaded(CK, kernels[-1], ell.ell_src, ell.ell_w)
    del c_sess, c_props, ell, vals, vmin, tgt, dist
    torch.cuda.empty_cache()

    p_sess, p_props, p_launches = drive(
        torch, repro_torch, counts, csr, stream, "pagerank cuda_chained",
        "cuda_chained", pr_static, pr_step, clock,
        launched=("spmv_rowsum", "segment_sum_sorted"),
        silent=("relax_rowmin", "relax_rowargmin") + FUSED)
    if not torch.equal(p_props["pr"], pr_cuda):
        raise AssertionError("cuda_chained PageRank differs from cuda")
    log("[check] cuda_chained SSSP dist/parent and PageRank pr "
        "bit-identical to cuda")
    ell = p_sess.handle.ell
    R, K = ell.R, ell.K
    fvals = torch.cat([p_props["pr"] * p_props["inv_outdeg"],
                       p_props["pr"].new_zeros(1)])
    kernels.append(check_kernel(
        torch, args, flush, "spmv_rowsum",
        "src/repro_torch/csrc/csr_relax.cu",
        "src/repro/kernels/csr_relax.py:84", p_launches["spmv_rowsum"],
        lambda: CK.spmv_rowsum(ell.ell_src, fvals),
        lambda: CK.spmv_rowsum_plain(ell.ell_src, fvals),
        nbytes(ell.ell_src, fvals), R * K,
        library=lambda: emb(ell.ell_src, fvals[:, None], mode="sum"),
        R=R, K=K, n=n))
    warp_loaded(CK, kernels[-1], ell.ell_src)
    del p_sess, p_props, ell, fvals
    del flush
    torch.cuda.empty_cache()

    mark("cuda_chained")

    # 2d. triangle counting on its own graph
    tc_counts = tc_phase(torch, np, repro_torch, counts, args,
                         silent=ROW_KERNELS + ("segment_sum_sorted",))
    mark("triangle counting")

    # -- 4. correctness ------------------------------------------------------
    tsess, tprops, _ = drive(
        torch, repro_torch, counts, csr, stream, "sssp torch", "torch",
        sssp_static, sssp_step, clock,
        silent=FUSED + CHAINED + ("graph_cond_set",), per_batch_driver=True)
    for k in ("dist", "parent"):
        if not torch.equal(sssp_cuda[k], tprops[k]):
            raise AssertionError(f"cuda and torch backends differ in {k}")
    tg = tsess.handle
    for f in ("offsets", "src", "dst", "w", "alive", "d_offsets", "d_src",
              "d_dst", "d_w", "d_alive", "overflow"):
        if not torch.equal(getattr(cuda_g, f), getattr(tg, f)):
            raise AssertionError(f"cuda and torch backends differ in g.{f}")
    log("[check] SSSP dist, parent and all DynGraph arrays bit-identical to "
        "the torch backend")
    g_host = {f: getattr(cuda_g, f).cpu() for f in DYN_FIELDS}
    del tsess, tprops, tg, cuda_g
    torch.cuda.empty_cache()

    _, again, _ = drive(
        torch, repro_torch, counts, csr, stream, "pagerank cuda, second run",
        "cuda", pr_static, pr_step, clock,
        launched=("fused_spmv_rows", "segment_sum_sorted"),
        silent=("fused_relax_rows",) + CHAINED, per_batch=nb)
    if not torch.equal(again["pr"], pr_cuda):
        raise AssertionError("two cuda PageRank runs differ")
    del again
    _, tprops, _ = drive(
        torch, repro_torch, counts, csr, stream, "pagerank torch", "torch",
        pr_static, pr_step, clock, launched=("segment_sum_sorted",),
        silent=FUSED + CHAINED + ("graph_cond_set",), per_batch_driver=True)
    d = (tprops["pr"].double() - pr_cuda.double()).abs()
    max_d, l1_d = float(d.max()), float(d.sum())
    top, mass = float(pr_cuda.max()), float(pr_cuda.double().sum())
    log(f"[check] PageRank: second cuda run bit-identical; cuda vs torch "
        f"backend max |d| {max_d:.3e} ({max_d / top:.3e} of max pr "
        f"{top:.3e}), L1 {l1_d:.3e} ({l1_d / mass:.3e} of sum pr "
        f"{mass:.6f})")
    # absolute limits, and relative ones: at n = 4M a typical pr is
    # ~2.4e-7, below the absolute max limit
    if not (max_d <= 1e-6 and l1_d <= 1e-4 and max_d <= 1e-4 * top
            and l1_d <= 1e-5 * mass):
        raise AssertionError("cuda and torch PageRank differ beyond "
                             "max 1e-6 and 1e-4 of max(pr) / L1 1e-4 and "
                             "1e-5 of sum(pr)")
    pr_torch = tprops["pr"].clone()
    del tprops, d
    torch.cuda.empty_cache()

    mark("torch and second cuda runs")
    post = edges_after(torch, csr, stream, n)
    mark("post-update edge set")
    with clock() as t_ref:
        ref = dijkstra_dist(np, post, n, INF_W)
    got = sssp_cuda["dist"].cpu().numpy().astype(np.int64)
    if not np.array_equal(got, ref):
        bad = int((got != ref).sum())
        raise AssertionError(f"dist differs from scipy Dijkstra at {bad} "
                             f"vertices")
    mark("scipy Dijkstra")
    log(f"[check] SSSP dist equals scipy Dijkstra "
        f"({int((ref < INF_W).sum())} reachable of {n}; {t_ref.s:.1f} s)")

    beta, delta, _ = PR_KNOBS
    with clock() as t_ref:
        ref = pagerank_f64(np, post, n, delta)
    got = pr_cuda.cpu().numpy().astype(np.float64)
    l1 = float(np.abs(got - ref).sum())
    # Each fixed-point run (the static one, then two per batch) stops once
    # a sweep moves the modified vertices by at most beta in L1; the sweep
    # contracts by delta in L1, so a run leaves at most beta/(1-delta) of
    # error behind.  The runs' errors add up at worst; float32 rounding
    # adds far less.
    l1_bound = (1 + 2 * nb) * beta / (1 - delta)
    top = np.argsort(ref)[-1000:]
    log(f"[check] PageRank vs float64 scipy power iteration "
        f"({t_ref.s:.1f} s): L1 {l1:.3e} (bound {l1_bound:.3e}), max |d| "
        f"{np.abs(got - ref).max():.3e}, sum {got.sum():.6f} vs "
        f"{ref.sum():.6f}")
    if not l1 <= l1_bound:
        raise AssertionError(f"PageRank L1 error {l1} above its bound "
                             f"{l1_bound}")
    np.testing.assert_allclose(got[top], ref[top], rtol=5e-2, atol=0,
                               err_msg="PageRank's top 1,000 vertices")
    mark("scipy PageRank")
    log("[check] PageRank's top 1,000 vertices within rtol 5e-2")

    # 2e. the DSL on the card, held to the references of step 4
    dsl_phase(torch, np, repro_torch, counts, args, csr, stream, sssp_cuda,
              ref, (sssp_static, pr_static), silent=ROW_KERNELS)
    mark("dsl")

    # 2f. failover on the smoke's graph, then the serving pool
    failover_phase(torch, repro_torch, counts, csr, stream, sssp_cuda,
                   g_host)
    del g_host
    mark("failover")
    kernels.append(pool_phase(torch, np, repro_torch, counts, args, FK))
    mark("pool")

    # 2g. the fused executor against the per-batch driver; frontier
    fused_phase(torch, repro_torch, counts, csr, stream,
                {"sssp": (sssp_static, sssp_step),
                 "pagerank": (pr_static, pr_step)}, sssp_cuda, pr_torch,
                cond_rec)
    del pr_torch
    mark("fused executor, frontier")

    # 2h. the distributed backends, stacked shards and one NCCL rank
    dist_phase(torch, np, repro_torch, counts, csr, stream,
               {"sssp": (sssp_static, sssp_step),
                "pagerank": (pr_static, pr_step)}, sssp_cuda, pr_cuda, ref,
               tc_counts)
    mark("distributed backends")

    # -- 5. LM serving -------------------------------------------------------
    # 7c runs SSSP on 2a's graph and stream again: kept on the host
    graph = (csr.to("cpu"), stream,
             {k: v.cpu() for k, v in sssp_cuda.items()})
    del csr, stream, post, sssp_cuda, pr_cuda, g
    torch.cuda.empty_cache()
    kernels.append(lm_phase(torch, args, counts, FA))
    mark("lm serving")
    win = window_phase(torch, counts, FA)
    mark("gemma2 serving")
    enc = encoder_phase(torch, counts, FA)
    mark("whisper serving")
    kernels[-1]["shapes"] = slice_flash_shapes(torch, args, FA, win, enc)
    mark("flash at the slice's shapes")
    ssm_phase(torch, counts, FA)
    mark("xlstm serving")
    kernels[-1]["shapes"].append(hybrid_phase(torch, args, counts, FA))
    mark("jamba serving")

    # -- 6. training ---------------------------------------------------------
    kernels.append(train_phase(torch, args, counts, FA))
    mark("training")
    reduced_train_phase(torch, counts, FA)
    mark("reduced training: resume, elastic")

    # -- 7. counts -----------------------------------------------------------
    counts_phase(torch, counts, FA, FK, CK, graph)
    del graph
    mark("counts")
    log(f"[check] whole smoke {stamps[-1][1] - stamps[0][1]:.1f} s")
    log("[time] " + " | ".join(f"{b[0]} {b[1] - a[1]:.1f} s"
                               for a, b in zip(stamps, stamps[1:])))

    for rec in kernels:
        rec["launches_by_path"] = {tag: w[rec["name"]]
                                   for tag, w in WINDOWS.items()
                                   if w.get(rec["name"])}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
