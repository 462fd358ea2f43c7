"""Performance-tuning knobs (counterpart of ``repro/models/tuning.py``,
whose ``Tuning`` this copies; the port imports nothing of ``repro``).

Each knob selects between the paper-faithful/baseline lowering and a
beyond-baseline optimized one, so both stay runnable and their costs stay
comparable (``launch/dryrun.py --tuning baseline|opt``).  On one card:

  moe_dispatch:
    'scatter' (baseline) — the token rows written into the (E, C, D)
        expert buffer at their slots (``xe[slot] = xt[tok]``).
    'gather' — only the int32 token index of each slot is scattered, then
        the buffer is built by a row gather ``xt[tok_for_slot]``.  Both
        give the same buffer, bit for bit.
    'shard_map' (optimized) — expert parallelism over a device mesh; with
        no mesh (always, until the sharding item, ROADMAP Queue 1 item
        14f) it falls back to 'gather', as the reference does.

  window_slice:
    windowed decode attention reads only the window-sized slice of the
    cache (``True``) instead of full-length logits, masked (``False``).

  cache_shard ('seq' | 'dh') and attn_seq_parallel place the KV cache and
  the attention across a mesh: on one card they change nothing (item 14f
  ports the meshes).  decode_unroll chooses between a scan over the units
  and an unrolled decode in the reference's traced program; the port's
  eager decode runs the layers one by one either way.

The active Tuning is bound by ``Model``'s step functions
(``use_tuning``).  It is a process-wide stack, not a context variable:
autograd runs the rematerialised forward of a training step on its own
worker thread, which a context variable would not reach.
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass(frozen=True)
class Tuning:
    cache_shard: str = "dh"         # 'seq' | 'dh'
    moe_dispatch: str = "shard_map"  # 'scatter' | 'gather' | 'shard_map'
    decode_unroll: bool = True
    window_slice: bool = True
    attn_seq_parallel: bool = True


BASELINE = Tuning(cache_shard="seq", moe_dispatch="scatter",
                  decode_unroll=False, window_slice=False,
                  attn_seq_parallel=False)
OPTIMIZED = Tuning()

_STACK = [OPTIMIZED]


def get_tuning() -> Tuning:
    return _STACK[-1]


@contextlib.contextmanager
def use_tuning(t: Tuning):
    _STACK.append(t)
    try:
        yield
    finally:
        _STACK.pop()
