"""What a step costs, counted over the ops it runs: FLOPs, HBM bytes and
collective bytes per device.  The counterpart of
``repro/launch/hlo_cost.py``, which reads the same three figures out of
XLA's optimised HLO; nothing in the port produces HLO, so the port counts
the ops it dispatches instead.

``CostCounter`` is a context (a ``TorchDispatchMode``): every aten op that
runs inside it is counted, the backward's and ``torch.utils.checkpoint``'s
recompute included (autograd hands the mode to its worker threads).  It
counts on any device, the meta device too, where nothing is computed: a
step counted on ``meta`` gives the same record as on the CPU or the card.

Cost model, the reference's where it carries over:

* FLOPs: 2·prod(result)·prod(contracting dims) per matrix product
  (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``, ``mv``, ``dot``:
  what ``matmul``, ``einsum`` and ``linear`` dispatch to); elementwise
  work is not counted (the reference's MXU-roofline convention).
* HBM bytes: operands plus result of every op the mode sees.  Eager
  PyTorch fuses nothing, so each op boundary is real HBM traffic; the
  reference's second figure, ``bytes_fused_per_device``, is XLA's view of
  what fusion on the TPU leaves at fusion boundaries, and has no
  counterpart here.  Views and allocations move nothing (``view``,
  ``_unsafe_view``, ``transpose``, ``expand``, ``slice``, ``select``,
  ``as_strided``, ``alias``, ``empty``...).  The slice family follows the
  reference's ``_op_hbm_bytes``: a gather (``index``, ``index_select``,
  ``gather``, ``embedding``) 2·result + indices; a scatter (``index_put_``,
  ``scatter*``, ``index_add_``) 2·update + indices; ``copy_`` (an in-place
  slice write among them) and ``index_copy_`` 2·update; a collective
  2·result.
* collective bytes: result bytes per c10d op, by kind.

The hand kernels are ``ctypes`` calls that no dispatch mode sees.  Each
kernel's Python entry is wrapped by :func:`counted`: it records its
function's work by a rule its module states (not its tiling: the flash
forward counts the unmasked (i, j) pairs), and while it runs the counter
ignores every op inside it (the plain version on the CPU, scratch
allocations on the card), so the same step counts the same on every
device.  On the meta device an entry records its rule and returns empty
outputs of the right shapes: it launches and computes nothing.  That
branch serves counting only; a CUDA tensor still launches the kernel or
raises, a CPU tensor still runs the plain version.

The counter also tracks the storages its ops create (live until the last
tensor on them dies) and keeps their peak: with the step's arguments
added, an estimate of the step's peak memory.

``bound_s(record)``: the least time an H100 SXM could take for the
record's work, max(bytes / HBM rate, sum over types of FLOPs / peak).
"""
from __future__ import annotations

import collections
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM5 datasheet: HBM3 3.35 TB/s; dense tensor-core bf16 / fp16
# 989.4 TFLOP/s; float32 outside the tensor cores 66.9 TFLOP/s (at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989.4e12, "float16": 989.4e12, "float32": 66.9e12}

_MATMUL = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1,
           "addbmm": 1, "addmv": 1}
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided", "_local_scalar_dense",
         "lift_fresh"}
_GATHER = {"index": 1, "index_select": 2, "gather": 2, "embedding": 1}
_SCATTER = {"index_put_": (1, 2), "index_put": (1, 2), "scatter": (2, 3),
            "scatter_": (2, 3), "scatter_add": (2, 3), "scatter_add_": (2, 3),
            "scatter_reduce": (2, 3), "scatter_reduce_": (2, 3),
            "index_add": (2, 3), "index_add_": (2, 3)}
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_COLL_KINDS = (("reduce_scatter", "reduce-scatter"),
               ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
               ("allgather", "all-gather"), ("all_gather", "all-gather"),
               ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"))

_ACTIVE: list = []          # the counters entered, innermost last
_INSIDE = [0]               # depth of kernel entries running now


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(*tensors) -> int:
    """Bytes of the tensors' elements (a view's, not its storage's)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _dtype(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class CostCounter(TorchDispatchMode):
    """Counts every op run inside ``with CostCounter() as c:``; read
    ``c.cost_record()`` after."""

    def __init__(self):
        super().__init__()
        self.flops = collections.Counter()        # by (op, dtype)
        self.bytes_by_op = collections.Counter()
        self.coll = collections.Counter()         # bytes by kind
        self.coll_count = 0
        self.kernels = {}
        self._live = {}                           # id(storage) -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    # -- ops ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _INSIDE[0] or func.namespace == "repro_torch":
            return out      # a kernel entry's inside: its rule counted it
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return out
        outs = _tensors(out)
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k != "out"}))
        # an in-place or out= op's result lies on a storage it was given
        held = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        fresh = [t for t in outs if t.untyped_storage()._cdata not in held]
        if func.namespace in _COLL_NAMESPACES:
            kind = next((k for key, k in _COLL_KINDS if key in name), name)
            b = nbytes(*outs)
            self.coll[kind] += b
            self.coll_count += 1
            self._add(name, 2 * b, fresh)
            return out
        if name in _MATMUL:
            a, b = args[_MATMUL[name]], args[_MATMUL[name] + 1]
            n = b.shape[-1] if b.dim() > 1 else 1
            self.flops[(name, _dtype(a.dtype))] += 2 * a.numel() * n
        if name in _GATHER:
            moved = 2 * nbytes(*outs) + nbytes(*_tensors(args[_GATHER[name]]))
        elif name in _SCATTER:
            idx, upd = _SCATTER[name]
            moved = 2 * nbytes(args[upd]) + nbytes(*_tensors(args[idx]))
        elif name == "copy_":
            moved = nbytes(args[0]) + nbytes(args[1])
        elif name == "index_copy_" or name == "index_copy":
            moved = 2 * nbytes(args[3])
        else:
            moved = nbytes(*ins) + nbytes(*outs)
        self._add(name, moved, fresh)
        return out

    def _add(self, name: str, moved: int, fresh) -> None:
        self.bytes_by_op[name] += moved
        self.track(fresh)

    # -- kernels -----------------------------------------------------------
    def add_kernel(self, name: str, flops: int, moved: int, dtype) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += moved
        self.bytes_by_op[name] += moved
        if flops:
            self.flops[(name, _dtype(dtype))] += flops

    # -- live storages -----------------------------------------------------
    def track(self, out) -> None:
        """Note the storages of ``out`` that no tracked tensor holds yet;
        each leaves the live count when it is freed (a storage's Python
        object lives exactly as long as the storage)."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key)

    def _freed(self, key) -> None:
        self.live_bytes -= self._live.pop(key)

    # -- the record --------------------------------------------------------
    def cost_record(self) -> dict:
        """The reference's keys where they mean the same thing, plus
        ``flops_by_op``, ``flops_by_dtype``, ``by_kernel`` and
        ``peak_live_bytes`` (the peak of the storages the ops created)."""
        by_op, by_dtype = collections.Counter(), collections.Counter()
        for (op, dt), f in self.flops.items():
            by_op[op] += f
            by_dtype[dt] += f
        rec = {
            "flops_per_device": sum(by_op.values()),
            "bytes_per_device": sum(self.bytes_by_op.values()),
            "collective_bytes_per_device": sum(self.coll.values()),
            "collective_count": self.coll_count,
        }
        for kind, b in sorted(self.coll.items()):
            rec[f"coll_{kind}"] = b
        for op, b in sorted(self.bytes_by_op.items(),
                            key=lambda kv: (-kv[1], kv[0]))[:8]:
            rec[f"bytes_{op}"] = b
        rec["flops_by_op"] = dict(sorted(by_op.items()))
        rec["flops_by_dtype"] = dict(sorted(by_dtype.items()))
        rec["by_kernel"] = {k: dict(v) for k, v in
                            sorted(self.kernels.items())}
        rec["peak_live_bytes"] = self.peak_bytes
        return rec


def bound_s(record: dict) -> float:
    """Seconds an H100 SXM needs at least for ``record``'s work: the larger
    of its bytes over the HBM rate and its FLOPs over each type's peak."""
    flops_s = sum(f / PEAK_FLOPS[dt]
                  for dt, f in record["flops_by_dtype"].items())
    return max(record["bytes_per_device"] / HBM_BYTES_PER_S, flops_s)


def counted(name: str, rule, meta):
    """Wrap a kernel entry: ``rule(*args, **kw) -> (flops, bytes, dtype)``
    is its work, recorded into every active counter; ``meta(*args, **kw)``
    its empty outputs, returned in place of a launch when its tensors lie
    on the meta device."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kw):
            on_meta = any(t.device.type == "meta"
                          for t in _tensors((args, kw)))
            if not (_ACTIVE or on_meta):
                return fn(*args, **kw)
            flops, moved, dtype = rule(*args, **kw)
            for c in _ACTIVE:
                c.add_kernel(name, flops, moved, dtype)
            _INSIDE[0] += 1
            try:
                out = meta(*args, **kw) if on_meta else fn(*args, **kw)
            finally:
                _INSIDE[0] -= 1
            for c in _ACTIVE:
                c.track(out)
            return out
        return entry
    return wrap
