"""The conditional nodes of a captured stream segment (``csrc/graph_cond.cu``),
bound with ctypes for ``core/device_loop.py``.

``set_condition`` launches the one kernel of the source: a single thread
that reads a device bool (negated when asked) and sets a conditional
node's condition, before a WHILE or IF node for its first test and at
the end of a WHILE body for the next.  Its plain version is the host read
that an eager loop makes instead (``bool(pred)``).  It replaces no TPU
kernel: the reference evaluates ``lax.while_loop`` and ``lax.cond``
predicates inside XLA.  One byte read bounds it; what it costs is the
launch and the node's scheduling, on the card and without the host.

The other calls are host API: a handle on the graph being captured, a
node after the capture's dependencies, the body's capture from a side
stream, and the node made the capture's one dependency after it.  Like
every wrapper, ``set_condition`` counts its launches in ``LAUNCHES``; in a
capture that count becomes the graph's tally, which each replay adds.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import raise_on

IF, WHILE = 0, 1
LAUNCHES = _build.launch_table(__name__, "graph_cond_set")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _s(stream: torch.cuda.Stream) -> ctypes.c_void_p:
    return ctypes.c_void_p(stream.cuda_stream)


def handle(stream: torch.cuda.Stream) -> ctypes.c_ulonglong:
    """A conditional handle on the graph that ``stream`` is capturing,
    reset to 0 at every launch of the graph."""
    h = ctypes.c_ulonglong()
    raise_on(_build.load().repro_cond_handle(_s(stream), ctypes.byref(h)),
             "cudaGraphConditionalHandleCreate")
    return h


def set_condition_plain(pred: torch.Tensor, negate: bool = False) -> bool:
    return bool(pred) != negate


def set_condition(h, pred: torch.Tensor, negate: bool,
                  stream: torch.cuda.Stream) -> None:
    """Launch the set kernel on ``stream``: the condition of ``h`` becomes
    ``pred`` (a 0-d bool on the card), or its negation."""
    if pred.dtype != torch.bool or pred.numel() != 1 or \
            pred.device.type != "cuda":
        raise ValueError("set_condition: pred must be one bool on the card")
    raise_on(_build.load().repro_cond_set(
        h, ctypes.c_void_p(pred.data_ptr()), int(negate), _s(stream)),
        "graph_cond_set")
    LAUNCHES["graph_cond_set"] += 1


def add_node(stream: torch.cuda.Stream, h, kind: int):
    """A WHILE or IF node after ``stream``'s capture dependencies; returns
    (body graph, node)."""
    body, node = ctypes.c_void_p(), ctypes.c_void_p()
    raise_on(_build.load().repro_cond_node(
        _s(stream), h, kind, ctypes.byref(body), ctypes.byref(node)),
        "adding a conditional node")
    return body, node


def body_begin(side: torch.cuda.Stream, body) -> None:
    raise_on(_build.load().repro_cond_body_begin(_s(side), body),
             "cudaStreamBeginCaptureToGraph")


def body_end(side: torch.cuda.Stream) -> None:
    raise_on(_build.load().repro_cond_body_end(_s(side)),
             "cudaStreamEndCapture of a conditional body")


def node_end(stream: torch.cuda.Stream, node) -> None:
    raise_on(_build.load().repro_cond_node_end(_s(stream), node),
             "cudaStreamUpdateCaptureDependencies")
