"""String-keyed engine registry: the paper's "choose a backend" knob
(counterpart of ``repro.core.registry``).

Built-ins are registered by module path and imported on first use:

* ``torch`` — :class:`~repro_torch.core.engine.TorchEngine`, the plain
  tensor reference;
* ``cuda``  — :class:`~repro_torch.core.cuda_engine.CudaEngine`, the
  hand-kernel backend with fused kernels;
* ``cuda_chained`` — the same engine on the per-op kernel chain
  (:func:`~repro_torch.core.cuda_engine.CudaChainedEngine`);
* ``frontier`` — :class:`~repro_torch.core.frontier_engine.FrontierEngine`,
  direction-optimised sparse steps over a push ELL (tensor ops only);
* ``dist`` — :class:`~repro_torch.core.dist.DistEngine`, vertices
  block-owned over P shards (stacked on one device, or one shard a
  ``torch.distributed`` rank);
* ``dist_sharded`` — :class:`~repro_torch.shard.engine.ShardedEngine`,
  the graph itself partitioned, with halo exchange.

``register_engine`` plugs in more.  ``shared_engine`` hands the serving
pool one engine per (backend, scope, options); ``failover_chain`` names
where a session falls when its backend's kernels fail.
"""
from __future__ import annotations

import importlib
import threading
from typing import Any, Callable, Dict, List, Tuple

from repro_torch.core.engine import Engine

EngineFactory = Callable[..., Engine]


class UnknownBackendError(KeyError):
    """Raised when a backend name is not registered."""

    def __str__(self):  # KeyError repr-quotes its message; keep it readable
        return self.args[0] if self.args else ""


class DuplicateBackendError(ValueError):
    """Raised when a backend name is registered twice without overwrite."""


_BUILTIN_PATHS: Dict[str, str] = {
    "torch": "repro_torch.core.engine:TorchEngine",
    "cuda": "repro_torch.core.cuda_engine:CudaEngine",
    "cuda_chained": "repro_torch.core.cuda_engine:CudaChainedEngine",
    "frontier": "repro_torch.core.frontier_engine:FrontierEngine",
    "dist": "repro_torch.core.dist:DistEngine",
    "dist_sharded": "repro_torch.shard.engine:ShardedEngine",
}

_FACTORIES: Dict[str, EngineFactory] = {}


def _resolve_builtin(name: str) -> EngineFactory:
    mod_name, cls_name = _BUILTIN_PATHS[name].split(":")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    _FACTORIES[name] = cls
    return cls


def register_engine(name: str, factory: EngineFactory, *,
                    overwrite: bool = False) -> None:
    """Register ``factory`` (an Engine subclass or a callable returning
    an Engine) under ``name`` for ``bind_graph(backend=name)``."""
    if not isinstance(name, str) or not name:
        raise ValueError(f"backend name must be a non-empty string, "
                         f"got {name!r}")
    if not callable(factory):
        raise TypeError(f"engine factory for {name!r} must be callable")
    taken = name in _FACTORIES or name in _BUILTIN_PATHS
    if taken and not overwrite:
        raise DuplicateBackendError(
            f"backend {name!r} is already registered "
            f"(pass overwrite=True to replace it)")
    _FACTORIES[name] = factory


def unregister_engine(name: str) -> None:
    """Remove a registered backend (built-ins revert to their default)."""
    _FACTORIES.pop(name, None)


def engine_factory(name: str) -> EngineFactory:
    """The factory registered under ``name`` (resolving built-ins)."""
    if name in _FACTORIES:
        return _FACTORIES[name]
    if name in _BUILTIN_PATHS:
        return _resolve_builtin(name)
    raise UnknownBackendError(
        f"unknown backend {name!r}; available: "
        f"{', '.join(available_backends())}")


def make_engine(name: str, **options) -> Engine:
    """Instantiate a backend by name, e.g.
    ``make_engine('cuda', k=8, device='cuda')``."""
    return engine_factory(name)(**options)


def available_backends() -> List[str]:
    """Sorted names of every registered backend."""
    return sorted(set(_BUILTIN_PATHS) | set(_FACTORIES))


# ---------------------------------------------------------------------------
# Shared engines (repro_torch.serve)
# ---------------------------------------------------------------------------
# A session pool binds all same-shape tenants to ONE engine per (backend,
# scope, options).  Engines keep per-graph host state (``_n`` is set by
# ``prepare``, the max-degree cache by ``count_wedges``), so the key MUST
# scope by anything that state depends on: the pool passes the graph's
# vertex count as ``scope``.  Sharing is safe exactly when every session
# on the instance would set identical host state.

_SHARED_ENGINES: Dict[Tuple, Engine] = {}
_SHARED_LOCK = threading.Lock()


def _world_size() -> int:
    """The default process group's world size, 1 without one (a
    monkeypatch seam for the mesh-key tests)."""
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def _mesh_token(name: str, options: Dict[str, Any]):
    """Extra shared-key component for mesh-bound engines (a factory with
    a true ``mesh_scoped`` attribute, such as ``dist`` and
    ``dist_sharded``): the shard count the factory would resolve, so a
    pool never hands a tenant an engine built for another shard count.
    That is ``num_shards`` when given, else the default process group's
    world size, else 1."""
    try:
        factory = engine_factory(name)
    except UnknownBackendError:
        return None
    if not getattr(factory, "mesh_scoped", False):
        return None
    shards = options.get("num_shards") or _world_size()
    return ("mesh", int(shards))


def shared_engine(name: str, scope: Any = None, **options) -> Engine:
    """One cached engine instance per ``(name, scope, mesh, options)``:
    the pool's shared binding.  ``scope`` must capture whatever
    per-graph host state the engine carries (vertex count at minimum);
    callers that cannot guarantee a safe scope use :func:`make_engine`."""
    key = (name, scope, _mesh_token(name, options),
           tuple(sorted(options.items())))
    with _SHARED_LOCK:
        eng = _SHARED_ENGINES.get(key)
        if eng is None:
            eng = _SHARED_ENGINES[key] = make_engine(name, **options)
        return eng


def clear_shared_engines() -> None:
    """Drop every shared engine."""
    with _SHARED_LOCK:
        _SHARED_ENGINES.clear()


# Degradation order per backend: where a session falls when its bound
# backend's kernels fail to build or launch.  Every chain bottoms out at
# "torch", the plain tensor engine with no hand kernel.  Keys are
# *registry names*, not Engine.name (cuda and cuda_chained share
# Engine.name == "cuda"; the registry name is what bind() stores).
DEFAULT_CHAIN: Dict[str, tuple] = {
    "cuda": ("cuda_chained", "torch"),
    "cuda_chained": ("torch",),
    "frontier": ("torch",),
    "dist": ("torch",),
    "dist_sharded": ("dist", "torch"),
}


def failover_chain(name: str) -> tuple:
    """The fallback backends to try, in order, when ``name`` fails.
    Unknown or custom backends degrade straight to the plain engine."""
    if name == "torch":
        return ()
    return DEFAULT_CHAIN.get(name, ("torch",))
