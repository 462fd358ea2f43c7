"""String-keyed engine registry: the paper's "choose a backend" knob
(counterpart of ``repro.core.registry``).

Built-ins are registered by module path and imported on first use:

* ``torch`` — :class:`~repro_torch.core.engine.TorchEngine`, the plain
  tensor reference;
* ``cuda``  — :class:`~repro_torch.core.cuda_engine.CudaEngine`, the
  hand-kernel backend with fused kernels;
* ``cuda_chained`` — the same engine on the per-op kernel chain
  (:func:`~repro_torch.core.cuda_engine.CudaChainedEngine`).

``register_engine`` plugs in more.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List

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
