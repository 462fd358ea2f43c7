"""The IR, the engines and the backend registry.

Public names re-export lazily (PEP 562), as ``repro.core``'s do, so that
importing the package loads no engine.
"""

__all__ = [
    "Engine", "TorchEngine", "CudaEngine", "FrontierEngine", "DistEngine",
    "register_engine", "make_engine", "engine_factory",
    "available_backends", "UnknownBackendError", "DuplicateBackendError",
    "registry",
]

_LAZY = {
    "Engine": ("repro_torch.core.engine", "Engine"),
    "TorchEngine": ("repro_torch.core.engine", "TorchEngine"),
    "CudaEngine": ("repro_torch.core.cuda_engine", "CudaEngine"),
    "FrontierEngine": ("repro_torch.core.frontier_engine", "FrontierEngine"),
    "DistEngine": ("repro_torch.core.dist", "DistEngine"),
    "register_engine": ("repro_torch.core.registry", "register_engine"),
    "make_engine": ("repro_torch.core.registry", "make_engine"),
    "engine_factory": ("repro_torch.core.registry", "engine_factory"),
    "available_backends": ("repro_torch.core.registry",
                           "available_backends"),
    "UnknownBackendError": ("repro_torch.core.registry",
                            "UnknownBackendError"),
    "DuplicateBackendError": ("repro_torch.core.registry",
                              "DuplicateBackendError"),
}


def __getattr__(name):
    import importlib
    if name == "registry":
        return importlib.import_module("repro_torch.core.registry")
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}") from None
    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(__all__)
