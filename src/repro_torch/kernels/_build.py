"""Build and load the hand-written CUDA kernels in ``csrc/``, and the
helpers every kernel wrapper launches with.

Each ``csrc/*.cu`` is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, all of them
at once (one ``nvcc`` process per source, with the common flags and the
source's own from ``SOURCE_FLAGS``), keyed by one hash of every
source, the ``*.cuh`` headers they include and the flags; the libraries
are loaded with ``ctypes``.  They go
to ``build/repro_torch/`` at the root of the checkout when the package
runs from one (``PYTHONPATH=src`` or an editable install), else to a
user cache directory (``$XDG_CACHE_HOME/repro_torch``, by default
``~/.cache/repro_torch``).  Nothing here runs when the package is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
import types

import torch

_HERE = pathlib.Path(__file__).resolve()
CSRC = _HERE.parents[1] / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# each source's own flags: the graph kernels' float sums are bit-exact
# against their plain versions only without fused multiply-adds
SOURCE_FLAGS = {
    "repair.cu": ("--fmad=false",),
    "csr_relax.cu": ("--fmad=false",),
    "segment.cu": ("--fmad=false",),
    "flash_attention.cu": (),
    "flash_attention_bwd.cu": (),
    "graph_cond.cu": (),
}


def _build_dir() -> pathlib.Path:
    root = _HERE.parents[3]
    if _HERE.parents[2].name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or \
        pathlib.Path.home() / ".cache"
    return pathlib.Path(cache) / "repro_torch"


BUILD_DIR = _build_dir()

_LOCK = threading.Lock()
_LIB = None
# what the last build in this process printed and how long it took, per
# source file; ``seconds`` is the wall time of the whole parallel build
BUILD_INFO = {"seconds": None, "logs": {}, "paths": {}}

# every kernel module's launch counts, by module name: a module registers
# its table with ``launch_table`` when it is imported, and the captured
# segments' tallies (``core/device_loop.py``) and the smoke read them all
# from here, so no reader keeps a list of modules of its own
LAUNCH_TABLES: dict = {}


def launch_table(module: str, *kernels: str) -> dict:
    """The launch counts of ``module``'s kernels (each wrapper adds one
    where it launches), registered in ``LAUNCH_TABLES``."""
    return LAUNCH_TABLES.setdefault(module, dict.fromkeys(kernels, 0))


def reset_all_launches() -> None:
    for table in LAUNCH_TABLES.values():
        table.update(dict.fromkeys(table, 0))


def all_launches() -> dict:
    """Every registered kernel's count, as one {kernel: launches} dict."""
    return {k: v for t in LAUNCH_TABLES.values() for k, v in t.items()}

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
U64 = ctypes.c_ulonglong
_SIGNATURES = {
    # repair.cu — ell_src, ell_w, vals, row_min, row_arg, rows, counts,
    # R, K, n, block, stream
    "repro_fused_relax_rows": [P] * 7 + [I] * 4 + [P],
    # ell_src, row2dst, vals, row_sum, rows, counts, R, K, n, block, stream
    "repro_fused_spmv_rows": [P] * 6 + [I] * 4 + [P],
    # pool src/dst/w/alive, fresh src/dst/w/alive, out src/dst/w/alive,
    # S sessions stacked: pools (S, D), batches (S, B); D, B, S, stream
    "repro_merge_pool_sorted_batched": [P] * 12 + [I] * 3 + [P],
    # csr_relax.cu — ell_src, ell_w, vals, out, R, K, L (len(vals)), stream
    "repro_relax_rowmin": [P] * 4 + [I] * 3 + [P],
    # ell_src, vals, out, R, K, L, stream
    "repro_spmv_rowsum": [P] * 3 + [I] * 3 + [P],
    # ell_src, ell_w, vals, row_targets, out, R, K, n, L, stream
    "repro_relax_rowargmin": [P] * 5 + [I] * 4 + [P],
    # segment.cu — vals, order (or null), offsets, out, num, stream
    "repro_segment_sum_sorted": [P] * 4 + [I] + [P],
    # flash_attention.cu — q, k, v, o, lse (or null), BH, S, dh, is_bf16,
    # causal, window (0: none), scale, softcap, stream
    "repro_flash_attention": [P] * 5 + [I] * 6 + [F] * 2 + [P],
    # dh, is_bf16 -> 1 where the launch runs on the tensor cores
    "repro_flash_route": [I, I],
    # flash_attention_bwd.cu — q, k, v, o, lse, do, dq, dk, dv, delta
    # (scratch), qs (scratch, or null off the tensor cores), BH, S, dh,
    # is_bf16, causal, window, scale, softcap, stream
    "repro_flash_attention_bwd": [P] * 11 + [I] * 6 + [F] * 2 + [P],
    "repro_flash_bwd_route": [I, I],
    # graph_cond.cu — the conditional nodes of core/device_loop.py:
    # stream, handle out
    "repro_cond_handle": [P, P],
    # handle, predicate (device bool), negate, stream
    "repro_cond_set": [U64, P, I, P],
    # stream, handle, kind (0 IF, 1 WHILE), body graph out, node out
    "repro_cond_node": [P, U64, I, P, P],
    # body stream, body graph
    "repro_cond_body_begin": [P, P],
    "repro_cond_body_end": [P],
    # stream, node
    "repro_cond_node_end": [P, P],
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def flags(src: pathlib.Path) -> tuple:
    """nvcc's flags for one source: the common ones and its own."""
    if src.name not in SOURCE_FLAGS:
        raise KeyError(f"{src.name} has no entry in SOURCE_FLAGS")
    return FLAGS + SOURCE_FLAGS[src.name]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_paths() -> dict:
    """{source: library} for every source, under one hash of them all and
    of the headers they include."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted(SOURCE_FLAGS):
        h.update(f"{name} {' '.join(SOURCE_FLAGS[name])}".encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + src.read_bytes())
    digest = h.hexdigest()[:16]
    return {src: BUILD_DIR / f"lib{src.stem}_{digest}.so"
            for src in sources()}


def load() -> types.SimpleNamespace:
    """Every kernel entry point, built on first call (the sources that
    have no library yet are compiled in parallel)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        libs = library_paths()
        todo = {src: so for src, so in libs.items() if not so.exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            procs = {src: (subprocess.Popen(
                [_nvcc(), *flags(src), "-o", str(so.with_suffix(
                    f".{os.getpid()}.tmp")), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                so) for src, so in todo.items()}
            failed = []
            for src, (proc, so) in procs.items():
                log = proc.communicate()[0]
                BUILD_INFO["logs"][src.name] = log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {src.name}:\n{log}")
                else:
                    os.replace(so.with_suffix(f".{os.getpid()}.tmp"), so)
            BUILD_INFO["seconds"] = time.perf_counter() - t0
            if failed:
                raise RuntimeError("\n".join(failed))
        fns = {}
        for src, so in libs.items():
            lib = ctypes.CDLL(str(so))
            BUILD_INFO["paths"][src.name] = str(so)
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
                    fns[name] = fn
        missing = sorted(set(_SIGNATURES) - set(fns))
        if missing:
            raise RuntimeError(f"kernel entry points missing from the "
                               f"built libraries: {missing}")
        _LIB = types.SimpleNamespace(**fns)
        return _LIB


# ---------------------------------------------------------------------------
# launch helpers shared by the kernel wrappers
# ---------------------------------------------------------------------------

def check(name: str, dev: torch.device, **tensors) -> None:
    """Each ``arg=(tensor, dtype)`` lies on ``dev``, has ``dtype`` and is
    contiguous; raises otherwise."""
    for arg, (t, dtype) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def cuda_device(name: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
