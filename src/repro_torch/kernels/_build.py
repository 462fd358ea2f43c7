"""Build and load the hand-written CUDA kernels in ``csrc/``.

The source is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, keyed by a
hash of the source and the flags, under ``build/repro_torch/`` at the
repository root; the library is loaded with ``ctypes``.  Nothing here
runs when the package is imported.
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

_HERE = pathlib.Path(__file__).resolve()
SOURCE = _HERE.parents[1] / "csrc" / "repair.cu"
BUILD_DIR = _HERE.parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
# what the last build in this process printed and how long it took
BUILD_INFO = {"seconds": None, "log": "", "path": None}

P, I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # ell_src, ell_w, vals, row_min, row_arg, rows, counts, R, K, n,
    # block, stream
    "repro_fused_relax_rows": [P] * 7 + [I] * 4 + [P],
    # pool src/dst/w/alive, fresh src/dst/w/alive, out src/dst/w/alive,
    # D, B, n, iters, stream
    "repro_merge_pool_sorted": [P] * 12 + [I] * 4 + [P],
}


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


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librepair_{digest}.so"


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (one ``nvcc`` run)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            res = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp),
                                  str(SOURCE)], capture_output=True,
                                 text=True)
            BUILD_INFO["seconds"] = time.perf_counter() - t0
            BUILD_INFO["log"] = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n"
                                   f"{BUILD_INFO['log']}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        BUILD_INFO["path"] = str(so)
        _LIB = lib
        return lib
