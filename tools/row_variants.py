#!/usr/bin/env python3
"""Copies of the fused row kernels (``fused_relax_rows`` and
``fused_spmv_rows`` in ``src/repro_torch/csrc/repair.cu``) with one
change each, built and run beside the real ones on an NVIDIA Hopper card.

    python3 tools/row_variants.py faults      # planted faults
    python3 tools/row_variants.py ablations   # other designs, timed

Each variant is a text substitution in a copy of ``repair.cu`` (every
substitution must match as often as it says, once by default).  The
copies are built with ``nvcc`` in parallel with the source's own flags,
and each is put in the wrappers' place in turn.

``faults``: an unchanged control copy must pass ``chip_smoke.check_rows``
(both kernels bit for bit against their plain versions on
``chip_smoke.ROW_CASES``, its RMAT pack at ``--scale``) and every planted
fault must fail it.  Each copy is checked in a process of its own, so a
fault that writes out of bounds ends only its own CUDA context.  Exits
non-zero unless every verdict is as expected.

``ablations``: at the main path's shapes (the ELL pack of
``chip_smoke.py``'s RMAT graph at ``--scale``, default 22, with its
stream's diff pool; vals from a static SSSP and a static PageRank on the
card), each kernel and each copy are timed by CUDA events with a cold L2
(median of 20 launches), in the order kernel, copy, copy, kernel.  A
copy that keeps the kernels' contract must also equal the plain
versions bit for bit; the copies marked "timing only" change what is
computed (no gathers, or the same slots over and over) to show which
part sets the pace.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

NAMES = ("repro_fused_relax_rows", "repro_fused_spmv_rows")

# Loads put in front of the kernels by some copies: a slot load under L1
# no-allocate and an L2 evict-first policy, and a gather (ell_row.cuh's
# id clamp and wrap) through @GATHER@, one of the GATHERS.
HELPERS = r"""
__device__ __forceinline__ int4 ld_stream(const int4* p) {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  int4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.s32 "
      "{%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ int from_bits(unsigned v, const int*) {
  return (int)v;
}
__device__ __forceinline__ float from_bits(unsigned v, const float*) {
  return __uint_as_float(v);
}
template <typename T>
__device__ __forceinline__ T gather_q(const T* __restrict__ vals, int i,
                                      int L) {
  i = min(max(i, -L), L - 1);
  const T* p = vals + (i < 0 ? i + L : i);
  unsigned v;
  @GATHER@
  return from_bits(v, vals);
}
"""
GATHERS = {
    "evict-last": (
        'unsigned long long pol;\n'
        '  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" '
        ': "=l"(pol));\n'
        '  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" '
        ': "=r"(v) : "l"(p), "l"(pol));'),
    "no L1": 'asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" '
             ': "=r"(v) : "l"(p));',
}
ANCHOR = '#include "ell_row.cuh"\n\nnamespace {\n'


def helpers(gather: str) -> list:
    """Substitutions that put HELPERS in, with the gather ``gather``, and
    send every gather of vals through it."""
    return [(ANCHOR, ANCHOR + HELPERS.replace("@GATHER@", GATHERS[gather])),
            ("gather(vals, ", "gather_q(vals, ", 7)]


THREAD_LOADS = [("warp_load_row8(ell_src, r, s);",
                 "load_row<true>(ell_src, r, 8, s);", 2),
                ("warp_load_row8(ell_w, r, w);",
                 "load_row<true>(ell_w, r, 8, w);")]
NO_CARVEOUT = [("      prefer_l1(", "      (void)(", 4)]
BASE = "const long long base = (long long)blockIdx.x * blockDim.x;"
ABLATIONS = {
    "earlier kernel (each thread its row as two int4 by __ldg, carveout "
    "left to the driver)": THREAD_LOADS + NO_CARVEOUT,
    "each thread its row as two int4 by __ldg": THREAD_LOADS,
    "shared-memory carveout left to the driver": NO_CARVEOUT,
    "slots under L1 no-allocate and L2 evict-first, gathers under L2 "
    "evict-last": helpers("evict-last") + [
        ("__ldg(q + lane)", "ld_stream(q + lane)"),
        ("__ldg(q + 32 + (lane ^ 1))", "ld_stream(q + 32 + (lane ^ 1))")],
    "gathers not allocated in L1": helpers("no L1"),
    "8,448 bytes of idle shared memory a block, carveout left to the "
    "driver (L1 given up)": NO_CARVEOUT + [
        ("  const size_t smem = (size_t)(block / 32) * sizeof(int);\n",
         "  const size_t smem = (size_t)(block / 32) * sizeof(int) + 8448;\n",
         2)],
    "stream only (timing only: every slot gathers vals[n])": [
        ("gather(vals, s[0], n + 1)",
         "gather(vals, s[0] == 123456789 ? 0 : n, n + 1)", 2),
        ("gather(vals, s[k], n + 1)",
         "gather(vals, s[k] == 123456789 ? 0 : n, n + 1)"),
        ("gather(vals, s, L)", "gather(vals, s == 123456789 ? 0 : L - 1, L)")],
    "gathers only (timing only: the slots of 2,048 tiles spread over the "
    "pack, over and over, kept in L2)": [
        (BASE, "const long long base = (long long)(blockIdx.x % 2048 * "
               "(gridDim.x / 2048)) * blockDim.x;", 2)],
}

FAULTS = {
    "control (no fault)": [],
    "compaction offset shifted (tile t compacted into tile t - 1)": [
        ("if (hit) rows[base + pos] = (int)r;",
         "if (hit) rows[(base ? base - blockDim.x : 0) + pos] = (int)r;")],
    "last row of each tile never a hit": [
        ("  compact_block(hit, r, base, R, warp_tot, rows, counts);\n",
         "  hit = hit && threadIdx.x + 1 < blockDim.x;\n"
         "  compact_block(hit, r, base, R, warp_tot, rows, counts);\n", 2)],
    "padding slots skipped instead of gathering vals[n]": [
        ("        relax_slot(s[k], w[k], vals, n + 1, rmin, rarg, reach);",
         "        if (s[k] != n) relax_slot(s[k], w[k], vals, n + 1, rmin, "
         "rarg, reach);"),
        ("        acc = __fadd_rn(acc, gather(vals, s[k], n + 1));",
         "        if (s[k] != n) acc = __fadd_rn(acc, gather(vals, s[k], "
         "n + 1));")],
    "sentinel R not written after a tile's count": [
        ("  if (tid >= total && r < R) rows[r] = R;\n", "")],
    "warp load: second int4 not swapped between lane pairs": [
        ("__ldg(q + 32 + (lane ^ 1))", "__ldg(q + 32 + lane)")],
    "warp load: a row's second half from its first half's lane": [
        ("j1 = j0 ^ 1;", "j1 = j0;")],
}


def planted(text: str, subs) -> str:
    """Each (old, new) or (old, new, count) of ``subs`` in ``text``; old
    must occur exactly once, or ``count`` times."""
    for old, new, *count in subs:
        want = count[0] if count else 1
        if text.count(old) != want:
            raise ValueError(f"{old!r} occurs {text.count(old)} times, "
                             f"not {want}")
        text = text.replace(old, new)
    return text


def build(variants: dict, out_dir: pathlib.Path) -> dict:
    """{name: library path}, built in parallel."""
    from repro_torch.kernels import _build
    src = _build.CSRC / "repair.cu"
    text = src.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        cu = out_dir / f"repair_{i}.cu"
        cu.write_text(planted(text, subs))
        so = out_dir / f"librepair_{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags(src), "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        libs[name] = so
    return libs


def entry_points(so) -> dict:
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name in NAMES:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def use(fns: dict) -> None:
    """Put a copy's entry points in the wrappers' place (the wrappers
    reach them through ``_build.load()``)."""
    from repro_torch.kernels import _build
    lib = _build.load()
    _build._LIB = types.SimpleNamespace(**{**vars(lib), **fns})


def check_one(so, scale: int) -> int:
    """One copy (or, with no ``so``, the real kernels) through
    chip_smoke.check_rows: 0 if it passes, 1 if it fails the check
    (anything else is a crash)."""
    import torch
    import chip_smoke
    import repro_torch
    from repro_torch.kernels import repair as FK
    if so is not None:
        use(entry_points(so))
    try:
        for line in chip_smoke.check_rows(torch, repro_torch, FK, scale):
            print(f"[check] {line}", flush=True)
        torch.cuda.synchronize()
    except AssertionError as exc:
        print(f"[check] fails: {exc}", flush=True)
        return 1
    return 0


def faults(libs: dict, scale: int) -> bool:
    ok = True
    for name, so in libs.items():
        proc = subprocess.run(
            [sys.executable, __file__, "check", str(so), "--scale",
             str(scale)], capture_output=True, text=True, timeout=600)
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
        passed = proc.returncode == 0
        verdict = ("passes check_rows" if passed else
                   f"fails check_rows (exit {proc.returncode})")
        expected = name.startswith("control") == passed
        ok &= expected
        print(f"[fault] {name}: {verdict}{'' if expected else ' -- WRONG'}",
              flush=True)
        for line in tail:
            print(f"[fault]   {line[:300]}", flush=True)
    return ok


def main_path_inputs(torch, scale: int):
    """The ELL pack of chip_smoke.py's graph and stream at ``scale`` and
    the vals of a static SSSP and a static PageRank on it."""
    import chip_smoke
    import repro_torch
    from repro_torch.algos import pagerank, sssp
    from repro_torch.graph.csr import INF_W
    n, edges, w = repro_torch.rmat_graph(scale, chip_smoke.DEGREE, seed=0)
    csr = repro_torch.build_csr(n, edges, w, device="cuda")
    stream = repro_torch.random_updates(csr, percent=chip_smoke.PERCENT,
                                        seed=1)
    sess = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=2 * stream.num_adds)
    ell = sess.handle.ell
    block = sess.engine._config(sess.handle.g).row_block
    dist = sess.call(sssp.static_sssp, 0)["dist"]
    vals = torch.cat([torch.where(dist < INF_W, dist, INF_W).int(),
                      dist.new_full((1,), INF_W)])
    pr = sess.call(pagerank.static_pr, *chip_smoke.PR_KNOBS)
    fvals = torch.cat([pr["pr"] * pr["inv_outdeg"], pr["pr"].new_zeros(1)])
    return ell, block, vals, fvals


def ablations(libs: dict, scale: int) -> bool:
    import torch
    import chip_smoke
    from repro_torch.kernels import repair as FK
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    ell, block, vals, fvals = main_path_inputs(torch, scale)
    R, K, n = ell.R, ell.K, ell.n
    print(f"[ablation] R={R} K={K} n={n} tile {block}", flush=True)
    kernels = {
        "fused_relax_rows": (
            (ell.ell_src, ell.ell_w, vals),
            lambda: FK.fused_relax_rows(ell.ell_src, ell.ell_w, vals,
                                        block=block),
            lambda: FK.fused_relax_rows_plain(ell.ell_src, ell.ell_w, vals,
                                              block)),
        "fused_spmv_rows": (
            (ell.ell_src, ell.row2dst, fvals),
            lambda: FK.fused_spmv_rows(ell.ell_src, ell.row2dst, fvals,
                                       block=block),
            lambda: FK.fused_spmv_rows_plain(ell.ell_src, ell.row2dst,
                                             fvals, block)),
    }
    real = entry_points(libs.pop("kernel"))
    copies = {name: entry_points(so) for name, so in libs.items()}
    ok = True
    for kname, (inputs, fn, plain) in kernels.items():
        use(real)
        want = plain()
        got = fn()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        ok &= exact
        b_ms = chip_smoke.bound(chip_smoke.nbytes(*inputs, *got), 0)[0]
        del got
        print(f"[ablation] {kname}: the kernel is "
              f"{'bit-exact' if exact else 'NOT bit-exact'}, bound "
              f"{b_ms:.4f} ms by bytes", flush=True)
        for name, fns in copies.items():
            use(fns)
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            del got
            if "timing only" not in name:
                ok &= same
            ms = {}
            for which in ("kernel", "copy", "copy", "kernel"):
                use(real if which == "kernel" else fns)
                ms.setdefault(which, []).append(
                    chip_smoke.median_ms(torch, fn, 20, flush))
            print(f"[ablation] {kname}, {name}: copy "
                  f"{ms['copy'][0]:.4f} / {ms['copy'][1]:.4f} ms, kernel "
                  f"{ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f} ms "
                  f"({'bit-exact' if same else 'differs'})", flush=True)
    use(real)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("faults", "ablations", "check"))
    ap.add_argument("lib", nargs="?",
                    help="check: the copy to check (default: the kernels "
                         "in csrc/)")
    ap.add_argument("--scale", type=int, default=None,
                    help="RMAT scale (faults: 18, ablations: 22)")
    ap.add_argument("--out", default=str(ROOT / "build" / "row_variants"))
    ap.add_argument("--only", default=None,
                    help="ablations: only the copies whose name holds "
                         "this text")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("row_variants: no CUDA device is available", file=sys.stderr)
        return 2
    if args.what == "check":
        return check_one(args.lib, args.scale or 18)
    import chip_smoke
    print(chip_smoke.nvidia_smi(), flush=True)
    if args.what == "faults":
        libs = build(FAULTS, pathlib.Path(args.out) / "faults")
        ok = faults(libs, args.scale or 18)
    else:
        keep = {k: v for k, v in ABLATIONS.items()
                if args.only is None or args.only in k}
        libs = build({"kernel": [], **keep},
                     pathlib.Path(args.out) / "ablations")
        ok = ablations(libs, args.scale or 22)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
