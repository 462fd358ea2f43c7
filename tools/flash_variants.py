#!/usr/bin/env python3
"""Copies of the flash-attention kernel with one change each, built and
run beside the real one on an NVIDIA Hopper card.

    python3 tools/flash_variants.py faults      # planted faults
    python3 tools/flash_variants.py ablations   # design choices undone

Each variant is a text substitution in a copy of
``src/repro_torch/csrc/flash_attention.cu`` (every substitution must
match exactly once).  The copies are built with ``nvcc`` in parallel
with the source's own flags, and each is put in the wrapper's place in
turn.

``faults``: an unchanged control copy must pass
``chip_smoke.check_flash`` (its window cases among them) and every
planted fault must fail it; for each copy the script prints the max |d|
against the plain version at every bf16 case of
``chip_smoke.FLASH_CASES`` and ``WINDOW_FLASH_CASES`` that reaches the
tensor-core kernel (dh 64 or 128), and exits non-zero unless every
verdict is as expected.  None of the faults can stall the kernel: the
barriers still pair up (a block walks at least one KV tile, so a fault
that shortens the walk keeps one).

``ablations``: the kernel and each copy that undoes one design choice
are timed at the LM prefill's shape (BH = 4 * 36, S = 2,048, dh = 128,
bf16), causal and not, by CUDA events with a cold L2 (median of 20
launches), in the order kernel, copy, copy, kernel for each copy; every
copy is first held to the plain version within 3e-2.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ABLATIONS = {
    "heads side by side in the grid (a head's q tiles apart)": [
        ("const int bh = blockIdx.x / nqt;\n"
         "  const int qt = nqt - 1 - blockIdx.x % nqt;",
         "const int bh = blockIdx.x % (gridDim.x / nqt);\n"
         "  const int qt = nqt - 1 - blockIdx.x / (gridDim.x / nqt);")],
    "accurate expf in place of exp2 of an fma": [
        ("exp2f(fmaf(s[i], LOG2E, -mxl[(i >> 1) & 1]))",
         "expf(s[i] - mx[(i >> 1) & 1])"),
        ("exp2f(fmaf(m[h], LOG2E, -mxl[h]))", "expf(m[h] - mx[h])")],
    "one division an output": [
        ("  const float q = a * rb;\n  return fmaf(fmaf(-q, b, a), rb, q);",
         "  return a / b;")],
    "P.V retired before the softmax (no overlap)": [
        ("      pv_tile<DH>(acc, p, sv + stage * TILE);\n"
         "      wgmma_wait<1>();",
         "      pv_tile<DH>(acc, p, sv + stage * TILE);\n"
         "      wgmma_wait<0>();")],
    "3 ring stages at dh 128": [
        ("launch_wgmma<128, 2>", "launch_wgmma<128, 3>")],
}
# the three choices that pay most, undone together
ABLATIONS["heads side by side, expf and a division an output"] = [
    sub for name in list(ABLATIONS)[:3] for sub in ABLATIONS[name]]

FAULTS = {
    "control (no fault)": [],
    "diagonal tile skipped (every q tile whose walk has another)": [
        ("causal ? qt + 1 :", "causal ? max(qt, jlo + 1) :")],
    "rescale dropped for consumer warpgroup 1": [
        ("acc[i] *= alpha[(i >> 1) & 1];",
         "if (cw == 0) acc[i] *= alpha[(i >> 1) & 1];")],
    "ring stage off by one (the producer's destination)": [
        ("kdst = sk + stage * TILE, vdst = sv + stage * TILE",
         "kdst = sk + (stage + 1) % NS * TILE, "
         "vdst = sv + (stage + 1) % NS * TILE")],
    "window's lower edge unmasked past a block's first KV tile": [
        ("k0 + WG_BK > S || k0 < lower_edge,", "k0 + WG_BK > S,")],
    "a wholly masked row's max taken into the fma (the NaN hazard)": [
        ("mx[0] == NEG ? 0.f : mx[0] * LOG2E", "mx[0] * LOG2E"),
        ("mx[1] == NEG ? 0.f : mx[1] * LOG2E", "mx[1] * LOG2E")],
}


def planted(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build(variants: dict, out_dir: pathlib.Path) -> dict:
    """{name: the variant's repro_flash_attention}, built in parallel."""
    from repro_torch.kernels import _build
    src = _build.CSRC / "flash_attention.cu"
    text = src.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        cu = out_dir / f"flash_{i}.cu"
        cu.write_text(planted(text, subs))
        so = out_dir / f"libflash_{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags(src), "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        fn = ctypes.CDLL(str(so)).repro_flash_attention
        fn.argtypes = _build._SIGNATURES["repro_flash_attention"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def use(fn) -> None:
    """Put ``fn`` in the wrapper's place (the wrapper reaches its entry
    point through ``_build.load()``)."""
    from repro_torch.kernels import _build
    lib = _build.load()
    _build._LIB = types.SimpleNamespace(**{**vars(lib),
                                           "repro_flash_attention": fn})


def faults(torch, chip_smoke, FA, fns) -> bool:
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    ok = True
    for name, fn in fns.items():
        use(fn)
        gen = torch.Generator(device="cuda").manual_seed(3)
        errs = []
        cases = [(shape, dt, dict(causal=causal, softcap=cap))
                 for shape, dt, causal, cap, *_ in chip_smoke.FLASH_CASES]
        cases += [(shape, dt, dict(causal=True, softcap=cap, window=w))
                  for shape, dt, w, cap, *_ in chip_smoke.WINDOW_FLASH_CASES]
        for shape, dt, kw in cases:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
                getattr(torch, dt)) for _ in range(3))
            if dt != "bfloat16" or shape[2] not in (64, 128):
                continue
            got = FA.flash_attention(q, k, v, **kw)
            want = FA.flash_attention_plain(q, k, v, **kw)
            d = (got.double() - want.double()).abs().max()
            errs.append(f"{tuple(shape)} {kw}: max |d| {float(d):.4g}")
        try:
            chip_smoke.check_flash(torch, types.SimpleNamespace(reps=3),
                                   flush, FA, 0)
            verdict = "passes check_flash"
        except AssertionError as exc:
            verdict = f"fails check_flash ({exc})"
        expected = name.startswith("control") == verdict.startswith("passes")
        ok &= expected
        print(f"[fault] {name}: {verdict}{'' if expected else ' -- WRONG'}",
              flush=True)
        for e in errs:
            print(f"[fault]   {e}", flush=True)
    return ok


def ablations(torch, chip_smoke, FA, fns) -> bool:
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((4 * 36, 2048, 128), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    ok = True
    kernel = fns.pop("kernel")
    for name, fn in fns.items():
        use(fn)
        for causal in (True, False):
            err = float((FA.flash_attention(q, k, v, causal=causal).double()
                         - FA.flash_attention_plain(q, k, v, causal=causal)
                         .double()).abs().max())
            ok &= err <= 3e-2
            ms = {}
            for which in ("kernel", "copy", "copy", "kernel"):
                use(kernel if which == "kernel" else fn)
                ms.setdefault(which, []).append(chip_smoke.median_ms(
                    torch, lambda: FA.flash_attention(q, k, v, causal=causal),
                    20, flush))
            print(f"[ablation] {name}, causal={causal}: copy "
                  f"{ms['copy'][0]:.4f} / {ms['copy'][1]:.4f} ms, kernel "
                  f"{ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f} ms "
                  f"(max |d| {err:.4g})", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("faults", "ablations"))
    ap.add_argument("--out", default=str(ROOT / "build" / "flash_variants"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import flash_attention as FA
    print(chip_smoke.nvidia_smi(), flush=True)
    if args.what == "faults":
        fns = build(FAULTS, pathlib.Path(args.out) / "faults")
        ok = faults(torch, chip_smoke, FA, fns)
    else:
        fns = build({"kernel": [], **ABLATIONS},
                    pathlib.Path(args.out) / "ablations")
        ok = ablations(torch, chip_smoke, FA, fns)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
