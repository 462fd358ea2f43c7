#!/usr/bin/env python3
"""Copies of the flash-attention kernels with one change each, built and
run beside the real ones on an NVIDIA Hopper card.

    python3 tools/flash_variants.py faults          # forward: planted faults
    python3 tools/flash_variants.py ablations       # forward: choices undone
    python3 tools/flash_variants.py faults-bwd      # backward: planted faults
    python3 tools/flash_variants.py ablations-bwd   # backward: choices undone
    python3 tools/flash_variants.py profile         # both, by kernel
    python3 tools/flash_variants.py parent --parent DIR   # forward vs DIR's

Each variant is a set of text substitutions in copies of
``src/repro_torch/csrc/flash_attention.cu`` (the forward's modes) or
``flash_attention_bwd.cu`` (the backward's) and of the headers they
include (a substitution names ``hopper.cuh`` to change the shared
header); every substitution must match exactly once.  Each copy is built
in a directory of its own with ``nvcc``, all in parallel, with the
source's own flags, and each is put in the wrapper's place in turn.

``faults``: an unchanged control copy must pass ``chip_smoke.check_flash``
(its window cases among them) and every planted fault must fail it; for
each copy the script prints the max |d| against the plain version at
every bf16 case of ``chip_smoke.FLASH_CASES`` and ``WINDOW_FLASH_CASES``
that reaches the tensor-core kernel (dh 64, 128 or 256).  ``faults-bwd``:
the same with ``chip_smoke.check_flash_bwd`` (``BWD_FLASH_CASES``, held by
``bwd_rel``, and two launches bit-identical).  Each exits non-zero unless
every verdict is as expected.  None of the faults can stall a kernel:
the barriers still pair up (a block walks at least one tile, so a fault
that shortens the walk keeps one).

``ablations``: the kernel and each copy that undoes one design choice are
timed at the shapes the copy names (the LM prefill's, BH = 4 * 36, S =
2,048, dh = 128, causal and not; with whisper's encoder and jamba's
prefill for a dh 64 / 128 copy; or gemma2-9b's global prefill, BH 32, S
7,168, dh 256, causal, softcap 50), by CUDA events with a cold L2 (median
of 20 launches), in the order kernel, copy, copy, kernel; every copy is
first held to the plain version within 3e-2.  ``ablations-bwd``: the same
for the backward at starcoder2-7b's training shape (BH 144, S 2,048, dh
128, causal), every copy first held by ``bwd_rel``.

``profile``: the kernels as they are, 10 launches of the forward at
gemma2's global prefill and 10 of the backward at the training shape,
each under torch.profiler (``chip_smoke.profile_window``): device time by
kernel name.

``parent``: the forward built from another tree's ``flash_attention.cu``
(``--parent``: that tree's ``csrc`` directory, e.g. ``git archive`` of the
parent commit unpacked under ``build/``) timed against this tree's in
turns at the dh 64 / 128 shapes of the smoke (the LM prefill causal and
not, whisper's encoder, jamba's prefill).
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

CSRC = ROOT / "src" / "repro_torch" / "csrc"
FORWARD, BACKWARD = "flash_attention.cu", "flash_attention_bwd.cu"
HEADER = "hopper.cuh"
# (shape, kw) the forward is timed at: the LM prefill, causal and not;
# with whisper's encoder and jamba's prefill the smoke's dh 64 / 128
# launches; gemma2's global prefill
LM_PREFILL = [((4 * 36, 2048, 128), dict(causal=True)),
              ((4 * 36, 2048, 128), dict(causal=False))]
DH64_128 = LM_PREFILL + [((80, 1500, 64), dict(causal=False)),
                         ((128, 2048, 128), dict(causal=True))]
GEMMA2_GLOBAL = [((32, 7168, 256), dict(causal=True, softcap=50.0))]

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
        ("      wgmma_acc_rows<DH, BK>(acc, p, sv + stage * KV_TILE, KV_BOX);\n"
         "      wgmma_commit();\n"
         "      wgmma_wait<1>();",
         "      wgmma_acc_rows<DH, BK>(acc, p, sv + stage * KV_TILE, KV_BOX);\n"
         "      wgmma_commit();\n"
         "      wgmma_wait<0>();")],
    "3 ring stages at dh 128": [
        ("launch_wgmma<128, 2, 128>", "launch_wgmma<128, 3, 128>")],
    "dh 256: tanhf for the softcap (in place of ex2 and an approximate "
    "division)": [
        ("        s[i] = softcap - __fdividef(c2, exp2f(s[i] * k2) + 1.f);",
         "        s[i] = tanhf(s[i] / softcap) * softcap;")],
    "dh 256: one 64-key ring stage (in place of 2)": [
        ("launch_wgmma<256, 2, 64>", "launch_wgmma<256, 1, 64>")],
    "dh 64 / 128: dh 256's softcap form (no softcap is timed)": [
        ("    if constexpr (EX2_CAP) {", "    if constexpr (true) {")],
}
# the three choices that pay most at dh 128, undone together
ABLATIONS["heads side by side, expf and a division an output"] = [
    sub for name in list(ABLATIONS)[:3] for sub in ABLATIONS[name]]
# where each is timed: the dh 256 copies at gemma2's prefill, the dh 64 /
# 128 ones at each dh 64 / 128 shape of the smoke
ABLATION_SHAPES = {
    name: GEMMA2_GLOBAL if name.startswith("dh 256") else
    DH64_128 if name.startswith("dh 64 / 128") else LM_PREFILL
    for name in ABLATIONS}

FAULTS = {
    "control (no fault)": [],
    "diagonal tile skipped (every q tile whose walk has another)": [
        ("causal ? min((q0 + WG_BQ + BK - 1) / BK, nkt) : nkt",
         "causal ? max(min((q0 + WG_BQ + BK - 1) / BK, nkt) - 1, jlo + 1) "
         ": nkt")],
    "rescale dropped for consumer warpgroup 1": [
        ("acc[i] *= alpha[(i >> 1) & 1];",
         "if (cw == 0) acc[i] *= alpha[(i >> 1) & 1];")],
    "ring stage off by one (the producer's destination)": [
        ("kdst = sk + stage * KV_TILE, vdst = sv + stage * KV_TILE",
         "kdst = sk + (stage + 1) % NS * KV_TILE, "
         "vdst = sv + (stage + 1) % NS * KV_TILE")],
    "window's lower edge unmasked past a block's first KV tile": [
        ("k0 + BK > S ||\n                                  k0 < lower_edge,",
         "k0 + BK > S,")],
    "a wholly masked row's max taken into the fma (the NaN hazard)": [
        ("mx[0] == NEG ? 0.f : mx[0] * LOG2E", "mx[0] * LOG2E"),
        ("mx[1] == NEG ? 0.f : mx[1] * LOG2E", "mx[1] * LOG2E")],
    "dh 256: a stage's K read from the previous tile": [
        ("tma_load(kdst + b * KV_BOX, &tk, b * 64, j * BK, bh,",
         "tma_load(kdst + b * KV_BOX, &tk, b * 64,\n"
         "                   (DH == 256 && j > jlo ? j - 1 : j) * BK, bh,")],
    "dh 256: the second n128 half of O += P.V dropped": [
        (HEADER,
         "      wgmma_rs_n128<64>(d, a[c], sw128_desc(at + 2 * box, box));\n",
         "")],
    "dh 256: a wholly masked row's max taken into the fma (the masked "
    "first tile's rule undone for 64-key tiles, N = 32 scores a thread)": [
        ("mx[0] == NEG ? 0.f : mx[0] * LOG2E",
         "mx[0] == NEG && N != 32 ? 0.f : mx[0] * LOG2E"),
        ("mx[1] == NEG ? 0.f : mx[1] * LOG2E",
         "mx[1] == NEG && N != 32 ? 0.f : mx[1] * LOG2E")],
}

BWD_ABLATIONS = {
    "dK/dV ring of 2 stages at dh 128 (in place of 3)": [
        ("launch_wgmma<128, 3, 4>", "launch_wgmma<128, 2, 4>")],
    "dK/dV ring of 4 stages at dh 128 (in place of 3)": [
        ("launch_wgmma<128, 3, 4>", "launch_wgmma<128, 4, 4>")],
    "dQ ring of 2 stages at dh 128 (in place of 4)": [
        ("launch_wgmma<128, 3, 4>", "launch_wgmma<128, 3, 2>")],
    "accurate expf for P (in place of exp2)": [
        ("  p = exp2f((c - lse) * LOG2E);", "  p = expf(c - lse);")],
}

BWD_FAULTS = {
    "control (no fault)": [],
    "dS without the softcap's factor": [
        ("  ds *= softcap > 0.f ? 1.f - th * th : 1.f;\n", "")],
    "a dK/dV stage released as soon as it lands": [
        ("      mbar_wait(full + 8 * stage, phase);\n",
         "      mbar_wait(full + 8 * stage, phase);\n"
         "      release(empty + 8 * stage, lane);\n"),
        ("      release(empty + 8 * stage, lane);\n      if (++stage == NS) {",
         "      if (++stage == NS) {")],
    "dQ missing its first KV tile": [
        ("      wgmma_acc_rows<DH, WG_STEP>(dq, da, k_at, STEP_BOX);",
         "      if (j0 != j_begin)\n"
         "        wgmma_acc_rows<DH, WG_STEP>(dq, da, k_at, STEP_BOX);")],
    "dK/dV's lse and D rows one stage late": [
        ("      const float* const ls = rows_lse + stage * WG_STEP;\n"
         "      const float* const dl = rows_d + stage * WG_STEP;",
         "      const float* const ls = rows_lse + (stage + 1) % NS * WG_STEP;"
         "\n      const float* const dl = rows_d + (stage + 1) % NS * WG_STEP;")],
}

# (source, entry point) of each table
TABLES = {"faults": (FORWARD, FAULTS), "ablations": (FORWARD, ABLATIONS),
          "faults-bwd": (BACKWARD, BWD_FAULTS),
          "ablations-bwd": (BACKWARD, BWD_ABLATIONS)}
ENTRY = {FORWARD: "repro_flash_attention",
         BACKWARD: "repro_flash_attention_bwd"}


def planted(text: str, subs) -> str:
    """``text`` with each (old, new) of ``subs`` substituted once."""
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def variant(source: str, subs, csrc=CSRC) -> dict:
    """{file name: text} of a variant of ``source``: the source and every
    header in ``csrc``, each with the substitutions that name it (a
    substitution of two strings names the source)."""
    files = {source: (csrc / source).read_text()}
    files.update({h.name: h.read_text() for h in sorted(csrc.glob("*.cuh"))})
    for name in files:
        mine = [s[-2:] for s in subs if (s[0] if len(s) == 3 else source)
                == name]
        files[name] = planted(files[name], mine)
    return files


def build(source: str, variants: dict, out_dir: pathlib.Path) -> dict:
    """{name: the variant's entry point}, each variant built in its own
    directory (its headers beside it shadow the originals), in parallel."""
    from repro_torch.kernels import _build
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        where = out_dir / str(i)
        where.mkdir(parents=True, exist_ok=True)
        for fname, text in variant(source, subs).items():
            (where / fname).write_text(text)
        so = where / f"lib{i}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.flags(CSRC / source), "-I", str(where),
             "-o", str(so), str(where / source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), ENTRY[source])
        fn.argtypes = _build._SIGNATURES[ENTRY[source]]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def use(source: str, fn) -> None:
    """Put ``fn`` in the wrapper's place (the wrapper reaches its entry
    points through ``_build.load()``)."""
    from repro_torch.kernels import _build
    lib = _build.load()
    _build._LIB = types.SimpleNamespace(**{**vars(lib), ENTRY[source]: fn})


def rnd(torch, gen, shape, dt):
    return torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dt))


def faults(torch, chip_smoke, FA, fns) -> bool:
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    ok = True
    for name, fn in fns.items():
        use(FORWARD, fn)
        gen = torch.Generator(device="cuda").manual_seed(3)
        errs = []
        cases = [(shape, dt, dict(causal=causal, softcap=cap))
                 for shape, dt, causal, cap, *_ in chip_smoke.FLASH_CASES]
        cases += [(shape, dt, dict(causal=True, softcap=cap, window=w))
                  for shape, dt, w, cap, *_ in chip_smoke.WINDOW_FLASH_CASES]
        for shape, dt, kw in cases:
            q, k, v = (rnd(torch, gen, shape, dt) for _ in range(3))
            if dt != "bfloat16" or shape[2] not in chip_smoke.TENSOR_CORE_DH:
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
        ok &= report(name, verdict, errs)
    return ok


def faults_bwd(torch, chip_smoke, FA, fns) -> bool:
    ok = True
    for name, fn in fns.items():
        use(BACKWARD, fn)
        try:
            errs = chip_smoke.check_flash_bwd(torch, FA)
            verdict = "passes check_flash_bwd"
        except AssertionError as exc:
            errs, verdict = [], f"fails check_flash_bwd ({exc})"
        ok &= report(name, verdict, errs)
    return ok


def report(name, verdict, errs) -> bool:
    expected = name.startswith("control") == verdict.startswith("passes")
    print(f"[fault] {name}: {verdict}{'' if expected else ' -- WRONG'}",
          flush=True)
    for e in errs:
        print(f"[fault]   {e}", flush=True)
    return expected


def in_turns(torch, chip_smoke, source, kernel, fn, run, flush) -> dict:
    ms = {}
    for which in ("kernel", "copy", "copy", "kernel"):
        use(source, kernel if which == "kernel" else fn)
        ms.setdefault(which, []).append(chip_smoke.median_ms(
            torch, run, 20, flush))
    return ms


def ablations(torch, chip_smoke, FA, fns) -> bool:
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    kernel = fns.pop("kernel")
    inputs = {}
    for name, fn in fns.items():
        for shape, kw in ABLATION_SHAPES[name]:
            if shape not in inputs:
                inputs.clear()
                inputs[shape] = [rnd(torch, gen, shape, "bfloat16")
                                 for _ in range(3)]
            q, k, v = inputs[shape]
            use(FORWARD, fn)
            err = float((FA.flash_attention(q, k, v, **kw).double()
                         - FA.flash_attention_plain(q, k, v, **kw)
                         .double()).abs().max())
            ok &= err <= 3e-2
            ms = in_turns(torch, chip_smoke, FORWARD, kernel, fn,
                          lambda: FA.flash_attention(q, k, v, **kw), flush)
            print(f"[ablation] {name}, {tuple(q.shape)} {kw}: copy "
                  f"{ms['copy'][0]:.4f} / {ms['copy'][1]:.4f} ms, kernel "
                  f"{ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f} ms "
                  f"(max |d| {err:.4g})", flush=True)
    return ok


def ablations_bwd(torch, chip_smoke, FA, fns) -> bool:
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (rnd(torch, gen, (4 * 36, 2048, 128), "bfloat16")
                   for _ in range(4))
    kernel = fns.pop("kernel")
    use(BACKWARD, kernel)
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    case = (q, k, v, o, lse, do)
    ok = True
    for name, fn in fns.items():
        use(BACKWARD, fn)
        try:
            share = chip_smoke.bwd_rel(FA, FA.flash_attention_backward(*case),
                                       case)[0]
        except AssertionError as exc:
            print(f"[ablation] {name}: beyond BWD_REL ({exc})", flush=True)
            ok = False
            continue
        ms = in_turns(torch, chip_smoke, BACKWARD, kernel, fn,
                      lambda: FA.flash_attention_backward(*case), flush)
        print(f"[ablation] {name}, {tuple(q.shape)} causal: copy "
              f"{ms['copy'][0]:.4f} / {ms['copy'][1]:.4f} ms, kernel "
              f"{ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f} ms "
              f"({share:.3f} of BWD_REL's elementwise limit)", flush=True)
    return ok


def profile(torch, chip_smoke, FA) -> bool:
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape, kw = GEMMA2_GLOBAL[0]
    q, k, v = (rnd(torch, gen, shape, "bfloat16") for _ in range(3))
    FA.flash_attention(q, k, v, **kw)
    chip_smoke.profile_window(
        torch, f"forward {tuple(q.shape)} {kw}, 10 launches",
        lambda: [FA.flash_attention(q, k, v, **kw) for _ in range(10)])
    q, k, v, do = (rnd(torch, gen, (4 * 36, 2048, 128), "bfloat16")
                   for _ in range(4))
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    FA.flash_attention_backward(q, k, v, o, lse, do)
    chip_smoke.profile_window(
        torch, f"backward {tuple(q.shape)} causal, 10 calls",
        lambda: [FA.flash_attention_backward(q, k, v, o, lse, do)
                 for _ in range(10)])
    return True


def against_parent(torch, chip_smoke, FA, parent: pathlib.Path) -> bool:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "flash_variants" / "parent"
    fns = build(FORWARD, {"kernel": []}, out)
    so = out / "libparent.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.flags(CSRC / FORWARD), "-I", str(parent),
         "-o", str(so), str(parent / FORWARD)], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), ENTRY[FORWARD])
    fn.argtypes = _build._SIGNATURES[ENTRY[FORWARD]]
    fn.restype = ctypes.c_int
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, kw in DH64_128:
        q, k, v = (rnd(torch, gen, shape, "bfloat16") for _ in range(3))
        ms = in_turns(torch, chip_smoke, FORWARD, fns["kernel"], fn,
                      lambda: FA.flash_attention(q, k, v, **kw), flush)
        print(f"[parent] {shape} {kw}: parent {ms['copy'][0]:.4f} / "
              f"{ms['copy'][1]:.4f} ms, kernel {ms['kernel'][0]:.4f} / "
              f"{ms['kernel'][1]:.4f} ms", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=(*TABLES, "profile", "parent"))
    ap.add_argument("--out", default=str(ROOT / "build" / "flash_variants"))
    ap.add_argument("--parent", type=pathlib.Path,
                    help="parent: another tree's csrc directory")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import flash_attention as FA
    print(chip_smoke.nvidia_smi(), flush=True)
    if args.what == "profile":
        return 0 if profile(torch, chip_smoke, FA) else 1
    if args.what == "parent":
        return 0 if against_parent(torch, chip_smoke, FA,
                                   args.parent.resolve()) else 1
    source, table = TABLES[args.what]
    if args.what.startswith("ablations"):
        table = {"kernel": [], **table}
    fns = build(source, table, pathlib.Path(args.out) / args.what)
    run = {"faults": faults, "ablations": ablations,
           "faults-bwd": faults_bwd, "ablations-bwd": ablations_bwd}
    ok = run[args.what](torch, chip_smoke, FA, fns)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
