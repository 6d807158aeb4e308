#!/usr/bin/env python3
"""Design probes of the Fig. 1 variants' masked tile kernels, on the card.

    python3 experiments/torch_variant_probe.py [--blocks 256] [--reps 10]

Builds variants of this checkout's ``src/repro_torch/csrc/diameter.cu``
into ``build/repro_torch/`` (each a text edit of the source, one nvcc
each, all at once) and times the kernels each edit touches on case
00001-1's unpruned vertex list and the 60-case cohort's largest pass-2b
stack (``chip_smoke.py`` phase 5b's inputs), at each block of
``--blocks``:

* ``kernel``: the source as it is ('fused', 'tri', 'naive', 'tri_prefetch',
  'gram');
* ``gram-groups-1`` / ``gram-groups-4``: 'gram' with 1 or 4 16-row
  groups a warp holding their A fragments (the source holds 2);
* ``gram-no-min-blocks``: 'gram' without its 4-blocks-an-SM launch bound,
  at the registers ptxas picks itself;
* ``tile-rows-before-columns``: 'fused', 'tri' and 'tri_prefetch'
  loading their row vertices before the columns are staged, in flight
  with the columns' loads;
* ``tile-min-5-blocks``: 'fused', 'tri' and 'tri_prefetch' with R = 8
  bounded to 5 blocks an SM.

Every variant's results are held to this tree's kernels (the direct
variants bitwise, 'gram' at rtol 1e-6).  Prints one JSON line: per
variant its ``-Xptxas -v`` lines and SASS hot-loop counts a pair
(``chip_smoke.sass_loop_counts``), and per input, kernel and block the
median ms per call (CUDA events) and the device time (a ``torch.profiler``
trace), beside the card's ``nvidia-smi`` name and power limit.  Needs a
CUDA card and ``nvcc``.
"""
import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
GRAM_BOUND = "__global__ void __launch_bounds__(32 * kGramWarps, 4)"
TILE_BOUND = "__global__ void __launch_bounds__(1024 / R)\n    diameter_tile_kernel"
ROWS = '''
  float rx[R], ry[R], rz[R], m[R][4];
  bool rv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = i * tile + u + r * row_threads;
    rx[r] = vb[row];
    ry[r] = vb[mp + row];
    rz[r] = vb[2 * mp + row];
    rv[r] = mb[row] != 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) m[r][q] = kNeg;
  }
'''
STAGE = '''  stage_columns(vb, mp, tile, j, tc, n_pad,
                [cols, tile](int slot, int ax, float x) { cols[ax * tile + slot] = x; });
'''
VARIANTS = {
    "kernel": [],
    "gram-groups-1": [("constexpr int kGramGroups = 2;", "constexpr int kGramGroups = 1;")],
    "gram-groups-4": [("constexpr int kGramGroups = 2;", "constexpr int kGramGroups = 4;")],
    "gram-no-min-blocks": [(GRAM_BOUND, GRAM_BOUND.replace(", 4)", ")"))],
    "tile-rows-before-columns": [(STAGE + ROWS, ROWS + STAGE)],
    "tile-min-5-blocks": [(TILE_BOUND, TILE_BOUND.replace("(1024 / R)",
                                                          "(1024 / R, R == 8 ? 5 : 1)"))],
}
TIMED = {"kernel": ("fused", "tri", "naive", "tri_prefetch", "gram"),
         "gram-groups-1": ("gram",), "gram-groups-4": ("gram",), "gram-no-min-blocks": ("gram",),
         "tile-rows-before-columns": ("fused", "tri", "tri_prefetch"),
         "tile-min-5-blocks": ("fused", "tri", "tri_prefetch")}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_name(mangled):
    """The probed kernel a mangled name holds: the gram kernel or a tile
    kernel at R = 8, else None."""
    m = re.search(r"diameter_gram_kernel|diameter_tile_kernelILi8ELi\d+ELb\dE", mangled)
    return m and m.group(0)


def build(cs):
    """``{variant: (ctypes library, ptxas lines, library path)}``, all built at once."""
    src = (cs._build.CSRC / "diameter.cu").read_text()
    cs._build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            cs.check(old in text, f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = cs._build.BUILD_DIR / f"probe_diameter_{name}.cu"
        cu.write_text(text)
        out = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen([cs._build._nvcc(), *cs._build.NVCC_FLAGS,
                                         "-I", str(cs._build.CSRC), "-o", str(out), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out))
        for entry, argtypes in cs.dm._SIGNATURES.items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        ptxas = [f"{kernel_name(line)}: {line.split(': ', 1)[-1]}"
                 for line in cs.ptxas_lines(log, "diameter_") if kernel_name(line)]
        libs[name] = (lib, ptxas, out)
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", default="256")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_variant_probe: no CUDA device")
    cs = load_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    suite = cs.table2_suite(seed=0)
    img, msk, sp = next(c[1:] for c in suite if c[0] == "00001-1")
    _, big, _ = cs.crop_to_roi(img, msk)
    f = cs.ref.vertex_fields(torch.from_numpy(big).to(dev), 0.5, sp)
    verts, vmask, _ = cs.ref.compact_vertices(f, cs.ops.vertex_bucket(int(cs.ref.count_vertices(f))))
    cohort = [c[1:] for seed in (0, 1, 2) for c in cs.table2_suite(seed=seed)]
    with cs.Recorder(cs.dm, "max_diameters_sq_batch") as rec:
        cs.BatchedExtractor(variant="seqacc").run(cohort)
    dv, dk = max(rec.calls, key=lambda c: cs.diam_bound_ms(c[1])[1])
    inputs = [("00001-1 unpruned", verts[None], vmask[None]),
              (f"pass-2b stack {tuple(dv.shape[:2])}", dv, dk)]
    libs = build(cs)
    out = {"card": smi}
    for name, (lib, ptxas, path) in libs.items():
        sass = cs.sass_loop_counts(path, "diameter_") or {}
        out[name] = {"ptxas": ptxas,
                     "sass": {kernel_name(fn): {k: round(c[k], 3) for k in cs.SASS_LABELS}
                              for fn, c in sass.items() if kernel_name(fn)}}
        for label, x, m in inputs:
            for block in (int(b) for b in args.blocks.split(",")):
                for variant in TIMED[name]:
                    fn = cs.parent_launcher(lib, x, m, block, variant)
                    got = fn()
                    want = cs.dm.max_diameters_sq_batch(x, m, block=block, variant=variant)
                    if variant == "gram":
                        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                                   rtol=1e-6, err_msg=f"{name} {label}")
                    else:
                        cs.check(torch.equal(got, want), f"{name} {variant} {label}: bits differ")
                    out[name][f"{label} {variant}/{block}"] = {
                        "ms": round(cs.time_ms(fn, reps=args.reps), 4),
                        "device_us": round(cs.device_us_per_call(fn), 2)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
