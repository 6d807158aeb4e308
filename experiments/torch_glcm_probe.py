#!/usr/bin/env python3
"""Splits the GLCM tile kernel's device time by step, on the card.

    python3 experiments/torch_glcm_probe.py [--reps 20]

Builds variants of this checkout's ``src/repro_torch/csrc/glcm.cu`` into
``build/repro_torch/`` (each a text edit of the source, one nvcc each,
all at once) and times each one's ``glcm_tile_kernel`` on the largest
three-family stack of the 60-case cohort (``chip_smoke.py`` phase 7's
input, (2, 160, 96, 160)), at each GLCM block in ``--blocks``:

* ``kernel``: the source as it is;
* ``no-count``: no pair counted (loads, quantisation, histogram clear
  and write only);
* ``no-atomic``: each count a plain shared-memory add (wrong counts: the
  cost of the atomics over plain read-modify-writes);
* ``one-pair``: only the +Z pairs counted (the +Y and +X bins still
  read): how the counting scales with its atomics;
* ``lane-address``: every count to the lane's own bin (no two lanes of a
  warp on one address or bank): the atomics' issue alone;
* ``batch-2``: 2 loads in flight a thread, not 4;
* ``prefetch-mask``: an L2 prefetch of the thread's mask units before its
  first load;
* ``timeline``: each block's start, the ends of its load, count and write
  phases (``%globaltimer``) and its SM, written over its partial row.

``no-count``, ``no-atomic``, ``one-pair``, ``lane-address`` and
``timeline`` give wrong counts: they are probes of cost, never results;
the others are checked against the plain version.  ``kernel`` also
reports the opcode counts of its SASS (``cuobjdump``).  Prints one JSON
line: per variant and block the median ms per call (CUDA events) and each
kernel's device time (a ``torch.profiler`` trace), beside the card's
``nvidia-smi`` name and power limit.  Needs a CUDA card and ``nvcc``.
"""
import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SMID_FN = """
__device__ __forceinline__ int __smid_() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return (int)r;
}
"""


def _now(name):
    return (f"  unsigned {name};\n"
            f"  asm volatile(\"mov.u32 %0, %%globaltimer_lo;\" : \"=r\"({name}));\n")


ROW_COUNT = "  for (int pr = warp; pr < pd * rd; pr += kWarps) {\n    const int p = pr / rd"
LOADED = "  __syncthreads();  // the histogram is clear and every bin is in"
COUNTED = "  __syncthreads();  // every count of the tile is in"
SPANS = "  while (e >= per && p < planes) e -= per, ++p;\n  while (p < planes) {"
PREFETCH = ("  while (e >= per && p < planes) e -= per, ++p;\n"
            "  for (int q = p, f = e; q < planes;) {\n"
            "    asm volatile(\"prefetch.global.L2 [%0];\"\n"
            "                 :: \"l\"(mk + first + q * plane_stride + f));\n"
            "    f += kThreads;\n    while (f >= per && q < planes) f -= per, ++q;\n  }\n"
            "  while (p < planes) {")
PAIR = ("      if ({1}) {{\n        const int q2 = s[c + {0}];\n"
        "        if (q2 >= 0) atomicAdd(&h[q2], 1);")
VARIANTS = {
    "kernel": [],
    "no-count": [(ROW_COUNT, ROW_COUNT.replace("pr < pd * rd", "pr < 0"))],
    "no-atomic": [("atomicAdd(&h[q2], 1);", "h[q2] += 1;")],
    "one-pair": [(PAIR.format("cols", "py"), PAIR.format("cols", "py").replace(
                     "if (q2 >= 0)", "if (q2 >= 1000)")),
                 (PAIR.format("plane_bins", "px"), PAIR.format("plane_bins", "px").replace(
                     "if (q2 >= 0)", "if (q2 >= 1000)"))],
    "lane-address": [("atomicAdd(&h[q2], 1);", "atomicAdd(&hist[lane + q2 - q2], 1);")],
    "batch-2": [("constexpr int kBatch = 4;", "constexpr int kBatch = 2;")],
    "prefetch-mask": [(SPANS, PREFETCH)],
    "timeline": [("  extern __shared__ int smem[];",
                  "  extern __shared__ int smem[];\n" + _now("t0")),
                 (LOADED, LOADED + "\n" + _now("t1")),
                 (COUNTED, COUNTED + "\n" + _now("t2")),
                 ("    row[k] = hist[i * hrow + j] + hist[j * hrow + i];\n  }\n}\n",
                  "    row[k] = hist[i * hrow + j] + hist[j * hrow + i];\n  }\n"
                  "  __syncthreads();\n" + _now("t3")
                  + "  if (threadIdx.x == 0) { row[0] = t0; row[1] = t1; row[2] = t2; "
                  "row[3] = t3; row[4] = __smid_(); }\n}\n"),
                 ("struct Tiling {", SMID_FN + "\nstruct Tiling {")],
}
CHECKED = ("kernel", "batch-2", "prefetch-mask")


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cs):
    """``{variant: (ctypes library, ptxas lines)}``, all built at once."""
    src = (cs._build.CSRC / "glcm.cu").read_text()
    cs._build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            cs.check(old in text, f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = cs._build.BUILD_DIR / f"probe_glcm_{name}.cu"
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
        for entry, argtypes in cs.gl._SIGNATURES.items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, cs.ptxas_lines(log, "glcm_tile"), out)
    return libs


def sass_opcodes(lib_path):
    """Opcode counts of ``glcm_tile_kernel``'s SASS (``cuobjdump``), or None."""
    import collections
    import re
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    ops, on = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            on = "glcm_tile_kernel" in line
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if on and m:
            ops[m.group(1)] += 1
    return dict(ops.most_common(40))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--blocks", default="1,2,4,8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_glcm_probe: no CUDA device")
    cs = load_smoke()
    from repro_torch.core import plan
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cohort = [c for seed in (0, 1, 2) for c in cs.table2_suite(seed=seed)]
    groups = {}
    for _, img, msk, _ in cohort:
        im, m, _ = cs.crop_to_roi(img, msk)
        b = plan.shape_bucket(tuple(s - 2 for s in m.shape))
        groups.setdefault(b, []).append((im, m))
    bucket, members = max(groups.items(), key=lambda kv: np.prod(kv[0]) * len(kv[1]))

    def pad(a):
        return np.pad(a, [(0, b - s) for b, s in zip(bucket, a.shape)])

    imgs = torch.from_numpy(np.stack([pad(im) for im, _ in members])).to(dev)
    msks = torch.from_numpy(np.stack([pad(m).astype(np.float32) for _, m in members])).to(dev)
    flat = (len(imgs), -1)
    rng = ref.intensity_range(imgs.reshape(flat), msks.reshape(flat), dim=1)
    want = cs.gl.glcm_matrix_batch_ref(imgs, msks, value_range=rng)
    libs = build(cs)
    out = {"card": smi, "shape": list(imgs.shape), "masked": int((msks > 0).sum())}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lo, hi = rng
    for name, (lib, ptxas, path) in libs.items():
        out[name] = {"ptxas": ptxas}
        if name == "kernel":
            out[name]["sass"] = sass_opcodes(path)
        if name == "timeline":  # each block's phase stamps, read from its partial row
            for block in (int(b) for b in args.blocks.split(",")):
                d, ry, rz = cs.gl.tiling(imgs.shape[1:], len(imgs), block, sms)
                tiles = cs.gl.tile_count(imgs.shape[1:], d, ry, rz)
                parts = torch.empty((len(imgs), tiles, 32 * 32), dtype=torch.int32, device=dev)
                res = torch.empty((len(imgs), 32, 32), device=dev)
                for _ in range(3):
                    cs.check(lib.glcm_matrix_launch(
                        imgs.data_ptr(), msks.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                        len(imgs), *imgs.shape[1:], 32, d, ry, rz, parts.data_ptr(),
                        res.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0, "launch")
                torch.cuda.synchronize()
                t = parts[:, :, :5].reshape(-1, 5).cpu().numpy().astype(np.int64) % 2 ** 32
                t[:, :4] = (t[:, :4] - t[:, 0].min()) % 2 ** 32

                def pct(x):
                    return [round(float(v) / 1e3, 3) for v in np.percentile(x, [50, 90, 100])]
                out[name][block] = {
                    "tiling": [d, ry, rz], "tiles": int(len(t)),
                    "span_us": float(t[:, 3].max()) / 1e3,
                    "start_spread_us": float(t[:, 0].max()) / 1e3,
                    "load_us": pct(t[:, 1] - t[:, 0]), "count_us": pct(t[:, 2] - t[:, 1]),
                    "write_us": pct(t[:, 3] - t[:, 2]),
                    "blocks_per_sm_max": int(np.bincount(t[:, 4]).max())}
            continue
        for block in (int(b) for b in args.blocks.split(",")):
            fn = cs.with_lib("glcm", lib, lambda b=block: cs.gl.glcm_matrix_batch(
                imgs, msks, block=b, value_range=rng))
            got = fn()
            if name in CHECKED:
                cs.check(torch.equal(got, want), f"{name} at block {block}: counts differ")
            split = cs.device_split(fn)
            out[name][block] = {"ms": cs.time_ms(fn, reps=args.reps),
                                "device_us": {k[:40]: round(us, 3) for k, us in split.items()}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
