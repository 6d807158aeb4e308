#!/usr/bin/env python3
"""The main path's diameter sweep on the card: blocks, the parent's kernels, dispatch rates.

    python3 experiments/torch_diameter_sweep.py [--parent build/ab_parent]

Loads this checkout's ``chip_smoke.py`` (its helpers and its
``repro_torch``) and prints one JSON line per measurement, each beside the
card's ``nvidia-smi`` name and power limit:

* ``ab``: with ``--parent`` (a checkout of another commit unpacked with
  ``git archive``), that tree's 'seqacc' and 'nomask' kernels against this
  tree's at blocks 64-1024 on case 00001-1's unpruned vertex list and the
  cohort's largest pass-2b stack, in turns, by CUDA events and trace
  device time (``chip_smoke.diameter_ab``);
* ``sweep``: the autotuner's own measurement
  (``autotune.measure_diameter_configs``: device time, candidates in
  turns, median of rounds) of 'seqacc' and 'nomask' at blocks 64-1024 on
  its probe stacks, per vertex bucket 512-131072 and depth 1, 4, 16;
* ``dispatch``: a throughput kernel built here (FADD only, FMNMX only, and
  the sweep's 10:4 mix of FADD/FMUL and FMNMX, 16 independent chains a
  thread, the card full of warps): warp instructions per SM per clock at
  the sampled SM clock, which says whether FMNMX dispatches at the FP32 rate.

Needs a CUDA card and ``nvcc``.
"""
import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BLOCKS = (64, 128, 256, 512, 1024)

RATE_SRC = r"""
#include <cuda_runtime.h>
// mode 0: FADD only; 1: FMNMX only; 2: the sweep's mix, per 14 operations
// 3 FADD (the differences), 3 FMUL, 4 FADD and 4 FMNMX.  16 independent
// chains a thread; y changes every iteration so nothing folds.
__global__ void rate_kernel(float* out, int iters, int mode) {
  float x[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) x[k] = threadIdx.x * 1e-3f + k;
  float y = blockIdx.x * 1e-6f;
  for (int it = 0; it < iters; ++it) {
    y = __fadd_rn(y, 1.0f);
    if (mode == 0) {
#pragma unroll
      for (int k = 0; k < 16; ++k) x[k] = __fadd_rn(x[k], y);
    } else if (mode == 1) {
#pragma unroll
      for (int k = 0; k < 16; ++k) x[k] = fmaxf(x[k], y);
    } else {
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        const float d0 = __fsub_rn(x[k], y), d1 = __fsub_rn(x[k + 1], y);
        const float d2 = __fsub_rn(x[k + 2], y);
        const float q0 = __fmul_rn(d0, d0), q1 = __fmul_rn(d1, d1), q2 = __fmul_rn(d2, d2);
        const float q01 = __fadd_rn(q0, q1);
        x[k] = fmaxf(x[k], __fadd_rn(q01, q2));
        x[k + 1] = fmaxf(x[k + 1], q01);
        x[k + 2] = fmaxf(x[k + 2], __fadd_rn(q0, q2));
        x[k + 3] = fmaxf(x[k + 3], __fadd_rn(q1, q2));
      }
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) s = __fadd_rn(s, x[k]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int rate_launch(float* out, int blocks, int threads, int iters, int mode,
                            void* stream) {
  rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, mode);
  return cudaGetLastError();
}
"""


def load_smoke(root: Path):
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dispatch_rates(cs):
    """Warp instructions per SM per clock of each mode of ``rate_kernel``."""
    b = cs._build
    src = b.BUILD_DIR / "dispatch_rate.cu"
    lib_path = b.BUILD_DIR / "libdispatch_rate.so"
    b.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(RATE_SRC)
    subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 8, 256, 1 << 16
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # per iteration: the y update and 16 chain operations (mode 2: 4 x 14 / 4 ...)
    per_iter = {0: 17, 1: 17, 2: 1 + 4 * 14}
    res = {}
    for mode, label in ((0, "fadd"), (1, "fmnmx"), (2, "sweep_mix")):
        def call():
            assert lib.rate_launch(out.data_ptr(), blocks, threads, iters, mode, stream) == 0
        smi = cs.smi_sampler()
        ms = cs.time_ms(call, reps=50, warmup=2)
        clocks = cs.smi_summary(smi)
        if clocks is None:
            raise SystemExit("torch_diameter_sweep: nvidia-smi gave no clock sample")
        clk = clocks["clocks_sm_mhz"][1] * 1e6
        warp_instr = blocks * threads / 32 * iters * per_iter[mode]
        res[label] = {"ms": ms, "warp_instr_per_sm_clk": warp_instr / (ms * 1e-3) / clk / sms,
                      "clocks": clocks}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_diameter_sweep: no CUDA device")
    cs = load_smoke(ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    print(json.dumps({"card": smi, "dispatch": dispatch_rates(cs)}), flush=True)
    if args.parent:
        suite = cs.table2_suite(seed=0)
        img, msk, sp = next(c[1:] for c in suite if c[0] == "00001-1")
        _, big, _ = cs.crop_to_roi(img, msk)
        f = cs.ref.vertex_fields(torch.from_numpy(big).to(dev), 0.5, sp)
        n = int(cs.ref.count_vertices(f))
        verts, vmask, _ = cs.ref.compact_vertices(f, cs.ops.vertex_bucket(n))
        cohort = [c[1:] for seed in (0, 1, 2) for c in cs.table2_suite(seed=seed)]
        with cs.Recorder(cs.dm, "max_diameters_sq_batch") as rec:
            cs.BatchedExtractor().run(cohort)
        dv, dk = max(rec.calls, key=lambda c: cs.diam_bound_ms(c[1])[1])
        inputs = [("00001-1 unpruned", verts[None], vmask[None]),
                  (f"pass-2b stack {tuple(dv.shape[:2])}", dv, dk)]
        rows, clocks = cs.diameter_ab(args.parent, inputs, BLOCKS)
        for label, variant, block, ms_o, ms_n, us_o, us_n in rows:
            print(json.dumps({"card": smi, "ab": {
                "input": label, "variant": variant, "block": block, "parent_ms": ms_o,
                "change_ms": ms_n, "parent_device_us": us_o, "change_device_us": us_n,
                "change_over_parent": statistics.median(us_n) / statistics.median(us_o)}}),
                flush=True)
        print(json.dumps({"card": smi, "ab_clocks": clocks}), flush=True)
    if not args.no_sweep:
        a = cs.autotune
        for bucket in (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072):
            for depth in (1, 4, 16):
                if bucket * depth > 131072 * 4:
                    continue
                configs = [a.DiameterConfig(v, b) for v in ("seqacc", "nomask")
                           for b in BLOCKS if b <= bucket]
                t = a.measure_diameter_configs(bucket, dev, configs, batch=depth)
                best = min(t, key=t.get)
                print(json.dumps({"card": smi, "sweep": {
                    "bucket": bucket, "depth": depth, "best": f"{best.variant}/{best.block}",
                    "us": {f"{c.variant}/{c.block}": round(s * 1e6, 2) for c, s in t.items()}}}),
                    flush=True)


if __name__ == "__main__":
    main()
