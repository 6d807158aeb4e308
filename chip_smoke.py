#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, drives the main
path (single-case shape extraction through ``ShapeFeatureExtractor``) over
the 20 synthetic Table-2 cases, checks the features against the port's CPU
path, and prints one JSON line per kernel and a last JSON status line.
Any failed check raises, so the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.

Phases:
  1. set-up: card, versions, TF32 flags, kernel build
  2. marching-cubes kernel vs plain (case 00001-1 and a sphere), rtol 1e-5,
     two runs bitwise equal; kernel, plain and bound times
  3. diameter kernel vs plain, bitwise (00001-1's unpruned vertex list and
     random inputs with masked slots); times, bound, a cdist yardstick
  4. main path: 20 Table-2 cases on the card (prune on) plus 00001-1 with
     prune off, launch counts reset just before and read just after;
     features against the CPU path at rtol 1e-4, prune on == off bitwise;
     then one traced case for the device's busy and idle share
  5. the kernels line; 6. the status line
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import ShapeFeatureExtractor, crop_to_roi  # noqa: E402
from repro_torch.core import mc_tables  # noqa: E402
from repro_torch.data.synthetic import table2_suite  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import diameter as dm  # noqa: E402
from repro_torch.kernels import marching_cubes as mc  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM bandwidth
# and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations the MC kernel does, counted from csrc/marching_cubes.cu:
# 8 compares per cell; per triangle 3 vertices x 12 (interpolation and
# position) + 23 (area) + 16 (signed volume).
MC_OPS_PER_CELL = 8
MC_OPS_PER_TRIANGLE = 75
# per pair: 3 sub, 3 mul, 4 add, 4 max (csrc/diameter.cu)
DIAM_OPS_PER_PAIR = 14
KEYS = [
    "MeshVolume", "VoxelVolume", "SurfaceArea", "SurfaceVolumeRatio",
    "Sphericity", "Compactness1", "Compactness2", "SphericalDisproportion",
    "Maximum3DDiameter", "Maximum2DDiameterSlice", "Maximum2DDiameterColumn",
    "Maximum2DDiameterRow", "MajorAxisLength", "MinorAxisLength",
    "LeastAxisLength", "Elongation", "Flatness",
]
DIAM_KEYS = KEYS[8:12]


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single calls timed with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_trace(fn, reps=1):
    """Per-call device time (us) of every kernel and copy ``fn`` runs, and
    the per-call wall time (ms), from a torch.profiler trace after warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    per_kernel = {e.key: e.device_time_total / reps for e in prof.key_averages()
                  if e.device_time_total > 0}
    return per_kernel, wall_ms


def kernel_us(per_kernel, names):
    total = sum(us for key, us in per_kernel.items() if any(n in key for n in names))
    return f"{total:.2f} us" if total > 0 else "not measured"


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def sphere_volume(n, r):
    g = np.arange(n) - (n - 1) / 2
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return np.pad((x * x + y * y + z * z <= r * r).astype(np.float32), 1)


def main():
    # -- 1. set-up ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] card: {smi}")
    print(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"[setup] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[setup] built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[setup] {name}: {line.strip()}")

    suite = table2_suite(seed=0)
    cases = {name: (img, msk, sp) for name, img, msk, sp in suite}
    img, msk, sp = cases["00001-1"]
    _, big, _ = crop_to_roi(img, msk)
    big_dev = torch.from_numpy(big).to(dev)
    print(f"[setup] case 00001-1 crops to {big.shape} ({big.size} voxels)")

    # -- 2. marching cubes: kernel vs plain ---------------------------------
    mc_err = 0.0
    for label, vol, spacing in [("00001-1", big_dev, sp),
                                ("sphere96", torch.from_numpy(sphere_volume(96, 40.0)).to(dev),
                                 np.ones(3, np.float32))]:
        kv, ka = mc.mc_volume_area(vol, 0.5, spacing)
        kv2, ka2 = mc.mc_volume_area(vol, 0.5, spacing)
        pv, pa = ref.mc_volume_area(vol, 0.5, spacing)
        k = np.array([kv.item(), ka.item()])
        p = np.array([pv.item(), pa.item()])
        check(np.all(np.isfinite(k)) and k[0] > 0 and k[1] > 0, f"mc {label}: {k}")
        np.testing.assert_allclose(k, p, rtol=1e-5, err_msg=f"mc kernel vs plain, {label}")
        check(np.array_equal(k, [kv2.item(), ka2.item()]), f"mc {label}: runs differ")
        mc_err = max(mc_err, float(np.max(np.abs(k - p))))
        print(f"[mc] {label}: kernel (vol, area) = {k.tolist()}, plain = {p.tolist()}, "
              f"rtol 1e-5 ok, repeat bitwise ok")
    mc_ms = time_ms(lambda: mc.mc_volume_area(big_dev, 0.5, sp))
    mc_plain_ms = time_ms(lambda: ref.mc_volume_area(big_dev, 0.5, sp))
    cube = ref._cell_cube_index(big_dev, 0.5).long()
    n_tris = int(torch.as_tensor(mc_tables.N_TRIS, device=dev)[cube].sum())
    mc_bytes = 4 * big.size + 2 * 4
    mc_ops = MC_OPS_PER_CELL * cube.numel() + MC_OPS_PER_TRIANGLE * n_tris
    mc_bound = {"bytes": mc_bytes / PEAK_BYTES_PER_S * 1e3, "operations": mc_ops / PEAK_FP32_PER_S * 1e3}
    mc_dev, _ = device_trace(lambda: mc.mc_volume_area(big_dev, 0.5, sp), reps=10)
    print(f"[mc] 00001-1: kernel {mc_ms:.4f} ms/call (device kernels "
          f"{kernel_us(mc_dev, ['mc_partials_kernel', 'mc_finalize_kernel'])}), plain "
          f"{mc_plain_ms:.4f} ms, bound {max(mc_bound.values()):.5f} ms "
          f"(bytes {mc_bound['bytes']:.5f}, ops {mc_bound['operations']:.5f}; "
          f"{n_tris} triangles)")

    # -- 3. diameter: kernel vs plain ---------------------------------------
    f = ref.vertex_fields(big_dev, 0.5, sp)
    n_big = int(ref.count_vertices(f))
    verts, vmask, _ = ref.compact_vertices(f, ops.vertex_bucket(n_big))
    print(f"[diam] 00001-1: {n_big} valid vertices in a {len(verts)}-slot bucket")
    rng = np.random.default_rng(0)
    diam_inputs = [("00001-1", verts, vmask)]
    for m in (1, 2, 513, 4096):
        v = torch.from_numpy((rng.normal(size=(m, 3)) * 60 + 100).astype(np.float32)).to(dev)
        keep = torch.from_numpy(rng.random(m) < 0.8).to(dev)
        keep[m // 2] = True
        diam_inputs.append((f"random M={m}", v, keep))
    diam_err = 0.0
    for label, v, keep in diam_inputs:
        k = dm.max_diameters_sq(v, keep)
        p = ref.max_diameters_sq(v, keep, dm.DEFAULT_BLOCK)
        check(bool(torch.isfinite(k).all()), f"diameter {label}: {k}")
        check(torch.equal(k, p), f"diameter kernel vs plain not bitwise, {label}: "
                                 f"{k.tolist()} vs {p.tolist()}")
        diam_err = max(diam_err, float((k - p).abs().max()))
        print(f"[diam] {label}: kernel == plain bitwise {k.tolist()}")
    diam_ms = time_ms(lambda: dm.max_diameters_sq(verts, vmask))
    diam_plain_ms = time_ms(lambda: ref.max_diameters_sq(verts, vmask, dm.DEFAULT_BLOCK),
                            reps=5, warmup=1)
    pairs = n_big * (n_big + 1) // 2
    diam_bound = {"bytes": (13 * len(verts) + 16) / PEAK_BYTES_PER_S * 1e3,
                  "operations": DIAM_OPS_PER_PAIR * pairs / PEAK_FP32_PER_S * 1e3}
    diam_dev, _ = device_trace(lambda: dm.max_diameters_sq(verts, vmask), reps=10)
    print(f"[diam] 00001-1: kernel {diam_ms:.4f} ms/call (device kernels "
          f"{kernel_us(diam_dev, ['diameter_tiles_kernel', 'diameter_finalize_kernel'])}), plain "
          f"{diam_plain_ms:.4f} ms, bound {max(diam_bound.values()):.5f} ms "
          f"({pairs} pairs x {DIAM_OPS_PER_PAIR} FP32 ops)")
    _, v4k, k4k = diam_inputs[-1]
    v4k_valid = v4k[k4k]
    yard_ms = time_ms(lambda: torch.cdist(v4k_valid, v4k_valid).amax())
    yard_kernel_ms = time_ms(lambda: dm.max_diameters_sq(v4k, k4k))
    print(f"[diam] yardstick, 3D combo only, random M=4096 ({len(v4k_valid)} valid): "
          f"torch.cdist(v, v).amax() {yard_ms:.4f} ms vs kernel (all 4 combos) "
          f"{yard_kernel_ms:.4f} ms")

    # -- 4. the main path ---------------------------------------------------
    ext = ShapeFeatureExtractor()  # default device: the card
    mc.LAUNCHES = 0
    dm.LAUNCHES = 0
    results = {}
    t0 = time.perf_counter()
    for name, img, msk, sp in suite:
        t1 = time.perf_counter()
        feats, times = ext.execute(img, msk, sp, with_times=True)
        wall_ms = (time.perf_counter() - t1) * 1e3
        results[name] = (feats, times, ext.last_prune_info, wall_ms)
    wall_s = time.perf_counter() - t0
    img, msk, sp = cases["00001-1"]
    unpruned = ShapeFeatureExtractor(prune=False).execute(img, msk, sp)
    launches = {"mc_volume_area": mc.LAUNCHES, "max_diameters_sq": dm.LAUNCHES}
    print(f"[main] {len(suite)} cases in {wall_s:.3f} s = {len(suite) / wall_s:.3f} cases/s; "
          f"launches {launches}")
    # wall_ms: host clock around execute; it adds the untimed PCA and feature
    # assembly (and any first-use set-up) to the four stages' total_ms
    print("[main] case      shape            verts    kept  prep_ms  xfer_ms  mesh_ms  diam_ms"
          "  total_ms   wall_ms")
    for name, img, msk, sp in suite:
        feats, t, info, wall_ms = results[name]
        check(all(np.isfinite(feats[k]) for k in KEYS), f"{name}: non-finite features")
        print(f"[main] {name}  {str(img.shape):15s} {int(feats['_n_mesh_vertices']):7d} "
              f"{info.m_kept:7d} "
              f"{t.preprocess_ms:8.3f} {t.transfer_ms:8.3f} {t.mesh_ms:8.3f} "
              f"{t.diameter_ms:8.3f} {t.total_ms:9.3f} {wall_ms:9.3f}")
    pruned = results["00001-1"][0]
    check(all(pruned[k] == unpruned[k] for k in DIAM_KEYS),
          f"00001-1: prune on/off diameters differ: "
          f"{[pruned[k] for k in DIAM_KEYS]} vs {[unpruned[k] for k in DIAM_KEYS]}")
    print("[main] 00001-1: prune on == prune off diameters, bitwise")
    cpu = ShapeFeatureExtractor(device="cpu")
    for name, img, msk, sp in suite:
        ref_feats = cpu.execute(img, msk, sp)
        feats = results[name][0]
        for k in KEYS:
            np.testing.assert_allclose(feats[k], ref_feats[k], rtol=1e-4, err_msg=f"{name} {k}")
        check(feats["_n_mesh_vertices"] == ref_feats["_n_mesh_vertices"], f"{name}: vertex count")
    print(f"[main] all {len(suite)} cases: card == CPU path (17 features rtol 1e-4, "
          f"vertex counts exact)")
    check(all(n > 0 for n in launches.values()), f"a kernel of the path never ran: {launches}")
    # device busy and idle share of one traced execute (after the counted run)
    for name in ("00001-1", "00009-2"):
        img, msk, sp = cases[name]
        per_kernel, wall_ms = device_trace(lambda: ext.execute(img, msk, sp))
        busy_ms = sum(per_kernel.values()) / 1e3
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
        print(f"[trace] {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
              f"share {1 - busy_ms / wall_ms:.4f}, {len(per_kernel)} kernel names; top: "
              + "; ".join(f"{k[:48]} {us:.1f} us" for k, us in top))

    # -- 5. kernels line ----------------------------------------------------
    kernels = [
        {"name": "mc_volume_area", "route": "cuda",
         "source": "src/repro_torch/csrc/marching_cubes.cu",
         "replaces": "src/repro/kernels/marching_cubes.py:98",
         "launches": launches["mc_volume_area"], "max_abs_err": mc_err,
         "ms": mc_ms, "plain_ms": mc_plain_ms, "bound_ms": max(mc_bound.values()),
         "bound_by": max(mc_bound, key=mc_bound.get), "library_ms": None},
        {"name": "max_diameters_sq", "route": "cuda",
         "source": "src/repro_torch/csrc/diameter.cu",
         "replaces": "src/repro/kernels/diameter.py:137",
         "launches": launches["max_diameters_sq"], "max_abs_err": diam_err,
         "ms": diam_ms, "plain_ms": diam_plain_ms, "bound_ms": max(diam_bound.values()),
         "bound_by": max(diam_bound, key=diam_bound.get), "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    # -- 6. status ------------------------------------------------------------
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
