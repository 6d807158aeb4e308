"""Dry run: lay out every (arch x shape x mesh) cell over a production mesh.

Counterpart of the reference's ``launch/dryrun.py``.  Each cell -- the
parameters, the optimizer state (train), the decode cache (decode) and the
batch of one assigned shape -- is built on the ``meta`` device from the
architecture's spec (``models/params.abstract_params``) and its shapes,
and laid out over the single-pod (16, 16) or multi-pod (2, 16, 16) mesh
(``launch/mesh.make_production_mesh``, shapes alone) by the reference's
rules (``parallel/sharding.param_shardings``, ``tree_shardings``,
``pspec``).  No tensor is allocated and no device is touched: like the
reference's, which runs on forced host devices, this is the one entry
point that does not default to the card.

What changes against the reference: nothing is compiled.  PyTorch runs
its ops eagerly and has no ``cost_analysis``, so a report leaves out what
only a compile gives (collective bytes, temporary bytes, XLA's FLOP count
and its loop and layer extrapolations).  It keeps the reference's keys
where the port has the value (``arch``, ``shape``, ``mesh``,
``mesh_axes``, ``kind``, ``n_chips``, ``n_params``, ``n_active_params``,
``status``, ``skipped``) and adds:

  * ``bytes_per_device``: the bytes one device holds of the parameters,
    the optimizer state, the cache and the batch, each summed over the
    leaves' shard shapes (``NamedSharding.shard_shape``), and their total
    against the card's 80 GB (activations are not counted: they need a
    compiled program);
  * ``model_flops`` and ``structural_hbm_bytes`` (``utils/roofline.py``);
  * ``roofline``: the compute term (model FLOPs a device over the H100
    SXM data sheet's dense bf16 peak) and the memory term (structural
    bytes over the data sheet's HBM bandwidth, ``runtime/autotune``'s
    default H100 profile).  Computed, not measured.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.encdec import enc_len_for
from repro_torch.models.params import abstract_params
from repro_torch.models.registry import ARCHS, get_config, model_class, model_spec
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.autotune import H100_SXM_PROFILE
from repro_torch.train.optimizer import OptState
from repro_torch.utils import roofline

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# NVIDIA H100 SXM data sheet (dense, 700 W): the compute term's peak and
# the device memory a cell's bytes are held against; the memory term's
# bandwidth is the default H100 profile's (3.35 TB/s)
H100_BF16_PEAK = 989e12  # FLOP/s
H100_HBM_BYTES = 80e9
H100_MEM_BW = H100_SXM_PROFILE["mem_bw"]


def skip_reason(arch: str, shape_name: str) -> str | None:
    """Cells excluded by the assignment rules."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return (
            "long_500k requires sub-quadratic attention; "
            f"{arch} is full-attention (see DESIGN.md §Arch-applicability)"
        )
    return None


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, mesh, rules=None):
    """``meta`` stand-ins and shardings for one cell's batch."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int32)}
    if cfg.family in ("audio", "encdec"):
        specs["frames"] = _meta((b, enc_len_for(s), cfg.d_model), torch.bfloat16)
    elif cfg.frontend_tokens:
        specs["prefix"] = _meta((b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    # shape-aware: batch may not divide (e.g. B=1) -> pspec handles it
    shardings = {
        k: shd.NamedSharding(
            mesh,
            shd.pspec(("batch",) + (None,) * (v.dim() - 1), rules=rules, mesh=mesh,
                      shape=tuple(v.shape)),
        )
        for k, v in specs.items()
    }
    return specs, shardings


# The reference's per-arch run overrides, kept as they are so that each
# cell here is the reference's cell: bf16 master weights and moments for
# arctic-480b, and deeper gradient accumulation where one microbatch's
# activations were too large (microbatch_multi: the multi-pod mesh has 32
# batch-axis devices, and a microbatch's batch is kept at least that size).
ARCH_RUN_OVERRIDES = {
    "arctic-480b": dict(microbatch=16, microbatch_multi=8,
                        param_dtype="bfloat16", opt_dtype="bfloat16"),
    "nemotron-4-15b": dict(microbatch=8),
    "internvl2-26b": dict(microbatch=16, microbatch_multi=8),
    "minicpm-2b": dict(microbatch=16, microbatch_multi=8),
    "hymba-1.5b": dict(microbatch=16, microbatch_multi=8),
}


def _abstract_cache(cfg, batch: int, max_len: int, dtype):
    """The decode cache of ``cfg``'s model as ``meta`` tensors, and its
    logical axes: the model's own ``init_cache`` and ``cache_axes`` on an
    instance that holds no parameter."""
    cls = model_class(cfg)
    bare = cls.__new__(cls)
    torch.nn.Module.__init__(bare)
    bare.cfg, bare.device = cfg, torch.device("meta")
    return bare.init_cache(batch, max_len, dtype=dtype), bare.cache_axes()


def _build_cell(cfg, shape, mesh, rules=None, microbatch=4, serve_bf16=True,
                force_microbatch=None):
    """One cell's trees as ``meta`` tensors beside their shardings, and its
    model FLOPs: ``({"run", "params", "opt_state", "cache", "batch"},
    model_flops)``, each tree entry a pair ``(tree, shardings)`` (absent
    where the cell's kind has none).

    Train cells default to 4 gradient-accumulation microbatches; decode and
    prefill cells hold bf16 parameters unless ``serve_bf16`` is off, as the
    reference's.
    """
    ov = ARCH_RUN_OVERRIDES.get(cfg.name, {})
    microbatch = ov.get("microbatch", microbatch)
    if "pod" in mesh.shape:
        microbatch = ov.get("microbatch_multi", microbatch)
    if force_microbatch is not None:
        microbatch = force_microbatch
    default_pdt = "bfloat16" if serve_bf16 and shape.kind != "train" else "float32"
    param_dtype = getattr(torch, ov.get("param_dtype", default_pdt))
    opt_dtype = getattr(torch, ov.get("opt_dtype", "float32"))
    spec = model_spec(cfg)
    run = RunConfig(microbatch=microbatch,
                    gather_weights_once=ov.get("gather_weights_once", False))
    with shd.use_mesh(mesh, rules):
        p_sh = shd.param_shardings(spec, mesh, rules)
        cell = {"run": run, "params": (abstract_params(spec, param_dtype), p_sh)}
        batch = input_specs(cfg, shape, mesh, rules)
        if shape.kind == "train":
            moments = abstract_params(spec, opt_dtype)
            cell["opt_state"] = (OptState(_meta((), torch.int32), moments, moments),
                                 OptState(shd.NamedSharding(mesh, ()), p_sh, p_sh))
            mflops = roofline.model_flops_train(cfg, shape.global_batch * shape.seq_len)
        elif shape.kind == "prefill":
            mflops = roofline.model_flops_decode(cfg, shape.global_batch * shape.seq_len)
        else:  # decode
            b = shape.global_batch
            cache, axes = _abstract_cache(cfg, b, shape.seq_len, torch.bfloat16)
            cell["cache"] = (cache, shd.tree_shardings(cache, axes, mesh, rules))
            tok_sh = shd.NamedSharding(
                mesh, shd.pspec(("batch", None), rules=rules, mesh=mesh, shape=(b, 1)))
            batch = ({"tokens": _meta((b, 1), torch.int32)}, {"tokens": tok_sh})
            mflops = roofline.model_flops_decode(cfg, shape.global_batch)
        cell["batch"] = batch
    return cell, mflops


def device_bytes(tree, shardings) -> int:
    """The bytes one device holds of ``tree`` laid out by ``shardings``."""
    return sum(math.prod(sh.shard_shape(tuple(t.shape))) * t.element_size()
               for t, sh in zip(shd.tree_leaves(tree), shd.tree_leaves(shardings)))


def lower_cell(arch: str, shape_name: str, mesh, rules=None, serve_bf16=True):
    """Build and lay out one cell.  Returns ``(report, cell)``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_chips = math.prod(mesh.shape.values())
    t0 = time.time()
    cell, mflops = _build_cell(cfg, shape, mesh, rules, serve_bf16=serve_bf16)
    held = {k: device_bytes(*cell[k]) if k in cell else 0
            for k in ("params", "opt_state", "cache", "batch")}
    held["total"] = sum(held.values())
    tp = mesh.shape.get("model", 1)
    dp = n_chips // tp
    cache_shard = tp if (rules or {}).get("cache_seq") == "model" and shape.kind == "decode" else 1
    struct = roofline.structural_hbm_bytes(cfg, shape, n_chips, tp, dp, cache_shard=cache_shard)
    compute_s = mflops / n_chips / H100_BF16_PEAK
    memory_s = struct / H100_MEM_BW
    report = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(v) for v in mesh.shape.values()),
        "mesh_axes": dict(mesh.shape),
        "kind": shape.kind,
        "n_chips": n_chips,
        "build_s": round(time.time() - t0, 3),
        "n_params": cfg.n_params,
        "n_active_params": cfg.n_active_params,
        "microbatch": cell["run"].microbatch if shape.kind == "train" else None,
        "bytes_per_device": held,
        "hbm_bytes": H100_HBM_BYTES,
        "hbm_share": held["total"] / H100_HBM_BYTES,
        "fits_hbm": held["total"] <= H100_HBM_BYTES,
        "model_flops": mflops,
        "structural_hbm_bytes": struct,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "dominant": "compute" if compute_s >= memory_s else "memory",
            "peak_flops_bf16": H100_BF16_PEAK,
            "mem_bw": H100_MEM_BW,
            "source": "NVIDIA H100 SXM data sheet (dense, 700 W); computed, not measured",
        },
    }
    return report, cell


# The reference's serving rules: a sequence-sharded cache with head_dim
# over 'model', and no FSDP of the weights ("embed": None) for decode;
# arctic-480b keeps FSDP (its bf16 experts cannot replicate over 'data').
OPT_DECODE_RULES = {"cache_seq": "model", "head_dim": "model", "embed": None}
FSDP_SERVE_ARCHS = {"arctic-480b"}


def run_cell(arch, shape_name, mesh_kind, rules=None, suffix="", serve_bf16=True,
             out_dir=None):
    """One cell's report, written to ``out_dir`` (default
    ``experiments/dryrun_torch/``) as ``<arch>__<shape>__<mesh><suffix>.json``."""
    out_dir = Path(out_dir) if out_dir is not None else OUT_DIR
    reason = skip_reason(arch, shape_name)
    name = f"{arch}__{shape_name}__{mesh_kind}{suffix}"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{name}.json"
    if reason:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": reason}
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[skip] {name}: {reason}")
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    try:
        report, _ = lower_cell(arch, shape_name, mesh, rules, serve_bf16=serve_bf16)
        report["status"] = "ok"
    except Exception as e:  # reported in the cell's file; main exits 1
        report = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
        print(f"[FAIL] {name}: {report['error']}")
        out_path.write_text(json.dumps(report, indent=2))
        return report
    out_path.write_text(json.dumps(report, indent=2))
    held, r = report["bytes_per_device"], report["roofline"]
    print(
        f"[ok] {name}: a device holds params {held['params'] / 1e9:.3f} GB, opt "
        f"{held['opt_state'] / 1e9:.3f} GB, cache {held['cache'] / 1e9:.3f} GB, batch "
        f"{held['batch'] / 1e9:.4f} GB, total {held['total'] / 1e9:.3f} GB "
        f"({report['hbm_share']:.3f} of 80 GB); computed terms: compute "
        f"{r['compute_s']:.3e} s, memory {r['memory_s']:.3e} s ({r['dominant']})"
    )
    return report


def cell_rules(arch: str, shape_name: str, baseline=False, cache_seq_shard=False):
    """The rules ``main`` lays a cell out by: the serving rules for decode
    cells (or every cell under ``cache_seq_shard``), none under
    ``baseline``; FSDP weights kept for :data:`FSDP_SERVE_ARCHS`."""
    if cache_seq_shard and not baseline:
        rules = dict(OPT_DECODE_RULES)
    elif not baseline and SHAPES[shape_name].kind == "decode":
        rules = dict(OPT_DECODE_RULES)
    else:
        rules = None
    if rules is not None and arch in FSDP_SERVE_ARCHS:
        rules.pop("embed", None)  # keep FSDP weights
    return rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="lay out every (arch x shape x mesh) cell")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="the reference's pre-optimisation configuration: batch-only "
                         "cache sharding, FSDP attention weights, f32 serving")
    ap.add_argument("--cache-seq-shard", action="store_true",
                    help="the serving rules on every cell (the decode default)")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="bf16 decode parameters for --arch (the default; see --baseline)")
    ap.add_argument("--suffix", default="", help="output filename suffix")
    args = ap.parse_args(argv)

    if args.serve_bf16:
        ARCH_RUN_OVERRIDES.setdefault(args.arch, {})["param_dtype"] = "bfloat16"
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    # --all is a convenience for "no filters"; --arch/--shape narrow the sweep
    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)

    n_fail = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                rules = cell_rules(arch, shape_name, args.baseline, args.cache_seq_shard)
                rec = run_cell(arch, shape_name, mesh_kind, rules=rules, suffix=args.suffix,
                               serve_bf16=not args.baseline)
                if rec.get("status") == "FAILED":
                    n_fail += 1
    print(f"done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
