"""The port's dry run and the layouts it reads, against the JAX package.

The reference's dry run (``repro/launch/dryrun.py``) compiles each cell on
512 forced host devices; importing it sets ``XLA_FLAGS`` for the process,
so these tests never import it: its constants are read from its source
(``ast``), and its layouts recomputed from what it calls (``pspec``,
``model.abstract()``, ``init_cache`` under ``jax.eval_shape``,
``utils/roofline``), on a stub mesh that has only a ``shape``, which is
all the reference's ``pspec`` reads.  Held:

* ``param_shardings`` equal to the reference's ``pspec`` for every leaf of
  the ten architectures' spec trees, on both production meshes, under the
  default rules and the serving rules (``OPT_DECODE_RULES``);
* ``skip_reason`` for all 40 (arch, shape) pairs;
* each cell's bytes a device (parameters, optimizer state, cache, batch)
  equal to the same sum over the reference's abstract trees and ``pspec``,
  and ``model_flops`` and ``structural_hbm_bytes`` equal to the
  reference's ``utils/roofline``;
* that a cell is built on ``meta`` only: arctic-480b x train_4k grows a
  process's peak RSS by less than 1 GB, and importing the dry run and the
  mesh module touches no device;
* ``main`` writes a report a cell.
"""
import ast
import json
import math
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro.utils import roofline as jax_roofline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import params, registry  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.utils import roofline  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = registry.list_archs()
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Nothing here computes much: one intra-op thread, as the other port
    files, so the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_constants():
    """The reference dry run's module constants, read from its source."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in ("ARCH_RUN_OVERRIDES", "OPT_DECODE_RULES", "FSDP_SERVE_ARCHS"):
                # literals and dict(...) calls: evaluated with no name but dict
                code = compile(ast.Expression(node.value), "dryrun.py", "eval")
                out[name] = eval(code, {"__builtins__": {}, "dict": dict})
    return out


def _stub(kind):
    return types.SimpleNamespace(shape=MESHES[kind])


def test_production_meshes_and_constants_equal_reference():
    for kind, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.shape == MESHES[kind] and list(mesh.shape) == list(mesh.axis_names)
    ref = _reference_constants()
    assert dryrun.ARCH_RUN_OVERRIDES == ref["ARCH_RUN_OVERRIDES"]
    assert dryrun.OPT_DECODE_RULES == ref["OPT_DECODE_RULES"]
    assert dryrun.FSDP_SERVE_ARCHS == ref["FSDP_SERVE_ARCHS"]
    assert list(dryrun.SHAPES) == list(JAX_SHAPES)


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("rules", [None, "decode"])
def test_param_shardings_equal_reference(kind, rules):
    rules = dict(dryrun.OPT_DECODE_RULES) if rules else None
    merged = dict(jax_sharding.DEFAULT_RULES, **(rules or {}))
    mesh = make_production_mesh(multi_pod=kind == "multi")
    n = 0
    for name in ARCHS:
        spec = registry.model_spec(registry.get_config(name))
        ours = sharding.param_shardings(spec, mesh, rules)
        theirs = jax_registry.get_model(jax_registry.get_config(name)).spec()
        assert [p for p, _ in params.tree_paths(spec)] == \
            [p for p, _ in jax_params.tree_paths(theirs)]
        for path, leaf in jax_params.tree_paths(theirs):
            want = jax_sharding.pspec(leaf.axes, rules=merged, mesh=_stub(kind), shape=leaf.shape)
            got = params.get_path(ours, path)
            assert isinstance(got, sharding.NamedSharding) and got.mesh is mesh
            assert tuple(got.spec) == tuple(want), (name, path)
            n += 1
    assert n > 150


def test_skip_reason_equals_reference():
    n_skip = 0
    for arch in ARCHS:
        jcfg = jax_registry.get_config(arch)
        for shape_name, shape in JAX_SHAPES.items():
            want = None
            if shape.name == "long_500k" and not jcfg.supports_long_context:
                want = ("long_500k requires sub-quadratic attention; "
                        f"{arch} is full-attention (see DESIGN.md §Arch-applicability)")
            assert dryrun.skip_reason(arch, shape_name) == want
            n_skip += want is not None
    assert len(ARCHS) * len(JAX_SHAPES) == 40 and n_skip == 8


def _spec_bytes(shape, dtype_bytes, spec, mesh_shape):
    """One device's bytes of a leaf laid out by a reference spec."""
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        k = math.prod(mesh_shape[a] for a in axes)
        assert dim % k == 0
        n *= dim // k
    return n * dtype_bytes


def _reference_cell_bytes(arch, shape_name, kind, rules):
    """The bytes a device holds of one cell, from the reference's trees
    and its ``pspec``, as its ``_build_cell`` lays them out."""
    cfg = jax_registry.get_config(arch)
    shape = JAX_SHAPES[shape_name]
    mesh = _stub(kind)
    merged = dict(jax_sharding.DEFAULT_RULES, **(rules or {}))
    ov = dryrun.ARCH_RUN_OVERRIDES.get(arch, {})
    pdt = jnp.dtype(ov.get("param_dtype", "bfloat16" if shape.kind != "train" else "float32"))
    odt = jnp.dtype(ov.get("opt_dtype", "float32"))
    model = jax_registry.get_model(cfg)
    spec = model.spec()
    psum_ = sum(
        _spec_bytes(leaf.shape, pdt.itemsize,
                    jax_sharding.pspec(leaf.axes, rules=merged, mesh=mesh, shape=leaf.shape),
                    mesh.shape) for _, leaf in jax_params.tree_paths(spec))
    out = {"params": psum_, "opt_state": 0, "cache": 0}
    if shape.kind == "train":
        out["opt_state"] = 2 * psum_ // pdt.itemsize * odt.itemsize + 4
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        cache = jax.eval_shape(lambda: model.init_cache(b, s, dtype=jnp.bfloat16))
        is_ax = lambda x: isinstance(x, jax_sharding.Ax)  # noqa: E731
        pairs = zip(jax.tree.leaves(cache), jax.tree.leaves(model.cache_axes(), is_leaf=is_ax))
        # the port keeps the cache's positions (pos, kpos) in int64 where the
        # reference keeps int32: counted at the port's width
        out["cache"] = sum(
            _spec_bytes(sds.shape, 8 if jnp.issubdtype(sds.dtype, jnp.integer) else
                        sds.dtype.itemsize,
                        jax_sharding.pspec(ax.axes, rules=merged, mesh=mesh, shape=sds.shape),
                        mesh.shape) for sds, ax in pairs)
        batch = {"tokens": ((b, 1), 4)}
    else:
        batch = {"tokens": ((b, s), 4)}
        if cfg.family in ("audio", "encdec"):
            from repro.models.encdec import enc_len_for
            batch["frames"] = ((b, enc_len_for(s), cfg.d_model), 2)
        elif cfg.frontend_tokens:
            batch["prefix"] = ((b, cfg.frontend_tokens, cfg.d_model), 2)
    # the reference passes its cell's rules to pspec unmerged here
    out["batch"] = sum(
        _spec_bytes(shp, nb, jax_sharding.pspec(("batch",) + (None,) * (len(shp) - 1),
                                                rules=rules, mesh=mesh, shape=shp), mesh.shape)
        for shp, nb in batch.values())
    out["total"] = sum(out.values())
    return out, cfg, shape


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_bytes_and_terms_equal_reference(arch):
    for kind in MESHES:
        mesh = make_production_mesh(multi_pod=kind == "multi")
        for shape_name in dryrun.SHAPES:
            if dryrun.skip_reason(arch, shape_name):
                continue
            rules = dryrun.cell_rules(arch, shape_name)
            report, cell = dryrun.lower_cell(arch, shape_name, mesh, rules)
            want, jcfg, jshape = _reference_cell_bytes(arch, shape_name, kind, rules)
            assert report["bytes_per_device"] == want, (arch, shape_name, kind)
            n = report["n_chips"]
            tp = mesh.shape["model"]
            cache_shard = tp if (rules or {}).get("cache_seq") == "model" and \
                jshape.kind == "decode" else 1
            assert report["structural_hbm_bytes"] == jax_roofline.structural_hbm_bytes(
                jcfg, jshape, n, tp, n // tp, cache_shard=cache_shard)
            tokens = jshape.global_batch * (jshape.seq_len if jshape.kind != "decode" else 1)
            fn = jax_roofline.model_flops_train if jshape.kind == "train" else \
                jax_roofline.model_flops_decode
            assert report["model_flops"] == fn(jcfg, tokens)
            assert report["n_params"] == jcfg.n_params
            assert report["n_active_params"] == jcfg.n_active_params
            leaves = [x for k in ("params", "opt_state", "cache", "batch") if k in cell
                      for x in sharding.tree_leaves(cell[k][0])]
            assert leaves and all(t.device.type == "meta" for t in leaves)


def test_roofline_functions_equal_reference():
    for arch in ARCHS:
        cfg, jcfg = registry.get_config(arch), jax_registry.get_config(arch)
        for shape in dryrun.SHAPES.values():
            jshape = JAX_SHAPES[shape.name]
            for n, tp, cs in ((256, 16, 1), (512, 16, 16), (8, 1, 1)):
                assert roofline.structural_hbm_bytes(cfg, shape, n, tp, n // tp, cs) == \
                    jax_roofline.structural_hbm_bytes(jcfg, jshape, n, tp, n // tp, cs)
        assert roofline.model_flops_train(cfg, 4096) == jax_roofline.model_flops_train(jcfg, 4096)
        assert roofline.model_flops_decode(cfg, 77) == jax_roofline.model_flops_decode(jcfg, 77)


_RSS = """
import json, resource, sys
import torch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
report, cell = dryrun.lower_cell("arctic-480b", "train_4k", make_production_mesh())
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"grew_kib": after - before, "total": report["bytes_per_device"]["total"],
                  "n_params": report["n_params"],
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def test_arctic_dry_run_allocates_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _RSS], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    # ~480 B parameters: 1.9 TB in float32, of which one device holds ~7.5 GB
    assert out["n_params"] > 4e11 and out["total"] > 1e9
    assert out["grew_kib"] < 1 << 20, out  # under 1 GB of peak RSS growth
    assert not out["cuda_initialized"]


def test_import_touches_no_device():
    code = ("import torch, repro_torch.launch.dryrun, repro_torch.launch.mesh, "
            "repro_torch.utils.roofline\n"
            "from repro_torch.launch.mesh import make_production_mesh\n"
            "make_production_mesh(); make_production_mesh(multi_pod=True)\n"
            "assert not torch.cuda.is_initialized()\nprint('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stdout + r.stderr


def test_main_writes_a_report_a_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    assert dryrun.main(["--arch", "qwen3-1.7b", "--mesh", "both"]) == 0
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert len(files) == 8
    rec = json.loads((tmp_path / "qwen3-1.7b__train_4k__multi.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16" and rec["n_chips"] == 512
    assert rec["mesh_axes"] == MESHES["multi"] and rec["kind"] == "train"
    assert rec["bytes_per_device"]["total"] < rec["hbm_bytes"] and rec["fits_hbm"]
    skipped = json.loads((tmp_path / "qwen3-1.7b__long_500k__single.json").read_text())
    assert "skipped" in skipped
    assert "done; 0 failures" in capsys.readouterr().out
    assert np.isfinite(rec["roofline"]["compute_s"])
