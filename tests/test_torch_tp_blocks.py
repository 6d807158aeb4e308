"""A model laid out over ``model`` from its own blocks, on the CPU.

No slot, and no path that lays a model out, holds a whole copy of a leaf
that ``model`` splits: the reference's model object holds no parameters
and GSPMD gives each device its shards only.  Held here over ``(data,
model)`` meshes of ``'cpu'`` slots:

* ``lay_out`` of a model on ``meta`` from a seed gives every slot, bit for
  bit, its blocks of the whole model drawn from that seed, over ``(1, 2)``,
  ``(1, 4)`` and ``(2, 2)``, for qwen3, deepseek-moe, internvl2, hymba,
  rwkv6 (``d_model=256``) and seamless, reduced;
* a laid-out model holds its rows' blocks and nothing else, and a whole
  model handed to ``lay_out`` is freed once its caller drops it;
* the JAX package's parameters loaded block by block
  (``convert.blocks_from_reference``) give the JAX forward at 1e-4;
* the ``(1, 4)`` ``Trainer`` of a model on ``meta`` gives the steps, the
  checkpoint files and the resumed state of a whole model laid out over
  the same mesh, bitwise; a checkpoint resumes bitwise across one slot,
  ``(1, 4)`` and ``(2, 2)`` and through ``elastic_remesh`` onto ``(1,
  2)``; a checkpoint of the JAX package's ``Trainer`` resumes over ``(1,
  4)``, its next loss the JAX trainer's at 1e-4; over a ``model`` axis
  the ``Trainer`` refuses a model that holds parameters;
* the launcher's ``--model-parallel 2`` builds its model on ``meta``.
"""
import gc
import shutil
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import grid_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    blocks_from_reference,
    opt_state_to_reference,
    params_to_reference,
)
from repro_torch.models.params import tree_paths  # noqa: E402
from repro_torch.models.tensor_parallel import lay_out  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_remesh  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    Trainer,
    checkpoint_shardings,
    checkpoint_skeleton,
)

CONFIGS = {  # name: (architecture, reduced() overrides)
    "qwen3": ("qwen3-1.7b", {}),
    "deepseek-moe": ("deepseek-moe-16b", {}),
    "internvl2": ("internvl2-26b", {}),
    "hymba": ("hymba-1.5b", {}),
    "rwkv6-d256": ("rwkv6-1.6b", {"d_model": 256}),
    "seamless": ("seamless-m4t-large-v2", {}),
}
MESHES = ((1, 2), (1, 4), (2, 2))  # (data, model)
B, S = 4, 16
RTOL = ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread runs them about as fast
    alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    data, model = shape
    return grid_mesh(["cpu"] * (data * model), model)


def _cfg(case):
    name, over = CONFIGS[case]
    return registry.get_config(name).reduced(**over)


# ------------------------------------------------------------ the block draw --

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", CONFIGS)
def test_block_draw_is_the_whole_draws_blocks(case, shape):
    cfg = _cfg(case)
    whole = dict(registry.get_model(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(5))
                 .named_parameters())
    lo = lay_out(registry.get_model(cfg, device="meta"), _mesh(shape), seed=5)
    for g in lo.groups:
        for k, sl in enumerate(g.slots):
            for name, p in sl.named_parameters():
                assert torch.equal(p, whole[name][g.slices(k, name)]), (g.group.indices[k], name)


def test_a_laid_out_model_holds_its_blocks_alone():
    cfg = _cfg("internvl2")
    model = registry.get_model(cfg, device="cpu")
    alive = weakref.ref(model)
    lo = lay_out(model, _mesh((2, 2)))
    del model
    gc.collect()
    assert alive() is None  # no reference kept: the caller's drop frees it
    assert not hasattr(lo, "model")
    spec = lo.groups[0].slots[0].whole_spec()
    blocks = sum(int(np.prod([s.stop - s.start for s in sl.block_slices[path]]))
                 for g in lo.groups for sl in g.slots for path, _ in tree_paths(spec))
    held = sum(p.numel() for sl in lo.shards() for p in sl.parameters())
    assert held == blocks
    whole = sum(int(np.prod(leaf.shape)) for _, leaf in tree_paths(spec))
    assert held < len(lo.groups) * 2 * whole  # (2, 2): under two whole copies a row
    assert lo.gather().device == torch.device("cpu")


@pytest.mark.parametrize("case", ["internvl2", "hymba"])
def test_reference_params_loaded_block_by_block_give_the_jax_forward(case):
    name, over = CONFIGS[case]
    jcfg = jax_registry.get_config(name).reduced(**over)
    jmodel = jax_registry.get_model(jcfg)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    cfg = _cfg(case)
    lo = blocks_from_reference(lay_out(registry.get_model(cfg, device="meta"),
                                       _mesh((1, 4))), tree)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pre = {}
    if cfg.frontend_tokens:
        pre = {"prefix_embeds": (0.1 + 0.01 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)}
    want, want_aux = jax.jit(jmodel.forward)(tree, tokens, **pre)
    with torch.no_grad():
        got, aux = lo.forward(torch.from_numpy(tokens),
                              **{k: torch.from_numpy(v) for k, v in pre.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL, atol=ATOL)
    _assert_np_equal(params_to_reference(lo), tree)


# ------------------------------------------------------------ the Trainer --

def _batches(cfg, seed, n=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for _ in range(n)]


def _data(batches):
    return iter([{"tokens": torch.from_numpy(b)} for b in batches])


def _run(**kw):
    return RunConfig(**{**dict(steps=6, checkpoint_every=2, warmup_steps=2, learning_rate=1e-3,
                               async_checkpoint=False), **kw})


def _assert_np_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _saved(workdir, step):
    skel = checkpoint_skeleton(registry.get_model(_cfg("qwen3"), device="meta"))
    tree, _ = CheckpointManager(workdir / "ckpt").restore(step, skel, mmap=True)
    return jax.tree.map(np.array, tree)


def _state(trainer, state):
    """The trainer's parameters and moments in the reference's layout."""
    return (params_to_reference(trainer.step_fn.collect() if trainer.sharded else trainer.model),
            opt_state_to_reference(trainer.model, trainer.step_fn.gather(state)
                                   if trainer.sharded else state))


def test_meta_trainer_is_bitwise_the_whole_models(tmp_path):
    """The ``(1, 4)`` ``Trainer`` of a model on ``meta`` against a whole
    model drawn from the seed and laid out over the same mesh, stepped by
    hand and checkpointed from its gathered state."""
    cfg, batches = _cfg("qwen3"), _batches(_cfg("qwen3"), 0)
    trainer = Trainer(registry.get_model(cfg, device="meta"), _run(), _data(batches),
                      tmp_path / "run", mesh=_mesh((1, 4)))
    assert trainer.model.device.type == "meta" and not hasattr(trainer.step_fn, "model")
    _, state, _ = trainer.train(steps=2, seed=7)
    losses = [float(line.split('"loss": ')[1].split(",")[0])
              for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    whole = registry.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    step = make_train_step(whole, _run(), _mesh((1, 4)))
    st = step.init_state()
    want = []
    for b in batches[:2]:
        st, met = step(st, {"tokens": torch.from_numpy(b)})
        want.append(float(met["loss"]))
    assert losses == want
    params = params_to_reference(step.collect())
    moments = opt_state_to_reference(whole, step.gather(st))
    _assert_np_equal(_state(trainer, state), (params, moments))
    p, o = _saved(tmp_path / "run", 2)  # the files: the reference's stacked layout
    _assert_np_equal((p, o.m, o.v, o.step), (params, moments.m, moments.v, moments.step))
    again = Trainer(registry.get_model(cfg, device="meta"), _run(), _data(batches[2:]),
                    tmp_path / "run", mesh=_mesh((1, 4)))
    start, _, s2 = again.resume_or_init()
    assert start == 2
    _assert_np_equal(_state(again, s2), (params, moments))


def test_trainer_over_a_model_axis_takes_a_model_on_meta(tmp_path):
    """Over a ``model`` axis larger than one the ``Trainer`` refuses a model
    that holds parameters, which would go stale beside the blocks.  A model
    on ``meta`` is left unset until ``init_state`` draws it, over a data
    axis alone too, bitwise the no-mesh draw; ``make_train_step`` draws it
    from its ``seed``, 0 by default."""
    cfg, batches = _cfg("qwen3"), _batches(_cfg("qwen3"), 3)
    with pytest.raises(ValueError, match="give it the model on meta"):
        Trainer(registry.get_model(cfg, device="cpu"), _run(), _data(batches),
                tmp_path / "whole", mesh=_mesh((1, 2)))
    data = Trainer(registry.get_model(cfg, device="meta"), _run(), _data(batches),
                   tmp_path / "data", mesh=_mesh((2, 1)))
    plain = Trainer(registry.get_model(cfg, device="cpu"), _run(), _data(batches),
                    tmp_path / "plain")
    got, _ = data.init_state(seed=4)
    want, _ = plain.init_state(seed=4)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(a, b) for a, b in zip(data.step_fn.replicas[1].parameters(),
                                                 data.model.parameters()))
    step = make_train_step(registry.get_model(cfg, device="meta"), _run(), _mesh((2, 1)))
    drawn = registry.get_model(cfg, device="cpu")  # seed 0
    assert all(torch.equal(a, b) for a, b in zip(step.model.parameters(), drawn.parameters()))


def test_checkpoint_resumes_across_layouts_and_elastic_remesh(tmp_path):
    """(1, 4) -> one slot -> (2, 2) -> elastic_remesh onto (1, 2): each
    resume's parameters and moments are the saved ones, bitwise."""
    cfg, batches = _cfg("qwen3"), _batches(_cfg("qwen3"), 1)
    work = tmp_path / "run"
    chain = [(registry.get_model(cfg, device="meta"), _mesh((1, 4)), 2),
             (registry.get_model(cfg, device="cpu"), None, 4),
             (registry.get_model(cfg, device="meta"), _mesh((2, 2)), 6)]
    for i, (model, mesh, steps) in enumerate(chain):
        t = Trainer(model, _run(), _data(batches[steps - 2:]), work, mesh=mesh)
        if i:
            start, _, state = t.resume_or_init()
            assert start == steps - 2
            p, o = _saved(work, start)
            _assert_np_equal(_state(t, state), (p, o))
        _, state, _ = t.train(steps=steps)
        p, o = _saved(work, steps)
        _assert_np_equal(_state(t, state), (p, o))
    meta = registry.get_model(cfg, device="meta")
    mesh, step, tree, _ = elastic_remesh(CheckpointManager(work / "ckpt"),
                                         checkpoint_skeleton(meta),
                                         lambda m: checkpoint_shardings(meta, m),
                                         devices=["cpu"] * 2, model_parallel=2)
    assert step == 6 and mesh.shape == {"data": 1, "model": 2}
    t = Trainer(meta, _run(), _data(batches[6:]), tmp_path / "elastic", mesh=mesh)
    start, _, state = t.resume_or_init(restored=(step, tree))
    assert start == 6
    _assert_np_equal(_state(t, state), _saved(work, 6))


def test_jax_checkpoint_resumes_over_a_model_axis(tmp_path):
    """The JAX package's ``Trainer`` checkpoints steps 1 and 2; the port's
    ``(1, 4)`` ``Trainer`` resumes step 1 and takes step 2 on the same
    batch: its loss is the JAX trainer's at 1e-4."""
    jcfg = jax_registry.get_config("qwen3-1.7b").reduced()
    batches = _batches(_cfg("qwen3"), 2, n=2)
    jrun = JaxRunConfig(steps=2, checkpoint_every=1, warmup_steps=2, learning_rate=1e-3,
                        async_checkpoint=False)
    jt = JaxTrainer(jax_registry.get_model(jcfg), jrun,
                    iter([{"tokens": jnp.asarray(b)} for b in batches]), tmp_path / "jax")
    jt.train(steps=2)
    want = [float(line.split('"loss": ')[1].split(",")[0])
            for line in (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()]
    shutil.copytree(tmp_path / "jax" / "ckpt", tmp_path / "port" / "ckpt")
    shutil.rmtree(tmp_path / "port" / "ckpt" / "step_00000002")
    t = Trainer(registry.get_model(_cfg("qwen3"), device="meta"), _run(steps=2),
                _data(batches[1:]), tmp_path / "port", mesh=_mesh((1, 4)))
    _, _, last = t.train(steps=2)
    assert last["step"] == 1
    np.testing.assert_allclose(last["loss"], want[1], rtol=RTOL, atol=ATOL)


def test_launcher_lays_out_a_meta_model(tmp_path, capsys, monkeypatch):
    seen = []

    class Recording(Trainer):
        def __init__(self, model, *a, **kw):
            seen.append(model.device.type)
            super().__init__(model, *a, **kw)

    monkeypatch.setattr(launch, "Trainer", Recording)
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
            "--device", "cpu", "--model-parallel", "2", "--workdir", str(tmp_path)]
    assert launch.main(argv) == 0
    assert seen == ["meta"] and "mesh={'data': 1, 'model': 2}" in capsys.readouterr().out
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2
