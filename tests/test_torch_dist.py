"""Training over a mesh of slots, on the CPU, against the JAX package.

A port ``parallel/sharding.Mesh`` may repeat a device, so meshes of 2 and
4 slots of ``'cpu'`` run the same threads, barriers, splits and gathers as
slots of the card.  Held:

* ``shard_map_compat`` and its collectives (``psum``, ``pmax``,
  ``ppermute``, ``axis_index``) over one and two axes; an exception in one
  slot is re-raised in the caller and leaves no thread behind;
  ``NamedSharding``'s blocks, ``place`` and ``gather``;
* compression: ``compress_leaf`` and the single-worker
  ``compressed_psum_tree`` bitwise the reference's (which, eager, rounds
  as the port; under ``jax.jit`` XLA fuses the new error's product and
  difference and its last bit may differ, so the reference runs eagerly
  here), the twins of ``tests/test_system.py``'s two compression tests,
  and the twin of ``tests/test_compression_multidevice.py`` over 4 CPU
  slots with that test's assertions held here (the reference's own is a
  standing red: its script indexes an explicitly sharded array outside a
  mesh context under this JAX);
* GPipe: ``pipeline_stages`` equal to the reference's, ``pipeline_forward``
  over 4 slots against the sequential oracle at the reference test's
  ``rtol=2e-5, atol=2e-6``, and bitwise the stack applied microbatch by
  microbatch;
* the twins of ``tests/test_system.py``'s reshard-on-load and
  ``elastic_remesh`` tests;
* a train step over meshes of 2 and 4 slots against the reference's
  ``make_train_step`` on one device (loss at 1e-4, gradients and moments at
  1e-4 of the leaf's largest entry, as ``tests/test_torch_train.py``) for
  qwen3 and for deepseek-moe at a group-aligned shard; a misaligned shard
  raises;
* the ``Trainer`` over a mesh: its init is the no-mesh init bitwise, and
  its checkpoint resumes in the no-mesh port ``Trainer``, on a mesh of
  another size and in the reference's ``Trainer``; the tree that
  ``elastic_remesh`` returns trains on in a ``Trainer`` on the surviving
  mesh, bitwise as a resume from the checkpoint; a ``model`` axis of more
  than one is laid out for the decoder families and raises for the others
  (tensor parallelism itself: ``tests/test_torch_tp.py``).
"""
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.parallel import compression as jax_comp  # noqa: E402
from repro.parallel import pipeline as jax_pipeline  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch.mesh import grid_mesh, make_host_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_to_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.parallel import compression as comp  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_forward, pipeline_stages  # noqa: E402
from repro_torch.parallel.sharding import Mesh, NamedSharding, shard_map_compat  # noqa: E402
from repro_torch.parallel.sharding import PartitionSpec as P  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_remesh, surviving_mesh  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import DataParallelStep, make_train_step  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    Trainer,
    checkpoint_shardings,
    checkpoint_skeleton,
)

RTOL = 1e-4
GRAD_SHARE = 1e-4  # gradient atol, a share of the leaf's largest |g|
LR = 1e-2
B, S = 4, 16  # rows x tokens of the compared step: 1 or 2 rows a slot


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread runs them about as fast
    alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n, axis="data"):
    return Mesh(["cpu"] * n, (axis,))


def _threads_after(fn):
    before = threading.active_count()
    out = fn()
    return out, threading.active_count() - before


# ------------------------------------------------------------ shard_map --

def test_collectives_over_one_axis():
    mesh = _cpu_mesh(4)
    x = torch.arange(12.0).reshape(4, 3)

    def f(a):
        k = sharding.axis_index("data")
        return (sharding.psum(a, "data"), sharding.pmax(a, "data"),
                sharding.ppermute(a, "data", [(i, i + 1) for i in range(3)]),
                torch.full((1,), float(k)), sharding.psum({"n": torch.ones(())}, "data"))

    (s, m, r, k, tree), grew = _threads_after(
        lambda: shard_map_compat(f, mesh, (P("data"),),
                                 (P(), P(), P("data"), P("data"), P()))(x))
    assert torch.equal(s, x.sum(0, keepdim=True)) and torch.equal(m, x[3:])
    assert torch.equal(r, torch.cat([torch.zeros(1, 3), x[:3]]))
    assert torch.equal(k, torch.arange(4.0)) and float(tree["n"]) == 4.0
    assert grew == 0


def test_collectives_over_two_axes_and_specs():
    devs = np.array(["cpu"] * 4, dtype=object).reshape(2, 2)
    mesh = Mesh(devs, ("data", "model"))
    x = torch.arange(16.0).reshape(4, 4)

    def f(a):
        return sharding.psum(a, "model"), sharding.psum(a, "data")

    by_model, by_data = shard_map_compat(f, mesh, P("data", "model"),
                                         (P("data", None), P(None, "model")))(x)
    assert torch.equal(by_model, x.reshape(4, 2, 2).sum(1))
    assert torch.equal(by_data, x.reshape(2, 2, 4).sum(0))
    ns = NamedSharding(mesh, P(("data", "model")))
    assert ns.shard_shape((8, 3)) == (2, 3) and ns.block((1, 0), (8, 3))[0] == slice(4, 6)
    shards = ns.place(torch.arange(24.0).reshape(8, 3))
    assert shards.shape == (2, 2) and torch.equal(shards[0, 1], torch.arange(6.0, 12).reshape(2, 3))
    assert torch.equal(ns.gather(shards, "cpu"), torch.arange(24.0).reshape(8, 3))
    rep = NamedSharding(mesh, P()).place(torch.ones(3))
    assert all(torch.equal(t, torch.ones(3)) for t in rep.flat)
    assert rep[0, 0].data_ptr() != rep[1, 1].data_ptr()  # copies, not aliases
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(mesh, P("data")).shard_shape((3,))


def test_a_slot_exception_is_reraised_and_no_thread_is_left():
    mesh = _cpu_mesh(4)

    def f(a):
        if sharding.axis_index("data") == 2:
            raise ValueError("slot two fails")
        return sharding.psum(a, "data")

    before = threading.active_count()
    with pytest.raises(ValueError, match="slot two fails") as info:
        shard_map_compat(f, mesh, P("data"), P())(torch.ones(4, 2))
    assert any("slot (2,)" in note for note in info.value.__notes__)
    assert threading.active_count() == before
    with pytest.raises(RuntimeError, match="only inside a shard_map_compat slot"):
        sharding.psum(torch.ones(1), "data")
    with pytest.raises(ValueError, match="no axis"):
        shard_map_compat(lambda a: sharding.psum(a, "pod"), mesh, P("data"), P())(torch.ones(4))


def test_constrain_inside_a_slot_sees_the_local_view():
    """Inside a slot of a data mesh and inside a model group's slot,
    ``constrain`` sees the local view; a model that is not laid out, run
    per slot of a mesh whose ``model`` axis is larger than one, is told how
    to lay it out."""
    x = torch.ones(2, 3)

    def f(a):
        return sharding.constrain(a, "batch", "embed") * 2

    got = shard_map_compat(f, _cpu_mesh(2), P("data"), P("data"))(torch.ones(4, 3))
    assert torch.equal(got, torch.full((4, 3), 2.0))
    wide = Mesh(np.array(["cpu"] * 2, dtype=object).reshape(1, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match=r"lay_out\(model, mesh\)"):
        shard_map_compat(f, wide, P(), P())(x)
    group = sharding.ModelGroup(wide, sizes={"vocab": 512})
    logits = [torch.ones(2, 3, 256)] * 2  # each slot's block of a 512-wide vocab
    assert group.each(lambda t: sharding.constrain(t, "batch", "seq", "vocab"), logits) == logits
    with pytest.raises(ValueError, match="not a slot's block of 512"):
        group.each(lambda t: sharding.constrain(t, "batch", "seq", "vocab"),
                   [torch.ones(2, 3, 512)] * 2)


# ------------------------------------------------------------ compression --

def test_compress_leaf_is_bitwise_the_reference():
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 40.0):
        g = (rng.normal(size=(65, 33)) * scale).astype(np.float32)
        e = (rng.normal(size=g.shape) * 0.01 * scale).astype(np.float32)
        ours = comp.compress_leaf(torch.from_numpy(g), torch.from_numpy(e))
        theirs = jax_comp.compress_leaf(jnp.asarray(g), jnp.asarray(e))
        for a, b in zip(ours, theirs):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    z = comp.compress_leaf(torch.zeros(4), torch.zeros(4))
    assert float(z[1]) == 1.0 and not z[0].any()


def test_compressed_psum_tree_single_worker_identity():
    """Twin of ``tests/test_system.py::test_compressed_psum_tree_single_worker_identity``,
    and bitwise the reference's outputs."""
    grads = {"a": torch.linspace(-1, 1, 16), "b": torch.ones((4, 4))}
    err = comp.init_error_state(grads)
    out, new_err = comp.compressed_psum_tree(grads, err)
    for k in grads:
        np.testing.assert_allclose(out[k].numpy(), grads[k].numpy(), atol=2.0 / 127.0)
        np.testing.assert_allclose(new_err[k].numpy(), (grads[k] - out[k]).numpy(), atol=1e-6)
    jg = {k: jnp.asarray(v.numpy()) for k, v in grads.items()}
    jout, jerr = jax_comp.compressed_psum_tree(jg, jax_comp.init_error_state(jg))
    for k in grads:
        assert np.array_equal(out[k].numpy(), np.asarray(jout[k]))
        assert np.array_equal(new_err[k].numpy(), np.asarray(jerr[k]))


def test_compression_error_feedback_telescopes():
    """Twin of ``tests/test_system.py::test_compression_error_feedback_telescopes``."""
    rng = np.random.default_rng(0)
    g_true = [torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)) for _ in range(30)]
    err = torch.zeros(64)
    applied = torch.zeros(64)
    for g in g_true:
        q, scale, err = comp.compress_leaf(g, err)
        applied = applied + q.float() * scale
    total = sum(g_true)
    resid = (applied - total).abs().numpy()
    step = float(total.abs().max()) / 127.0
    assert resid.max() <= 3.0 * step + 1e-5


def compressed_allreduce_four_workers(mesh):
    """The twin of ``tests/test_compression_multidevice.py``'s script over
    ``mesh`` (4 data slots), its assertions held here; returns every step's
    output and error, as numpy."""
    rng = np.random.default_rng(0)
    G = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))  # per-worker grads

    def sync(g, e):
        out, ne = comp.compressed_psum_tree({"g": g}, {"g": e}, axis_name="data")
        return out["g"], ne["g"]

    shmap = shard_map_compat(sync, mesh, (P("data"), P("data")), (P("data"), P("data")))
    home = mesh.home
    err = torch.zeros((4, 64), device=home)
    acc = np.zeros((64,), np.float32)
    true_acc = np.zeros((64,), np.float32)
    trace = []
    for step in range(30):
        g = G.to(home) * (1.0 + 0.1 * step)
        out, err = shmap(g, err)
        o, gn = out.cpu().numpy(), g.cpu().numpy()
        trace.append((o, err.cpu().numpy()))
        np.testing.assert_allclose(o[0], o[1], atol=1e-6)  # every shard got the same mean
        acc = acc + o[0]
        true_acc = true_acc + gn.mean(0)
        step_size = float(np.abs(gn).max()) / 127.0
        np.testing.assert_allclose(o[0], gn.mean(0), atol=2.0 * step_size)
    drift = np.abs(acc - true_acc).max()
    bound = 4.0 * float(np.abs(G.numpy()).max() * 4.0) / 127.0
    assert drift < bound, (drift, bound)
    return trace


def test_compressed_allreduce_four_workers():
    trace = compressed_allreduce_four_workers(_cpu_mesh(4))
    assert len(trace) == 30
    for o, _ in trace:  # every slot holds the same bits
        assert all(np.array_equal(o[0], o[k]) for k in range(1, 4))


# ------------------------------------------------------------ pipeline --

def test_pipeline_stages_equal_reference():
    for n, s in ((8, 4), (28, 4), (6, 2), (4, 1)):
        assert pipeline_stages(n, s) == jax_pipeline.pipeline_stages(n, s)
    with pytest.raises(ValueError):
        pipeline_stages(7, 2)


def test_gpipe_matches_sequential():
    """Twin of ``tests/test_pipeline_parallel.py``, over 4 CPU slots."""
    mesh = _cpu_mesh(4, "pod")
    L, Bt, St, D = 8, 8, 16, 32
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy((rng.normal(size=(L, D, D)) * 0.2).astype(np.float32)),
              "b": torch.from_numpy((rng.normal(size=(L, D)) * 0.1).astype(np.float32))}
    x = torch.from_numpy(rng.normal(size=(Bt, St, D)).astype(np.float32))

    def layer_fn(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    def stack(h):
        for i in range(L):
            h = layer_fn({k: v[i] for k, v in params.items()}, h)
        return h

    want = stack(x)  # sequential oracle
    got, grew = _threads_after(lambda: pipeline_forward(layer_fn, params, x, mesh, n_micro=4,
                                                        axis="pod"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-6)
    micro = torch.cat([stack(m) for m in x.reshape(4, 2, St, D)])
    assert torch.equal(got, micro) and grew == 0
    with pytest.raises(ValueError):
        pipeline_forward(layer_fn, params, x, mesh, n_micro=3, axis="pod")


# ------------------------------------------------------------ elastic --

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
        "layers": [{"a": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))},
                   {"a": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))}],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _assert_tree_equal(a, b):
    for x, y in zip(sharding.tree_leaves(a), sharding.tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _gathered(mesh, placed, shardings):
    return sharding.tree_map(lambda s, sh: sh.gather(s, mesh.home), placed, shardings)


def test_checkpoint_reshard_on_load(tmp_path):
    """Twin of ``tests/test_system.py::test_checkpoint_reshard_on_load``."""
    m = CheckpointManager(tmp_path)
    t = _tree()
    m.save(1, t)
    mesh = surviving_mesh(model_parallel=1, devices=["cpu"] * 3)
    step, got, _ = m.restore_latest(t, device=mesh.home)
    assert step == 1
    sh = sharding.tree_map(lambda _: NamedSharding(mesh, P()), t)
    placed = sharding.tree_map(lambda x, s: s.place(x), got, sh)
    _assert_tree_equal(t, _gathered(mesh, placed, sh))


def test_elastic_remesh_resumes(tmp_path):
    """Twin of ``tests/test_system.py::test_elastic_remesh_resumes``, on
    CPU slots: 4 survivors make a (4, 1) mesh, 5 at ``model_parallel=2`` a
    (2, 2) one (the fifth dropped); each leaf comes back placed."""
    m = CheckpointManager(tmp_path)
    t = _tree()
    assert elastic_remesh(m, t, lambda mesh: None, devices=["cpu"]) is None
    m.save(11, t)

    def make_shardings(mesh):
        return {"w": NamedSharding(mesh, P("data")), "step": NamedSharding(mesh, P()),
                "layers": [{"a": NamedSharding(mesh, P())}] * 2}

    for devices, mp, shape in ((4, 1, {"data": 4, "model": 1}), (5, 2, {"data": 2, "model": 2})):
        out = elastic_remesh(m, t, make_shardings, devices=["cpu"] * devices, model_parallel=mp)
        assert out is not None
        mesh, step, got, _ = out
        assert step == 11 and mesh.shape == shape
        assert got["w"].shape == tuple(shape.values())
        assert got["w"].flat[-1].shape == (4 // shape["data"], 8)
        _assert_tree_equal(t, _gathered(mesh, got, make_shardings(mesh)))


# ------------------------------------------------------------ the train step --

def _configs(name, **kw):
    return (jax_registry.get_config(name).reduced(capacity_factor=8.0, **kw),
            registry.get_config(name).reduced(capacity_factor=8.0, **kw))


def _batch(cfg, rows=B, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _reference(name, group):
    """The port's seed-0 weights as the reference's tree, and one jitted
    reference train step from fresh moments on them."""
    jcfg, cfg = _configs(name, moe_group_size=group)
    tree = params_to_reference(registry.get_model(cfg, device="cpu"))
    batch = _batch(cfg)
    jrun = JaxRunConfig(learning_rate=LR, warmup_steps=1)
    step = jax_ts.make_train_step(jax_registry.get_model(jcfg), jrun)
    out = jax.jit(lambda p, b: step(p, jax_opt.init_opt_state(p), b))(tree, batch)
    return tree, batch, jax.tree.map(np.asarray, out)


def _close(got, want, share, rtol=RTOL, what=""):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=share * float(np.abs(w).max()),
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name,group", [("qwen3-1.7b", 512), ("deepseek-moe-16b", 16),
                                        ("hymba-1.5b", 512), ("rwkv6-1.6b", 512)])
@pytest.mark.parametrize("slots", [2, 3, 4])
def test_mesh_train_step_equals_reference(name, group, slots):
    """On ``make_host_mesh``'s ``(data, model)`` meshes: hymba's and
    rwkv6's specs name leaves over the ``model`` axis (of size one), and
    3 slots divide neither ``d_model`` nor the batch, so most leaves stay
    whole on every slot and the batch runs whole on the first; each such
    leaf counts once in the global norm."""
    tree, batch, (p_want, o_want, m_want) = _reference(name, group)
    _, cfg = _configs(name, moe_group_size=group)
    model = params_from_reference(registry.get_model(cfg, device="cpu"), tree)
    step = make_train_step(model, RunConfig(learning_rate=LR, warmup_steps=1),
                           make_host_mesh(device="cpu", slots=slots))
    assert isinstance(step, DataParallelStep) and len(step.replicas) == slots
    state, metrics = step(step.init_state(), {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "aux", "lr", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(m_want[k]), rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    got = opt_state_to_reference(model, step.gather(state))
    assert int(got.step) == 1 and all(int(s) == 1 for s in state.step.flat)
    scale = min(1.0, 1.0 / max(float(m_want["grad_norm"]), 1e-9))
    grads = jax.tree.map(lambda m: m / np.float32(0.1 * scale), o_want.m)
    _close(jax.tree.map(lambda m: m / np.float32(0.1 * scale), got.m), grads, GRAD_SHARE,
           what="grad ")
    _close(got.m, o_want.m, GRAD_SHARE, what="m ")
    _close(got.v, o_want.v, 2 * GRAD_SHARE, rtol=2 * RTOL, what="v ")
    after = params_to_reference(model)
    for (path, w), g, mm in zip(jax.tree_util.tree_flatten_with_path(p_want)[0],
                                jax.tree.leaves(after), jax.tree.leaves(o_want.m)):
        gr = np.abs(mm) / 0.1
        floor = GRAD_SHARE * gr.max()
        noisy = gr < floor
        np.testing.assert_allclose(g[~noisy], w[~noisy], rtol=RTOL,
                                   atol=1e-6 + LR * 1e-8 / floor, err_msg=str(path))
        np.testing.assert_allclose(g[noisy], w[noisy], rtol=0, atol=2 * LR, err_msg=str(path))
    for rep in step.replicas[1:]:  # every replica holds the same parameters
        assert all(torch.equal(a, b) for a, b in zip(rep.parameters(), model.parameters()))


def test_misaligned_moe_shard_raises():
    _, cfg = _configs("deepseek-moe-16b", moe_group_size=32)
    model = registry.get_model(cfg, device="cpu")
    run = RunConfig(learning_rate=LR, warmup_steps=1)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    step = make_train_step(model, run, make_host_mesh(device="cpu", slots=4))
    with pytest.raises(ValueError, match=r"routes 16 tokens .* moe_group_size 32"):
        step(step.init_state(), batch)
    step = make_train_step(model, run, make_host_mesh(device="cpu", slots=2))
    _, metrics = step(step.init_state(), batch)  # 2 rows of 16 a slot: one group
    assert np.isfinite(float(metrics["loss"]))


def test_undivided_batch_runs_whole_on_the_first_slot():
    _, cfg = _configs("qwen3-1.7b")
    run = RunConfig(learning_rate=LR, warmup_steps=1)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, rows=3).items()}
    one = registry.get_model(cfg, device="cpu")
    state1, m1 = make_train_step(one, run)(opt.init_opt_state(dict(one.named_parameters())),
                                           batch)
    model = registry.get_model(cfg, device="cpu")
    step = make_train_step(model, run, make_host_mesh(device="cpu", slots=2))
    state, metrics = step(step.init_state(), batch)
    assert float(metrics["loss"]) == float(m1["loss"])  # the same forward, whole
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(m1["grad_norm"]), rtol=1e-6)
    got = step.gather(state)  # the gradient bitwise; the clip's norm summed in another order
    for k, m in state1.m.items():
        np.testing.assert_allclose(got.m[k].numpy(), m.numpy(), rtol=1e-6, atol=0, err_msg=k)


# ------------------------------------------------------------ the Trainer --

def _data(cfg, seed):
    rng = np.random.default_rng(seed)
    return iter(lambda: {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}, None)


def _run_kwargs():
    return dict(steps=6, checkpoint_every=4, warmup_steps=2, learning_rate=1e-3,
                async_checkpoint=False)


def test_trainer_over_a_mesh_checkpoints_and_resumes_everywhere(tmp_path):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    run = RunConfig(**_run_kwargs())
    plain = Trainer(registry.get_model(cfg, device="cpu"), run, _data(cfg, 0), tmp_path / "x")
    p0, o0 = plain.init_state(seed=3)
    model = registry.get_model(cfg, device="cpu")
    mesh = make_host_mesh(device="cpu", slots=4)
    trainer = Trainer(model, run, _data(cfg, 0), tmp_path / "run", mesh=mesh)
    p1, o1 = trainer.init_state(seed=3)  # bitwise the no-mesh init
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(not t.any() for a in o1.m.values() for t in a.flat)
    _, state, last = trainer.train(steps=4)
    assert trainer.ckpt.latest_step() == 4 and np.isfinite(last["loss"])
    want_p = params_to_reference(model)
    want_o = opt_state_to_reference(model, trainer.step_fn.gather(state))

    def check(start, m, state):
        assert start == 4
        got = opt_state_to_reference(m, state)
        _assert_np_equal(params_to_reference(m), want_p)
        _assert_np_equal((got.m, got.v), (want_o.m, want_o.v))
        assert int(got.step) == 4

    # the no-mesh port Trainer
    m2 = registry.get_model(cfg, device="cpu")
    t2 = Trainer(m2, run, _data(cfg, 1), tmp_path / "run")
    start, _, s2 = t2.resume_or_init()
    check(start, m2, s2)
    # the reference's Trainer
    jcfg = jax_registry.get_config("qwen3-1.7b").reduced()
    jt = JaxTrainer(jax_registry.get_model(jcfg), JaxRunConfig(**_run_kwargs()),
                    iter(()), tmp_path / "run")
    start, jparams, jopt = jt.resume_or_init()
    assert start == 4 and int(jopt.step) == 4
    _assert_np_equal(jax.tree.map(np.asarray, jparams), want_p)
    _assert_np_equal(jax.tree.map(np.asarray, (jopt.m, jopt.v)), (want_o.m, want_o.v))
    # a mesh of another size: the moments placed again, and it trains on
    m3 = registry.get_model(cfg, device="cpu")
    t3 = Trainer(m3, run, _data(cfg, 1), tmp_path / "run",
                 mesh=make_host_mesh(device="cpu", slots=2))
    start, _, s3 = t3.resume_or_init()
    check(start, m3, t3.step_fn.gather(s3))
    for rep in t3.step_fn.replicas[1:]:
        assert all(torch.equal(a, b) for a, b in zip(rep.parameters(), m3.parameters()))
    _, s3, last = t3.train(steps=6)
    assert [int(s) for s in s3.step.flat] == [6, 6] and np.isfinite(last["loss"])
    assert t3.ckpt.all_steps() == [4, 6]


def test_trainer_trains_on_from_the_elastic_remesh_tree(tmp_path):
    """``elastic_remesh`` with ``checkpoint_shardings`` hands back a tree
    that a ``Trainer`` on the surviving mesh adopts as it is (the moments
    not gathered) and trains on from; it ends bitwise where a resume from
    the checkpoint on a mesh of that size ends."""
    cfg = registry.get_config("qwen3-1.7b").reduced()
    run = RunConfig(**_run_kwargs())
    model = registry.get_model(cfg, device="cpu")
    Trainer(model, run, _data(cfg, 0), tmp_path / "run",
            mesh=make_host_mesh(device="cpu", slots=4)).train(steps=4)
    want_p, ckpt = params_to_reference(model), CheckpointManager(tmp_path / "run" / "ckpt")
    _, (_, want_o), _ = ckpt.restore_latest(checkpoint_skeleton(model), device="cpu")

    def remesh(slots):
        return elastic_remesh(ckpt, checkpoint_skeleton(model),
                              lambda mesh: checkpoint_shardings(model, mesh),
                              devices=["cpu"] * slots)

    mesh, step, tree, _ = remesh(2)
    assert step == 4 and mesh.shape == {"data": 2, "model": 1}
    m2 = registry.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    t2 = Trainer(m2, run, _data(cfg, 1), tmp_path / "elastic", mesh=mesh)
    start, _, state = t2.resume_or_init(restored=(step, tree))
    assert start == 4 and t2.ckpt.latest_step() is None
    assert all(t.device == d for a in state.m.values() for t, d in zip(a.flat, mesh.devices.flat))
    got = opt_state_to_reference(m2, t2.step_fn.gather(state))
    _assert_np_equal(params_to_reference(m2), want_p)
    _assert_np_equal((got.step, got.m, got.v), (want_o.step.numpy(), *jax.tree.map(
        lambda t: t.numpy(), (want_o.m, want_o.v))))
    _, s2, _ = t2.train(steps=6, restored=(step, tree))
    m3 = registry.get_model(cfg, device="cpu")
    t3 = Trainer(m3, run, _data(cfg, 1), tmp_path / "run",
                 mesh=make_host_mesh(device="cpu", slots=2))
    _, s3, _ = t3.train(steps=6)
    _assert_np_equal(params_to_reference(m2), params_to_reference(m3))
    a, b = (opt_state_to_reference(m, t.step_fn.gather(s))
            for m, t, s in ((m2, t2, s2), (m3, t3, s3)))
    _assert_np_equal(a, b)
    with pytest.raises(ValueError, match="placed over"):  # a tree of another mesh
        t2.resume_or_init(restored=remesh(4)[1:3])
    with pytest.raises(ValueError, match="several slots"):
        Trainer(m3, run, iter(()), tmp_path / "plain").resume_or_init(restored=(step, tree))


def _assert_np_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_trainer_takes_a_model_axis_for_decoders_only(tmp_path):
    """A ``model`` axis larger than one is laid out for every family
    (tests/test_torch_tp.py, tests/test_torch_tp_families.py): qwen3, hymba
    and seamless train over it; rwkv6 ``reduced()``, whose one head of 64
    columns the axis would split, raises naming the shapes.  A ``pod`` axis
    folds into the data rows; any other axis larger than one raises."""
    wide = grid_mesh(["cpu"] * 4, model_parallel=2)
    cfg = registry.get_config("qwen3-1.7b").reduced()
    model = registry.get_model(cfg, device="cpu")
    for name in ("qwen3-1.7b", "hymba-1.5b", "seamless-m4t-large-v2"):
        one = registry.get_model(registry.get_config(name).reduced(), device="meta")
        t = Trainer(one, RunConfig(), iter(()), tmp_path, mesh=wide)
        assert t.sharded and t.step_fn.n_model == 2 and len(t.step_fn.replicas) == 2
    rwkv = registry.get_model(registry.get_config("rwkv6-1.6b").reduced(), device="meta")
    with pytest.raises(NotImplementedError, match="give each slot 32 columns, splitting a head"):
        Trainer(rwkv, RunConfig(), iter(()), tmp_path, mesh=wide)
    pod = Mesh(np.array(["cpu"] * 2, dtype=object).reshape(2, 1), ("pod", "data"))
    t = Trainer(model, RunConfig(), iter(()), tmp_path, mesh=pod)
    assert t.mesh.shape == {"data": 2, "model": 1} and len(t.step_fn.replicas) == 2
    stage = Mesh(np.array(["cpu"] * 2, dtype=object).reshape(2, 1), ("stage", "data"))
    with pytest.raises(NotImplementedError, match="'pod', 'data' and 'model' axes"):
        Trainer(model, RunConfig(), iter(()), tmp_path, mesh=stage)
    Trainer(model, RunConfig(), iter(()), tmp_path, mesh=grid_mesh(["cpu"] * 2))

