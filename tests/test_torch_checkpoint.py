"""The port's checkpointing and trainer against the JAX package, on the CPU.

* the twins of ``tests/test_checkpoint.py`` (all eight) and of
  ``tests/test_system.py``'s checkpoint tests (round trip, async and
  retention, atomicity, restore on a one-slot mesh) and its trainer test
  (end to end, then a fresh ``Trainer`` resumes) on the port's
  ``CheckpointManager`` and ``Trainer``;
* the layout across packages: each package's manager reads the other's
  checkpoint leaf for leaf; the reference's ``Trainer`` writes a checkpoint
  of reduced qwen3 that the port's ``Trainer`` resumes from (parameters, m,
  v and step exact) and trains on, and the reverse;
* ``save_async`` copies on the CPU too (an in-place step after it leaves
  the written tree as it was), bf16 leaves round trip through float32
  files, ``StepTimer``.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.runtime.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_to_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.parallel.sharding import Mesh  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault_tolerance import StepTimer  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

B, S = 4, 32  # the reference trainer test's batch


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These models are small: one intra-op thread runs them about as fast
    alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32),
        },
        "step_scalar": np.int32(seed),
    }


def _system_tree(seed=0):
    """``tests/test_system.py``'s tree: a list of layers and a step."""
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
        "layers": [{"a": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))},
                   {"a": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))}],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _assert_tree_equal(a, b):
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x), np.asarray(y)),
                 a, b)


# --------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# --------------------------------------------------------------------------

def test_save_restore_latest_roundtrip(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    t = _tree(7)
    m.save(42, t, extras={"kind": "unit"})
    step, got, extras = m.restore_latest(_tree(0))
    assert step == 42
    assert extras == {"kind": "unit"}
    _assert_tree_equal(t, got)


def test_save_async_wait_then_restore(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    t = _tree(1)
    m.save_async(5, t, extras={"async": True})
    m.wait()
    step, got, extras = m.restore_latest(_tree(0))
    assert step == 5 and extras == {"async": True}
    _assert_tree_equal(t, got)


def test_keep_gc_retains_newest_k(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in (1, 3, 8, 9):
        m.save(s, _tree(s))
    assert m.all_steps() == [8, 9]
    # keep=0 disables GC entirely
    m0 = CheckpointManager(tmp_path / "nogc", keep=0)
    for s in (1, 2, 3):
        m0.save(s, _tree(s))
    assert m0.all_steps() == [1, 2, 3]


def test_restore_latest_none_when_empty(tmp_path):
    m = CheckpointManager(tmp_path)
    assert m.restore_latest({"x": np.zeros(2)}) is None


def test_restore_latest_falls_back_over_torn_leaf(tmp_path):
    m = CheckpointManager(tmp_path, keep=0)
    t = _tree(3)
    m.save(1, t)
    m.save(2, _tree(4))
    # tear step 2 AFTER commit: truncate one leaf file mid-payload
    leaf = next((tmp_path / "step_00000002").glob("*.npy"))
    leaf.write_bytes(leaf.read_bytes()[:16])
    step, got, _ = m.restore_latest(_tree(0))
    assert step == 1
    _assert_tree_equal(t, got)


def test_restore_latest_falls_back_over_corrupt_manifest(tmp_path):
    m = CheckpointManager(tmp_path, keep=0)
    t = _tree(5)
    m.save(1, t)
    m.save(2, _tree(6))
    (tmp_path / "step_00000002" / "MANIFEST.json").write_text("{ torn")
    step, got, _ = m.restore_latest(_tree(0))
    assert step == 1
    _assert_tree_equal(t, got)


def test_restore_latest_warns_when_all_torn(tmp_path):
    m = CheckpointManager(tmp_path, keep=0)
    m.save(1, _tree(0))
    (tmp_path / "step_00000001" / "MANIFEST.json").write_text("{ torn")
    with pytest.warns(RuntimeWarning, match="no readable checkpoint"):
        assert m.restore_latest({"x": np.zeros(2)}) is None


def test_restore_named_step_stays_strict(tmp_path):
    m = CheckpointManager(tmp_path, keep=0)
    m.save(1, _tree(0))
    (tmp_path / "step_00000001" / "MANIFEST.json").write_text("{ torn")
    with pytest.raises(json.JSONDecodeError):
        m.restore(1, {"x": np.zeros(2)})


# --------------------------------------------------------------------------
# twins of tests/test_system.py's checkpoint tests
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    m = CheckpointManager(tmp_path, keep=3)
    t = _system_tree()
    m.save(3, t, extras={"note": "hi"})
    got, extras = m.restore(3, _system_tree(1))
    _assert_tree_equal(t, got)
    assert extras == {"note": "hi"}
    assert got["step"].dtype == torch.int32 and isinstance(got["layers"], list)


def test_checkpoint_async_and_retention(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        m.save_async(s, _system_tree(s))
    m.wait()
    assert m.all_steps() == [3, 4]
    assert m.latest_step() == 4


def test_checkpoint_atomicity_ignores_uncommitted(tmp_path):
    m = CheckpointManager(tmp_path, keep=0)
    m.save(5, _system_tree())
    # simulate a crashed writer: step dir without the commit marker
    bad = tmp_path / "step_00000009"
    bad.mkdir()
    (bad / "MANIFEST.json").write_text("{}")
    assert m.latest_step() == 5


def test_checkpoint_restore_on_one_slot_mesh(tmp_path):
    """The reference reshards on load onto a surviving mesh; the port
    restores onto a device, here the home of a one-slot mesh."""
    m = CheckpointManager(tmp_path)
    t = _system_tree()
    m.save(1, t)
    mesh = Mesh(["cpu"], axis_names=("data",))
    skeleton = jax.tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), t)
    step, got, _ = m.restore_latest(skeleton, device=mesh.home)
    assert step == 1
    assert all(x.device == mesh.home for x in jax.tree.leaves(got))
    _assert_tree_equal(t, got)


@pytest.fixture(scope="module")
def tiny_setup():
    """The reference trainer test's set-up on the port."""
    cfg = registry.get_config("qwen3-1.7b").reduced()
    model = registry.get_model(cfg, device="cpu")
    run = RunConfig(steps=6, checkpoint_every=2, warmup_steps=2, learning_rate=1e-3,
                    async_checkpoint=False)

    def data_iter(seed=0):
        rng = np.random.default_rng(seed)
        while True:
            yield {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}

    return cfg, model, run, data_iter


def test_trainer_end_to_end_and_resume(tmp_path, tiny_setup):
    cfg, model, run, data_iter = tiny_setup
    t1 = Trainer(model, run, data_iter(), tmp_path)
    params, opt_state, last = t1.train(steps=4)
    assert np.isfinite(last["loss"])
    assert t1.ckpt.latest_step() == 4
    saved = (params_to_reference(model), opt_state_to_reference(model, opt_state))

    # metrics were logged, with the reference's keys
    lines = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [rec["step"] for rec in lines] == [0, 1, 2, 3]
    assert set(lines[0]) == {"step", "loss", "lr", "grad_norm", "step_s", "straggler"}

    # a fresh Trainer resumes from step 4 (crash-restart path)
    t2 = Trainer(model, run, data_iter(), tmp_path)
    start, p2, o2 = t2.resume_or_init()
    assert start == 4
    _assert_tree_equal(params_to_reference(model), saved[0])
    _assert_tree_equal(opt_state_to_reference(model, o2), saved[1])

    # and continues to train to step 6
    p3, o3, last2 = t2.train(steps=6)
    assert t2.ckpt.latest_step() == 6
    assert int(o3.step) == 6
    assert np.isfinite(last2["loss"])


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------

def test_each_manager_reads_the_others_checkpoint(tmp_path):
    t = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "nest": [{"b": np.int32(3)}, {"b": np.int32(4)}]}
    CheckpointManager(tmp_path / "port").save(2, t, extras={"by": "port"})
    JaxCheckpointManager(tmp_path / "ref").save(2, t, extras={"by": "ref"})
    got, extras = JaxCheckpointManager(tmp_path / "port").restore(2, t)
    assert extras == {"by": "port"}
    _assert_tree_equal(t, got)
    got, extras = CheckpointManager(tmp_path / "ref").restore(2, t)
    assert extras == {"by": "ref"}
    _assert_tree_equal(t, got)
    for d in ("port", "ref"):
        names = sorted(p.name for p in (tmp_path / d / "step_00000002").iterdir())
        assert names == ["MANIFEST.json", "_COMMITTED", "a.npy", "nest.0.b.npy", "nest.1.b.npy"]


def _jax_data(cfg, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)), jnp.int32)}


def _run_kwargs():
    return dict(steps=6, checkpoint_every=4, warmup_steps=2, learning_rate=1e-3,
                async_checkpoint=False)


def test_port_trainer_resumes_a_reference_checkpoint(tmp_path):
    jcfg = jax_registry.get_config("qwen3-1.7b").reduced()
    jt = JaxTrainer(jax_registry.get_model(jcfg), JaxRunConfig(**_run_kwargs()),
                    _jax_data(jcfg), tmp_path)
    jparams, jopt, _ = jt.train(steps=4)
    assert jt.ckpt.latest_step() == 4

    cfg = registry.get_config("qwen3-1.7b").reduced()
    model = registry.get_model(cfg, device="cpu")
    rng = np.random.default_rng(1)
    data = iter(lambda: {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}, None)
    trainer = Trainer(model, RunConfig(**_run_kwargs()), data, tmp_path)
    start, _, state = trainer.resume_or_init()
    assert start == 4
    _assert_tree_equal(params_to_reference(model), jparams)
    got = opt_state_to_reference(model, state)
    assert got.step.dtype == np.int32 and int(got.step) == int(jopt.step) == 4
    _assert_tree_equal(got.m, jopt.m)
    _assert_tree_equal(got.v, jopt.v)
    _, state, last = trainer.train(steps=6)
    assert int(state.step) == 6 and np.isfinite(last["loss"]) and last["step"] == 5
    assert trainer.ckpt.all_steps() == [4, 6]


def test_reference_trainer_resumes_a_port_checkpoint(tmp_path):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    model = registry.get_model(cfg, device="cpu")
    rng = np.random.default_rng(2)
    data = iter(lambda: {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}, None)
    trainer = Trainer(model, RunConfig(**_run_kwargs()), data, tmp_path)
    _, state, _ = trainer.train(steps=4)
    want_params, want_opt = params_to_reference(model), opt_state_to_reference(model, state)

    jcfg = jax_registry.get_config("qwen3-1.7b").reduced()
    jt = JaxTrainer(jax_registry.get_model(jcfg), JaxRunConfig(**_run_kwargs()),
                    _jax_data(jcfg, 3), tmp_path)
    start, jparams, jopt = jt.resume_or_init()
    assert start == 4
    _assert_tree_equal(jparams, want_params)
    assert isinstance(jopt, jax_opt.OptState) and int(jopt.step) == 4
    _assert_tree_equal(jopt.m, want_opt.m)
    _assert_tree_equal(jopt.v, want_opt.v)
    _, jopt, last = jt.train(steps=6)
    assert int(jopt.step) == 6 and np.isfinite(last["loss"])


# --------------------------------------------------------------------------
# the port's own: copies, bf16, the timer
# --------------------------------------------------------------------------

def test_save_async_snapshots_before_an_in_place_step(tmp_path):
    """On the CPU a tensor's ``.numpy()`` shares its storage: the snapshot
    must be a copy, or the AdamW step after ``save_async`` changes the
    arrays being written."""
    cfg = registry.get_config("qwen3-1.7b").reduced()
    model = registry.get_model(cfg, device="cpu")
    params = dict(model.named_parameters())
    state = opt.init_opt_state(params)
    before = params_to_reference(model)
    m = CheckpointManager(tmp_path)
    m.save_async(1, ({k: p for k, p in params.items()}, state))
    for p in params.values():  # an in-place update while the write may run
        p.grad = torch.ones_like(p)
    opt.adamw_update(params, {k: p.grad for k, p in params.items()}, state,
                     torch.tensor(0.5))
    m.wait()
    skeleton = ({k: torch.empty_like(p) for k, p in params.items()},
                opt.init_opt_state(params))
    (got, got_state), _ = m.restore(1, skeleton)
    after = params_to_reference(model)
    assert not np.array_equal(after["embed"]["embedding"], before["embed"]["embedding"])
    params_from_reference(model, before)
    for k, p in model.named_parameters():
        assert torch.equal(got[k], p), k
    assert int(got_state.step) == 0 and all(not v.any() for v in got_state.m.values())


def test_bf16_leaves_round_trip_through_float32(tmp_path):
    rng = np.random.default_rng(0)
    t = {"m": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)).bfloat16(),
         "w": torch.from_numpy(rng.standard_normal((4,)).astype(np.float32))}
    m = CheckpointManager(tmp_path)
    m.save(1, t)
    manifest = json.loads((tmp_path / "step_00000001" / "MANIFEST.json").read_text())
    assert manifest["leaves"]["m"]["dtype"] == "float32"
    got, _ = m.restore(1, {k: torch.empty_like(v, device="meta") for k, v in t.items()})
    assert got["m"].dtype == torch.bfloat16 and torch.equal(got["m"], t["m"])
    assert torch.equal(got["w"], t["w"])


def test_step_timer_times_its_block():
    with StepTimer() as t:
        time.sleep(0.02)
    assert 0.015 < t.seconds < 5.0
