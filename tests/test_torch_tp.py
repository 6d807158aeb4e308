"""Tensor parallelism over the ``model`` axis, on the CPU, against the JAX package.

A port ``parallel/sharding.Mesh`` may repeat a device, so ``(data, model)``
meshes of ``'cpu'`` slots run the same layouts, model groups, reductions
and data rows as slots of the card.  The reference is the JAX package's
unsharded function on the same seed-0 weights (``params_to_reference``):
GSPMD's sharded result is that function, so no forced-host-device
subprocess is needed.  Held, for qwen3-1.7b, deepseek-moe-16b (groups of
16, capacity 8) and internvl2-26b reduced, over ``(1, 2)``, ``(1, 4)`` and
``(2, 2)``:

* the group operators (``ModelGroup.reduce``/``handout``/``first``):
  forward and backward in float64 against the plain sums
  (``torch.autograd.gradcheck``), and bitwise on a second run;
* the forward (logits and aux) at rtol/atol 1e-4, and the prefill fn;
  ``(1, 4)`` on these configs is the case of a whole ``wk``/``wv`` (2 kv
  heads) under a split ``wq`` (4 heads); deepseek at its own capacity
  factor over ``(2, 2)``, where the data rows split the batch only if
  each row's tokens fill whole dispatch groups;
* the teacher-forced ``decode_step`` against the reference's forward at
  2e-3, and 8 greedy serve tokens after a 16-token prompt exactly, each
  step's top-2 gap above 1e-4;
* the train step against the reference's unsharded step with
  ``tests/test_torch_dist.py``'s checks and tolerances (loss, ce, aux, lr
  and grad_norm at rtol 1e-4; the gradient and m at 1e-4 of the leaf's
  largest entry, v at twice that; the parameters after), every data row's
  gathered parameters equal; microbatched (``run.microbatch=2``) and
  without remat;
* the ``Trainer`` over ``(2, 2)``: a checkpoint resumed bitwise in the
  no-mesh port ``Trainer``, in the reference's ``Trainer`` and over
  ``(1, 2)``, then trained on to step 6; ``elastic_remesh`` from
  ``(2, 2)`` onto ``(1, 2)``; the launcher's ``--model-parallel``;
* ``examples/serve_lm_torch.py`` runs laid out on the CPU (the hybrid,
  ssm and encoder-decoder families: ``tests/test_torch_tp_families.py``).
"""
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.serve import serve_step as jax_serve  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import grid_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_to_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models.tensor_parallel import lay_out  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_remesh  # noqa: E402
from repro_torch.serve.serve_step import make_prefill_fn, make_serve_step  # noqa: E402
from repro_torch.train.train_step import DataParallelStep, make_train_step  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    Trainer,
    checkpoint_shardings,
    checkpoint_skeleton,
)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-1.7b", "deepseek-moe-16b", "internvl2-26b")
MESHES = ((1, 2), (1, 4), (2, 2))  # (data, model)
B, S = 4, 24  # a row of 24 tokens: deepseek's groups of 16 split where the rows do
PROMPT = 16  # serve: a 16-token prompt, then 8 greedy steps
GROUP = 16
RTOL = ATOL = 1e-4  # forward
DEC_TOL = 2e-3  # decode against forward: the reference's own
GRAD_SHARE = 1e-4  # gradient atol, a share of the leaf's largest |g|
LR = 1e-2


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


def _configs(name, **kw):
    over = {"capacity_factor": 8.0, "moe_group_size": GROUP, **kw}
    return jax_registry.get_config(name).reduced(**over), registry.get_config(name).reduced(**over)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend_tokens:
        out["prefix"] = (0.1 + 0.01 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The port's seed-0 weights as the reference's tree, and the JAX
    package's forward, text-only forward, prefill, greedy serve tokens and
    logits on them."""
    jcfg, cfg = _configs(name)
    tree = params_to_reference(registry.get_model(cfg, device="cpu"))
    model = jax_registry.get_model(jcfg)
    batch = _inputs(cfg)
    fwd = jax.jit(model.forward)
    pre = {"prefix_embeds": batch["prefix"]} if "prefix" in batch else {}
    logits, aux = fwd(tree, batch["tokens"], **pre)
    out = dict(tree=tree, batch=batch, logits=np.asarray(logits), aux=float(aux),
               text_logits=np.asarray(fwd(tree, batch["tokens"])[0]) if pre else
               np.asarray(logits))
    proxy = types.SimpleNamespace(cfg=jcfg, forward=fwd, decode_step=jax.jit(model.decode_step))
    extra = (batch["prefix"],) if pre else ()
    out["prefill"] = np.asarray(jax_serve.make_prefill_fn(proxy)(tree, batch["tokens"], *extra))
    cache = model.init_cache(B, S, dtype=jnp.float32)
    tokens = batch["tokens"]
    for t in range(PROMPT - 1):
        _, cache = proxy.decode_step(tree, cache, tokens[:, t:t + 1])
    step = jax_serve.make_serve_step(proxy)
    nxt, toks, lgs = tokens[:, PROMPT - 1:PROMPT], [], []
    for _ in range(8):
        nxt, lg, cache = step(tree, cache, nxt, jax.random.PRNGKey(0))
        toks.append(np.asarray(nxt))
        lgs.append(np.asarray(lg[:, -1]))
    out["serve_tokens"] = np.concatenate(toks, axis=1)
    out["serve_logits"] = np.stack(lgs, axis=1)
    return out


def _laid_out(name, shape, **kw):
    ref = _reference(name)
    cfg = _configs(name, **kw)[1]
    model = params_from_reference(registry.get_model(cfg, device="cpu"), ref["tree"])
    return cfg, lay_out(model, _mesh(shape)), ref


# ------------------------------------------------------------ the operators --

def _group(n=3):
    mesh = sharding.Mesh(np.array(["cpu"] * n, dtype=object).reshape(1, n), ("data", "model"))
    return sharding.ModelGroup(mesh)


def test_group_operators_gradcheck_and_are_bitwise():
    """``reduce`` and ``handout`` are each other's transposes as a model
    composes them (a replicated value's copies carry equal gradients), so
    ``torch.autograd.gradcheck`` holds the compositions: a reduced value
    used once, and a block of work (handed out, a linear map a slot,
    reduced) between two replicated values, against float64 finite
    differences.  Each operator's own backward is held exactly."""
    group = _group()
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=(3, 5))).requires_grad_() for _ in range(3)]
    ws = [torch.from_numpy(rng.normal(size=(3, 5))) for _ in range(3)]
    maps = [torch.from_numpy(rng.normal(size=(5, 5))) for _ in range(3)]

    def used_once(*parts):
        return (group.first(group.reduce(parts)) * ws[0]).sum()

    def block(*parts):
        copies = group.reduce(parts)
        out = group.reduce([h @ a for h, a in zip(group.handout(copies), maps)])
        return (group.first(out) * ws[0]).sum()

    for fn in (used_once, block):
        assert torch.autograd.gradcheck(fn, tuple(xs))
    got = torch.autograd.grad(block(*xs), xs)
    want = sum(ws[0] @ a.T for a in maps)
    assert all(torch.allclose(g, want, rtol=1e-12, atol=1e-12) for g in got)
    out = group.reduce(xs)
    assert all(torch.equal(o, xs[0] + xs[1] + xs[2]) for o in out)  # slot order
    assert all(torch.equal(a, b) for a, b in zip(out, group.reduce(xs)))  # bitwise again
    # handout: every copy's gradient is the slots' gradients added in slot order;
    # reduce: each partial gets its own copy's; first: every copy gets the output's
    cases = ((group.handout, [ws[0] + ws[1] + ws[2]] * 3), (group.reduce, ws))
    for op, want in cases:
        got = torch.autograd.grad(sum((c * w).sum() for c, w in zip(op(xs), ws)), xs)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = torch.autograd.grad((group.first(xs) * ws[0]).sum(), xs)
    assert all(torch.equal(g, ws[0]) for g in got)


def test_layout_of_the_reduced_configs():
    cfg = _configs("qwen3-1.7b")[1]
    model = registry.get_model(cfg, device="cpu")
    two, four = lay_out(model, _mesh((1, 2))), lay_out(model, _mesh((2, 2)))
    assert two.layout.heads and two.layout.kv and two.layout.ffn and two.layout.vocab
    lo = lay_out(model, _mesh((1, 4)))
    assert lo.layout.heads and not lo.layout.kv  # 2 kv heads stay whole on 4 slots
    assert [lo.layout.kv_select(k) for k in range(4)] == [slice(0, 1), slice(0, 1),
                                                          slice(1, 2), slice(1, 2)]
    uneven = registry.get_model(cfg.reduced(n_heads=12, n_kv_heads=6, head_dim=8), device="cpu")
    with pytest.raises(NotImplementedError, match="unevenly"):  # slot 0 reads kv heads 0, 0, 1
        lay_out(uneven, _mesh((1, 4)))
    assert {path for _, path, _ in lo.layout.region} == {
        ("attn", "wk"), ("attn", "wv"), ("attn", "q_norm"), ("attn", "k_norm")}
    shard = lo.groups[0].slots[3]
    assert tuple(shard.layers[0]["attn"]["wq"].shape) == (64, 1, 16)
    assert tuple(shard.layers[0]["attn"]["wk"].shape) == (64, 2, 16)
    assert tuple(shard.embed["embedding"].shape) == (cfg.vocab_padded // 4, 64)
    assert len(four.groups) == 2 and four.groups[1].group.indices == [(1, 0), (1, 1)]
    back = four.gather()
    assert back is not model and back.device == torch.device("cpu")  # built on request
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(), model.parameters()))
    # a shard draws the blocks of the whole model's seed-0 draw
    fresh = lay_out(registry.get_model(cfg, device="meta"), _mesh((1, 4)))
    own = type(shard)(cfg, device="cpu", block=shard.block).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(own.parameters(),
                                                 fresh.groups[0].slots[3].parameters()))


# ------------------------------------------------------------ forward, decode --

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_forward_equals_reference(name, shape):
    cfg, lo, ref = _laid_out(name, shape)
    batch = _torch(ref["batch"])
    pre = {"prefix_embeds": batch["prefix"]} if "prefix" in batch else {}
    with torch.no_grad():
        logits, aux = lo.forward(batch["tokens"], **pre)
    assert logits.shape == ref["logits"].shape
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), ref["aux"], rtol=RTOL, atol=ATOL)
    extra = (batch["prefix"],) if pre else ()
    got = make_prefill_fn(lo)(batch["tokens"], *extra)
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_decode_and_greedy_tokens_equal_reference(name, shape):
    cfg, lo, ref = _laid_out(name, shape)
    tokens = torch.from_numpy(ref["batch"]["tokens"])
    cache = lo.init_cache(B, S, dtype=torch.float32)
    kv = cfg.n_kv_heads // shape[1] if cfg.n_kv_heads % shape[1] == 0 else cfg.n_kv_heads
    # an MoE step routes its B tokens in groups of min(GROUP, B): a row of
    # B // 2 would route other groups, so the first row decodes the batch whole
    # (the other rows' caches are then empty)
    rows = 1 if cfg.n_experts and B // shape[0] % GROUP else shape[0]
    assert cache["k"].shape == shape and all(
        tuple(t.shape) == (cfg.n_layers, B // rows if rows > 1 or at[0] == 0 else 0, S, kv,
                           cfg.head_dim) for at, t in np.ndenumerate(cache["k"]))
    got = []
    with torch.no_grad():
        for t in range(S):
            logits, cache = lo.decode_step(cache, tokens[:, t:t + 1])
            got.append(logits[:, 0].numpy())
    ran = [p for p in cache["pos"].flat if len(p)]
    assert len(ran) == rows * shape[1] and all(int(p[0]) == S for p in ran)
    np.testing.assert_allclose(np.stack(got, axis=1), ref["text_logits"], rtol=DEC_TOL,
                               atol=DEC_TOL)
    cache = lo.init_cache(B, S, dtype=torch.float32)
    with torch.no_grad():
        for t in range(PROMPT - 1):
            _, cache = lo.decode_step(cache, tokens[:, t:t + 1])
    step = make_serve_step(lo)
    nxt, toks = tokens[:, PROMPT - 1:PROMPT], []
    for _ in range(8):
        nxt, _, cache = step(cache, nxt)
        toks.append(nxt.numpy())
    top2 = np.sort(ref["serve_logits"][..., :cfg.vocab_size], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4  # no near-tie decides a token
    np.testing.assert_array_equal(np.concatenate(toks, axis=1), ref["serve_tokens"])


@pytest.mark.parametrize("group,rows", [(16, 2), (32, 1)])
def test_moe_rows_route_the_whole_batch_groups(group, rows):
    """At deepseek-moe-16b's own capacity factor (1.25) tokens past an
    expert's capacity drop, so the dispatch groups decide the logits.  Over
    ``(2, 2)`` a data row routes 2 x 24 = 48 tokens: with groups of 16 its
    groups are the whole batch's and the rows split the batch; with groups
    of 32 they would not be, and the first row runs the batch whole."""
    name = "deepseek-moe-16b"
    over = {"capacity_factor": 1.25, "moe_group_size": group}
    jcfg, _ = _configs(name, **over)
    ref = _reference(name)
    want, want_aux = jax.jit(jax_registry.get_model(jcfg).forward)(ref["tree"],
                                                                   ref["batch"]["tokens"])
    cfg, lo, _ = _laid_out(name, (2, 2), **over)
    assert lo.rows(B, S) == rows
    with torch.no_grad():
        logits, aux = lo.forward(torch.from_numpy(ref["batch"]["tokens"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ the train step --

@functools.lru_cache(maxsize=None)
def _reference_step(name, microbatch=0):
    """One jitted reference train step from fresh moments on the port's
    seed-0 weights."""
    jcfg, _ = _configs(name)
    ref = _reference(name)
    jrun = JaxRunConfig(learning_rate=LR, warmup_steps=1, microbatch=microbatch)
    step = jax_ts.make_train_step(jax_registry.get_model(jcfg), jrun)
    out = jax.jit(lambda p, b: step(p, jax_opt.init_opt_state(p), b))(ref["tree"], ref["batch"])
    return jax.tree.map(np.asarray, out)


def _close(got, want, share, rtol=RTOL, what=""):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=share * float(np.abs(w).max()),
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _check_step(model, step, state, metrics, want, keys):
    """``tests/test_torch_dist.py``'s checks of one mesh step."""
    p_want, o_want, m_want = want
    for k in keys:
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
    rows = []
    for rep in step.replicas:  # every data row's parameters gathered on the CPU
        whole = registry.model_class(model.cfg).empty(model.cfg, "cpu")
        rep.gather_into(whole)
        rows.append(params_to_reference(whole))
    for other in rows[1:]:
        _assert_np_equal(other, rows[0])
    for (path, w), g, mm in zip(jax.tree_util.tree_flatten_with_path(p_want)[0],
                                jax.tree.leaves(rows[0]), jax.tree.leaves(o_want.m)):
        gr = np.abs(mm) / 0.1
        floor = GRAD_SHARE * gr.max()
        noisy = gr < floor
        np.testing.assert_allclose(g[~noisy], w[~noisy], rtol=RTOL,
                                   atol=1e-6 + LR * 1e-8 / floor, err_msg=str(path))
        np.testing.assert_allclose(g[noisy], w[noisy], rtol=0, atol=2 * LR, err_msg=str(path))


def _step(name, shape, **kw):
    run_kw = {k: kw.pop(k) for k in ("microbatch",) if k in kw}
    ref = _reference(name)
    cfg = _configs(name, **kw)[1]
    model = params_from_reference(registry.get_model(cfg, device="cpu"), ref["tree"])
    step = make_train_step(model, RunConfig(learning_rate=LR, warmup_steps=1, **run_kw),
                           _mesh(shape))
    assert isinstance(step, DataParallelStep) and step.n_model == shape[1]
    assert not hasattr(step, "model")  # the whole model's blocks copied, the model not kept
    state, metrics = step(step.init_state(), _torch(ref["batch"]))
    return step.abstract, step, state, metrics


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ARCHS)
def test_train_step_equals_reference(name, shape):
    model, step, state, metrics = _step(name, shape)
    assert len(step.replicas) == shape[0]
    _check_step(model, step, state, metrics, _reference_step(name),
                ("loss", "ce", "aux", "lr", "grad_norm"))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_microbatched_train_step_equals_reference(shape):
    model, step, state, metrics = _step("qwen3-1.7b", shape, microbatch=2)
    _check_step(model, step, state, metrics, _reference_step("qwen3-1.7b", 2),
                ("loss", "lr", "grad_norm"))


@pytest.mark.parametrize("name", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_train_step_without_remat_equals_reference(name):
    """``cfg.remat`` (on in these configs, as in the reference's) checkpoints
    each slot's stretch of work between the group's operators; off, the
    same function."""
    model, step, state, metrics = _step(name, (1, 4), remat=False)
    assert not model.cfg.remat
    _check_step(model, step, state, metrics, _reference_step(name),
                ("loss", "ce", "aux", "lr", "grad_norm"))


# ------------------------------------------------------------ the Trainer --

def _data(cfg, seed):
    rng = np.random.default_rng(seed)
    return iter(lambda: {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32))}, None)


def _run_kwargs():
    return dict(steps=6, checkpoint_every=4, warmup_steps=2, learning_rate=1e-3,
                async_checkpoint=False)


def _assert_np_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_trainer_over_data_and_model_resumes_everywhere(tmp_path):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    run = RunConfig(**_run_kwargs())
    plain = Trainer(registry.get_model(cfg, device="cpu"), run, _data(cfg, 0), tmp_path / "x")
    p0, _ = plain.init_state(seed=3)
    model = registry.get_model(cfg, device="meta")
    trainer = Trainer(model, run, _data(cfg, 0), tmp_path / "run", mesh=_mesh((2, 2)))
    trainer.init_state(seed=3)
    drawn = trainer.step_fn.collect()
    assert all(torch.equal(p0[k], v) for k, v in drawn.named_parameters())  # the no-mesh init
    _, state, last = trainer.train(steps=4)
    assert trainer.ckpt.latest_step() == 4 and np.isfinite(last["loss"])
    want_p = params_to_reference(trainer.step_fn.collect())  # the first row's blocks
    want_o = opt_state_to_reference(model, trainer.step_fn.gather(state))

    def check(start, m, state):
        assert start == 4
        got = opt_state_to_reference(m, state)
        _assert_np_equal(params_to_reference(m if m.device.type == "cpu" else t3.step_fn.collect()),
                         want_p)
        _assert_np_equal((got.m, got.v), (want_o.m, want_o.v))
        assert int(got.step) == 4

    m2 = registry.get_model(cfg, device="cpu")  # the no-mesh port Trainer
    start, _, s2 = Trainer(m2, run, _data(cfg, 1), tmp_path / "run").resume_or_init()
    check(start, m2, s2)
    jcfg = jax_registry.get_config("qwen3-1.7b").reduced()  # the reference's Trainer
    jt = JaxTrainer(jax_registry.get_model(jcfg), JaxRunConfig(**_run_kwargs()), iter(()),
                    tmp_path / "run")
    start, jparams, jopt = jt.resume_or_init()
    assert start == 4 and int(jopt.step) == 4
    _assert_np_equal(jax.tree.map(np.asarray, jparams), want_p)
    _assert_np_equal(jax.tree.map(np.asarray, (jopt.m, jopt.v)), (want_o.m, want_o.v))
    m3 = registry.get_model(cfg, device="meta")  # over (1, 2): placed again, trains on
    t3 = Trainer(m3, run, _data(cfg, 1), tmp_path / "run", mesh=_mesh((1, 2)))
    start, _, s3 = t3.resume_or_init()
    check(start, m3, t3.step_fn.gather(s3))
    _, s3, last = t3.train(steps=6)
    assert [int(s) for s in s3.step.flat] == [6, 6] and np.isfinite(last["loss"])
    assert t3.ckpt.all_steps() == [4, 6]


def test_elastic_remesh_onto_a_model_axis(tmp_path):
    """A ``(2, 2)`` checkpoint through ``elastic_remesh`` onto 2 survivors at
    ``model_parallel=2``: the tree a ``(1, 2)`` ``Trainer`` adopts, trained
    on bitwise as a resume from the checkpoint on that mesh."""
    cfg = registry.get_config("qwen3-1.7b").reduced()
    run = RunConfig(**_run_kwargs())
    model = registry.get_model(cfg, device="meta")
    Trainer(model, run, _data(cfg, 0), tmp_path / "run", mesh=_mesh((2, 2))).train(steps=4)
    ckpt = CheckpointManager(tmp_path / "run" / "ckpt")
    mesh, step, tree, _ = elastic_remesh(ckpt, checkpoint_skeleton(model),
                                         lambda m: checkpoint_shardings(model, m),
                                         devices=["cpu"] * 2, model_parallel=2)
    assert step == 4 and mesh.shape == {"data": 1, "model": 2}
    m2 = registry.get_model(cfg, device="meta")
    t2 = Trainer(m2, run, _data(cfg, 1), tmp_path / "elastic", mesh=mesh)
    _, s2, _ = t2.train(steps=6, restored=(step, tree))
    m3 = registry.get_model(cfg, device="meta")
    t3 = Trainer(m3, run, _data(cfg, 1), tmp_path / "run", mesh=_mesh((1, 2)))
    _, s3, _ = t3.train(steps=6)
    _assert_np_equal(params_to_reference(t2.step_fn.collect()),
                     params_to_reference(t3.step_fn.collect()))
    _assert_np_equal(*(opt_state_to_reference(m, t.step_fn.gather(s))
                       for m, t, s in ((m2, t2, s2), (m3, t3, s3))))


def test_launcher_trains_over_a_model_axis_on_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
            "--device", "cpu", "--model-parallel", "2", "--workdir", str(tmp_path)]
    assert launch.main(argv) == 0
    assert "mesh={'data': 1, 'model': 2}" in capsys.readouterr().out
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2


# ------------------------------------------------------------ entry points --

def test_serve_example_runs_laid_out_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"),
                        "--device", "cpu", "--model-parallel", "2", "--tokens", "4"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "model_parallel=2" in r.stdout and "decode : 4 tokens" in r.stdout
