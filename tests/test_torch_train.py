"""The LLM scaffold's training path against the JAX package, on the CPU.

Both packages run in one process on the same seeded numpy inputs and the
same weights, carried between them by ``models/convert.py``, as are the
gradients, moments and parameters that come back.  Held:

* the twins of ``tests/test_train_step.py`` (all five) on the port;
* for all ten reduced architectures, the train loss (``make_loss_fn``) and
  every gradient from ``torch.autograd`` against ``jax.value_and_grad``
  (the twins of ``tests/test_models.py``'s gradient tests: finite, and the
  router reached);
* for qwen3-1.7b, deepseek-moe-16b, seamless-m4t-large-v2 and internvl2-26b
  one whole train step (loss, ce, aux, lr, grad_norm, every gradient, m, v,
  the parameters after) on the single-batch path and both ``microbatch=2``
  paths, and the eval step;
* the three schedules at 1e-6, ``global_norm`` and ``adamw_update`` over
  three steps in float32 and bf16 moments, remat on and off, the
  launcher's synthetic stream bit for bit, the launcher and
  ``examples/train_lm_torch.py`` on the CPU, and that the entry points
  raise without a card.

Tolerances.  Losses, ``lr`` and ``grad_norm`` at rtol 1e-4.  Gradients and
m at rtol 1e-4 with an atol of ``GRAD_SHARE`` (1e-4) times the leaf's
largest entry, v at twice both (it squares the gradient): the random
init makes the attention sharp, and in float32 both packages' gradients
lie up to 3.96e-5 (the reference, hymba) and 2.87e-5 (the port,
internvl2) of a leaf's largest entry from a float64 run of the port, and
up to 4.65e-5 (hymba) from each other (``scripts/torch_train_conditioning.py``).  On the first AdamW step eps
1e-8 makes each update ~ lr * sign(g): where the reference's |g| is below
that gradient atol (the floor), the sign is rounding and the parameter may
differ by up to 2 * lr, so it is held at atol 2 * lr there, and at rtol
1e-4 elsewhere, with an atol of 1e-6 plus lr * eps / floor (the most the
gradients' gap can move eps's share of the update above the floor).  The frontends' stub inputs are 0.1 +
0.01 N(0, 1), as in ``tests/test_torch_models.py``: at the launcher's 0.1
N(0, 1) frames the seamless gradients lie 1.30e-3 (the reference) and
5.62e-4 (the port) from float64 (the same script, ``--frames normal``).

Each JAX output is computed once for each architecture (``_reference``),
on weights drawn by the port's ``init`` (seed 0) and carried across with
``params_to_reference``: a JAX ``init`` would add a compile an
architecture.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import RunConfig as JaxRunConfig  # noqa: E402
from repro.launch import train as jax_launch  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import train_step as jax_ts  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    grads_to_reference,
    opt_state_from_reference,
    opt_state_to_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models.encdec import enc_len_for  # noqa: E402
from repro_torch.parallel.sharding import Mesh  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    cross_entropy,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)
from repro_torch.train.trainer import Trainer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = registry.list_archs()
STEP_ARCHS = ["qwen3-1.7b", "deepseek-moe-16b", "seamless-m4t-large-v2", "internvl2-26b"]
B, S = 2, 16  # a batch of B rows of S + 1 tokens, as the launcher's stream
RTOL = 1e-4
GRAD_SHARE = 1e-4  # gradient atol, a share of the leaf's largest |g|
LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These models are small: one intra-op thread runs them about as fast
    alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(**kw):
    kw = {"learning_rate": LR, "warmup_steps": 1, **kw}
    return JaxRunConfig(**kw), RunConfig(**kw)


def _configs(name):
    return (jax_registry.get_config(name).reduced(capacity_factor=8.0),
            registry.get_config(name).reduced(capacity_factor=8.0))


def _batch(cfg, seed=0):
    """Seeded tokens (B, S + 1) and the frontend's stub input, if any."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)}
    if cfg.n_encoder_layers:
        shape = (B, enc_len_for(S + 1), cfg.d_model)
        out["frames"] = (0.1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    elif cfg.frontend_tokens:
        shape = (B, cfg.frontend_tokens, cfg.d_model)
        out["prefix"] = (0.1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The weights (the port's init from seed 0, as the reference's nested
    dict), the batch, and the JAX package's loss and gradients for one
    architecture; for STEP_ARCHS one jitted call of the train step from
    fresh moments and the eval step, the gradients read back from the first
    moment (m = (1 - b1) * scale * g, so g = m / ((1 - b1) * scale), within
    a few float32 roundings)."""
    jcfg, cfg = _configs(name)
    model = jax_registry.get_model(jcfg)
    tree = params_to_reference(registry.get_model(cfg, device="cpu"))
    batch = _batch(jcfg)
    jrun, _ = _runs()
    if name not in STEP_ARCHS:
        fn = jax.value_and_grad(jax_ts.make_loss_fn(model, jrun), has_aux=True)
        (loss, aux), grads = _run_jitted(fn, tree, batch)
        return tree, batch, {"loss": loss, "metrics": aux, "grads": grads}
    step = jax_ts.make_train_step(model, jrun)
    evaluate = jax_ts.make_eval_step(model, jrun)

    def fn(p, b):
        p2, o2, m = step(p, jax_opt.init_opt_state(p), b)
        return {"params": p2, "opt": o2, "step_metrics": m, "eval": evaluate(p, b)}

    out = _run_jitted(fn, tree, batch)
    m = out["step_metrics"]
    scale = min(1.0, jrun.grad_clip / max(float(m["grad_norm"]), 1e-9))
    out.update(loss=m["loss"], metrics={"ce": m["ce"], "aux": m["aux"]},
               grads=jax.tree.map(lambda x: x / np.float32((1 - 0.9) * scale), out["opt"].m))
    return tree, batch, out


@functools.lru_cache(maxsize=None)
def _reference_micro(name):
    """The JAX package's microbatch=2 train step on both paths."""
    tree, batch, _ = _reference(name)
    model = jax_registry.get_model(_configs(name)[0])

    def fn(p, b):
        out = {}
        for gw in (False, True):
            jrun, _ = _runs(microbatch=2, gather_weights_once=gw)
            p2, o2, m = jax_ts.make_train_step(model, jrun)(p, jax_opt.init_opt_state(p), b)
            out[gw] = {"params": p2, "opt": o2, "step_metrics": m}
        return out

    return _run_jitted(fn, tree, batch)


def _run_jitted(fn, *args):
    """``jax.jit(fn)(*args)`` as numpy arrays."""
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def _port_model(name, tree):
    _, cfg = _configs(name)
    return params_from_reference(registry.get_model(cfg, device="cpu"), tree)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_tree_close(got, want, share, rtol=RTOL, what=""):
    """Every leaf at ``rtol`` with an atol of ``share`` times the leaf's
    largest |want|; the two trees have the same paths."""
    want_leaves = _leaves(want)
    got_leaves = _leaves(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=share * float(np.abs(w).max()),
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _assert_params_after_step(got, want, first_moment):
    """The parameters after one AdamW step from zero moments (see the
    module docstring).  The step's update is lr * g / (|g| + eps) with g the
    clipped gradient (``first_moment`` / (1 - b1)).  Under the gradient
    floor (GRAD_SHARE of the leaf's largest |g|) the sign is rounding: atol
    2 * lr.  Above it, rtol 1e-4 with an atol of 1e-6 plus lr * eps / floor,
    the most the two gradients' gap (at most the floor) can move eps's
    share of the update there."""
    for (path, g), (_, w), (_, m) in zip(_leaves(got), _leaves(want), _leaves(first_moment)):
        gr = np.abs(np.asarray(m)) / (1 - 0.9)
        floor = GRAD_SHARE * gr.max()
        noisy = gr < floor
        what = jax.tree_util.keystr(path)
        np.testing.assert_allclose(g[~noisy], w[~noisy], rtol=RTOL,
                                   atol=1e-6 + LR * 1e-8 / floor, err_msg=what)
        np.testing.assert_allclose(g[noisy], w[noisy], rtol=0, atol=2 * LR, err_msg=what)


# --------------------------------------------------------------------------
# twins of tests/test_train_step.py
# --------------------------------------------------------------------------

def test_cross_entropy_matches_naive():
    rng = np.random.default_rng(0)
    b, s, v, vp = 2, 8, 11, 16
    logits = rng.normal(size=(b, s, vp)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), v, chunk=4)
    # naive masked softmax CE
    x = logits.copy()
    x[..., v:] = -1e30
    x = x - x.max(-1, keepdims=True)
    lse = np.log(np.exp(x).sum(-1))
    gold = np.take_along_axis(x, labels[..., None], -1)[..., 0]
    want = (lse - gold).mean()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # and the reference's chunked CE, with z-loss and weights
    w = rng.random((b, s)).astype(np.float32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), v, zloss=1e-2,
                        chunk=4, weights=torch.from_numpy(w))
    want = jax_ts.cross_entropy(logits, labels, v, zloss=1e-2, chunk=4, weights=w)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_weights_mask_positions():
    rng = np.random.default_rng(1)
    b, s, vp = 2, 6, 8
    logits = torch.from_numpy(rng.normal(size=(b, s, vp)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, vp, (b, s)).astype(np.int32))
    w = torch.ones((b, s))
    w[:, -1] = 0.0
    # perturbing the masked position's logits must not change the loss
    l1 = cross_entropy(logits, labels, vp, weights=w)
    logits2 = logits.clone()
    logits2[:, -1, :] += 7.0
    l2 = cross_entropy(logits2, labels, vp, weights=w)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)


def test_loss_fn_full_sequence_no_shift_leak():
    """The loss equals the explicitly shifted formulation: the last
    position is masked, and causal attention keeps the last token out of
    every earlier position."""
    cfg = registry.get_config("qwen3-1.7b").reduced()
    model = registry.get_model(cfg, device="cpu")
    loss_fn = make_loss_fn(model, RunConfig())
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.no_grad():
        l1, _ = loss_fn({"tokens": tokens})
        logits, _ = model.forward(tokens)
        want = cross_entropy(logits[:, :-1], tokens[:, 1:], cfg.vocab_size, zloss=cfg.zloss)
    np.testing.assert_allclose(float(l1), float(want), rtol=2e-5, atol=1e-5)


def _one_step(name, rng_seed, tokens_shape, **run_kw):
    cfg = registry.get_config(name).reduced()
    model = registry.get_model(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(rng_seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, tokens_shape).astype(np.int32))
    step = make_train_step(model, RunConfig(learning_rate=1e-2, warmup_steps=1, **run_kw))
    _, metrics = step(opt.init_opt_state(dict(model.named_parameters())), {"tokens": tokens})
    return metrics, params_to_reference(model)


def test_gather_weights_once_matches_manual_accumulation():
    """The checkpointed one-graph path equals the per-microbatch
    accumulation up to summation order (the reference's tolerances)."""
    outs = {gw: _one_step("qwen3-1.7b", 7, (4, 16), microbatch=2, gather_weights_once=gw)
            for gw in (False, True)}
    np.testing.assert_allclose(float(outs[False][0]["loss"]), float(outs[True][0]["loss"]),
                               rtol=1e-6)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-5),
                 outs[False][1], outs[True][1])


def test_grad_accumulation_matches_single_batch():
    out = {mb: _one_step("granite-3-2b", 3, (4, 16), microbatch=mb) for mb in (0, 2)}
    np.testing.assert_allclose(float(out[0][0]["loss"]), float(out[2][0]["loss"]), rtol=1e-5)
    # the reference's bound: a fifth of one update (lr 1e-2)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-2, atol=2e-3),
                 out[0][1], out[2][1])


# --------------------------------------------------------------------------
# loss and gradients, every architecture (twins of tests/test_models.py's
# gradient tests, on the train loss)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(name):
    tree, batch, ref = _reference(name)
    model = _port_model(name, tree)
    loss, metrics = make_loss_fn(model, RunConfig())(_torch_batch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), ref["metrics"]["ce"], rtol=RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), ref["metrics"]["aux"], rtol=RTOL,
                               atol=1e-7)
    grads = grads_to_reference(model)
    _assert_tree_close(grads, ref["grads"], GRAD_SHARE, what=f"{name} grad ")
    norms = [float(np.linalg.norm(g)) for g in jax.tree.leaves(grads)]
    assert all(np.isfinite(norms)) and sum(norms) > 0
    if model.cfg.n_experts:  # the router receives gradient (the aux loss reaches it)
        assert float(np.linalg.norm(grads["layers"]["moe"]["router"])) > 0


@pytest.mark.parametrize("name", ["qwen3-1.7b", "rwkv6-1.6b", "seamless-m4t-large-v2"])
def test_remat_on_and_off_give_equal_gradients(name):
    """``cfg.remat`` recomputes each layer in the backward pass: the same
    operations on the same values, so the same gradients bit for bit; a
    forward without a gradient records nothing either way."""
    tree, batch, _ = _reference(name)
    grads = {}
    for remat in (False, True):
        model = _port_model(name, tree)
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        loss, _ = make_loss_fn(model, RunConfig())(_torch_batch(batch))
        loss.backward()
        grads[remat] = grads_to_reference(model)
        with torch.no_grad():
            assert model.forward(*_forward_args(batch))[0].grad_fn is None
    jax.tree.map(np.testing.assert_array_equal, grads[True], grads[False])


def _forward_args(batch):
    tb = _torch_batch(batch)
    return (tb["tokens"], tb["frames"]) if "frames" in tb else (tb["tokens"],)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
def test_schedule_matches_reference(schedule):
    jrun, run = _runs(schedule=schedule, steps=50, warmup_steps=5, learning_rate=3e-4)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jax.vmap(jax_opt.make_schedule(jrun))(jnp.asarray(steps)))
    lr = opt.make_schedule(run)
    got = np.array([float(lr(torch.tensor(s, dtype=torch.int32))) for s in steps])
    # 1e-6 of the peak rate: near the cosine's end 1 + cos(pi t) cancels, and
    # the two libraries' float32 cos differ in the last bit
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * run.learning_rate)
    assert lr(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """Three AdamW steps on a seeded tree, the clip active on the first
    (gradients x 10) and not after, weight decay on: parameters, m, v, the
    step and the norm."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = jax_opt.init_opt_state(jp, dtype=getattr(jnp, moments))
    tstate = opt.init_opt_state(tp, dtype=getattr(torch, moments))
    assert tstate.step.dtype == torch.int32 and tstate.step.shape == ()
    for i in range(3):
        grads = {k: (rng.standard_normal(s) * (10.0 if i == 0 else 0.1)).astype(np.float32)
                 for k, s in shapes.items()}
        lr = 1e-2 * (i + 1)
        jp, jstate, jnorm = jax_opt.adamw_update(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                                                  jstate, lr)
        tp, tstate, tnorm = opt.adamw_update(
            tp, {k: torch.from_numpy(g) for k, g in grads.items()}, tstate,
            torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        np.testing.assert_allclose(
            float(opt.global_norm({k: torch.from_numpy(g) for k, g in grads.items()})),
            float(jax_opt.global_norm(grads)), rtol=1e-6)
        assert int(tstate.step) == int(jstate.step) == i + 1
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
            for ours, theirs in ((tstate.m[k], jstate.m[k]), (tstate.v[k], jstate.v[k])):
                assert ours.dtype == getattr(torch, moments)
                np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                                           rtol=1e-5 if moments == "float32" else 1e-2,
                                           atol=1e-12)


# --------------------------------------------------------------------------
# the train step and the eval step, four families
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", STEP_ARCHS)
def test_train_step_matches_reference(name):
    tree, batch, ref = _reference(name)
    model = _port_model(name, tree)
    _, run = _runs()
    state, metrics = make_train_step(model, run)(
        opt.init_opt_state(dict(model.named_parameters())), _torch_batch(batch))
    want = ref["step_metrics"]
    assert set(metrics) == set(want) == {"loss", "lr", "grad_norm", "ce", "aux"}
    for k in want:
        assert metrics[k].shape == () and metrics[k].dtype == torch.float32
        np.testing.assert_allclose(float(metrics[k]), want[k], rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    _assert_tree_close(grads_to_reference(model), ref["grads"], GRAD_SHARE, what="grad ")
    got = opt_state_to_reference(model, state)
    assert int(got.step) == int(ref["opt"].step) == 1
    _assert_tree_close(got.m, ref["opt"].m, GRAD_SHARE, what="m ")
    _assert_tree_close(got.v, ref["opt"].v, 2 * GRAD_SHARE, rtol=2 * RTOL, what="v ")
    _assert_params_after_step(params_to_reference(model), ref["params"], ref["opt"].m)


@pytest.mark.parametrize("gather", [False, True], ids=["accumulate", "gather_once"])
@pytest.mark.parametrize("name", STEP_ARCHS)
def test_microbatch_step_matches_reference(name, gather):
    tree, batch, ref = _reference(name)
    want = _reference_micro(name)[gather]
    model = _port_model(name, tree)
    _, run = _runs(microbatch=2, gather_weights_once=gather)
    state, metrics = make_train_step(model, run)(
        opt.init_opt_state(dict(model.named_parameters())), _torch_batch(batch))
    assert set(metrics) == set(want["step_metrics"]) == {"loss", "lr", "grad_norm"}
    for k, w in want["step_metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=RTOL, err_msg=k)
    got = opt_state_to_reference(model, state)
    _assert_tree_close(got.m, want["opt"].m, GRAD_SHARE, what="m ")
    _assert_tree_close(got.v, want["opt"].v, 2 * GRAD_SHARE, rtol=2 * RTOL, what="v ")
    # the averaged gradient the update used is left in .grad: m / (1 - b1)
    np.testing.assert_allclose(
        float(opt.global_norm([p.grad for p in model.parameters()])),
        float(want["step_metrics"]["grad_norm"]), rtol=RTOL)
    _assert_params_after_step(params_to_reference(model), want["params"], want["opt"].m)


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_eval_step_matches_reference(name):
    tree, batch, ref = _reference(name)
    model = _port_model(name, tree)
    out = make_eval_step(model, RunConfig())(_torch_batch(batch))
    assert set(out) == set(ref["eval"]) == {"loss", "ce", "aux"}
    for k, w in ref["eval"].items():
        assert out[k].grad_fn is None
        np.testing.assert_allclose(float(out[k]), w, rtol=RTOL, atol=1e-7, err_msg=k)
    assert all(p.grad is None for p in model.parameters())


def test_train_step_rejects_bf16_parameters():
    cfg = registry.get_config("qwen3-1.7b").reduced()
    model = registry.get_model(cfg, device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32 parameters"):
        make_train_step(model, RunConfig())


def test_opt_state_round_trip_is_exact():
    tree, batch, ref = _reference("deepseek-moe-16b")
    model = _port_model("deepseek-moe-16b", tree)
    state = opt_state_from_reference(model, ref["opt"])
    assert state.step.dtype == torch.int32 and int(state.step) == 1
    back = opt_state_to_reference(model, state)
    jax.tree.map(np.testing.assert_array_equal, back.m, ref["opt"].m)
    jax.tree.map(np.testing.assert_array_equal, back.v, ref["opt"].v)
    np.testing.assert_array_equal(back.step, ref["opt"].step)


# --------------------------------------------------------------------------
# the launcher, the example, the entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-1.7b", "seamless-m4t-large-v2", "internvl2-26b"])
def test_synthetic_data_equals_reference(name):
    jcfg, cfg = _configs(name)
    ours = launch.synthetic_data(cfg, 2, 8, seed=3, device="cpu")
    theirs = jax_launch.synthetic_data(jcfg, 2, 8, seed=3)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b)
        for k in b:
            assert a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
            assert a[k].numpy().dtype == np.asarray(b[k]).dtype


def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "4", "--batch", "2", "--seq", "8",
            "--device", "cpu", "--workdir", str(tmp_path)]
    assert launch.main(argv) == 0
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [int(line.split('"step": ')[1].split(",")[0]) for line in lines] == [0, 1, 2, 3]
    assert CheckpointManager(tmp_path / "ckpt").all_steps() == [2, 3, 4]
    assert launch.main(argv[:4] + ["6"] + argv[5:]) == 0  # resumes at 4
    out = capsys.readouterr().out
    assert "[trainer] resumed from step 4" in out and "'step': 5" in out
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 6


def test_trainer_lays_a_model_axis_out(tmp_path):
    """A mesh whose 'model' axis holds more than one slot lays qwen3 out
    over it (tensor parallelism: tests/test_torch_tp.py) and refuses rwkv6
    ``reduced()``, whose one head of 64 columns two slots would split
    (tests/test_torch_tp_families.py).  A data axis of several slots trains
    (tests/test_torch_dist.py), and so does one slot."""
    cfg = registry.get_config("qwen3-1.7b").reduced()
    model = registry.get_model(cfg, device="cpu")
    wide = Mesh(np.array(["cpu"] * 2, dtype=object).reshape(1, 2), ("data", "model"))
    laid = Trainer(model.meta(), RunConfig(), iter(()), tmp_path, mesh=wide)
    assert laid.step_fn.n_model == 2
    rwkv = registry.get_model(registry.get_config("rwkv6-1.6b").reduced(), device="meta")
    with pytest.raises(NotImplementedError, match="give each slot 32 columns, splitting a head"):
        Trainer(rwkv, RunConfig(), iter(()), tmp_path, mesh=wide)
    Trainer(model, RunConfig(), iter(()), tmp_path, mesh=Mesh(["cpu"]))  # one slot runs
    Trainer(model, RunConfig(), iter(()), tmp_path, mesh=Mesh(["cpu", "cpu"]))  # data axis


def test_training_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = registry.get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1",
                     "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(launch.synthetic_data(cfg, 1, 4))
    m = CheckpointManager(tmp_path / "ckpt")
    m.save(1, {"x": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.restore_latest({"x": torch.zeros(2)}, device="cuda")
    assert not list(tmp_path.glob("metrics.jsonl"))


def test_train_example_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "train_lm_torch.py"), "--smoke",
                        "--device", "cpu", "--workdir", str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "final: step=4" in r.stdout
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 5
