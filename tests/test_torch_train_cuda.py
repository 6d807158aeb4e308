"""The LLM scaffold's training path on the card, against the port's CPU path.

For qwen3-1.7b, deepseek-moe-16b, seamless-m4t-large-v2 and internvl2-26b
at their reduced configurations, in float32 with TF32 off, parameters made
once on the CPU from a seed and copied to the card:

* one ``make_train_step`` step on the card against the CPU: loss, ce, aux,
  lr, grad_norm at rtol 1e-4; every gradient and m at rtol 1e-4 with an
  atol of 1e-4 of the leaf's largest entry, v at twice both; the
  parameters after the step as ``tests/test_torch_train.py`` holds them
  (atol 2 * lr under the gradient floor, where the sign is rounding);
* both ``microbatch=2`` paths on qwen3-1.7b the same way;
* a step queues its work without a host sync (CUDA sync debug mode
  ``'error'``);
* the ``Trainer`` on the card writes a checkpoint and a fresh one resumes
  from it, parameters and moments bitwise.

Skipped without a CUDA device: the fixtures decide, not the import.  Run on
the card with ``PYTHONPATH=src python -m pytest -q
tests/test_torch_train_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    grads_to_reference,
    opt_state_to_reference,
    params_to_reference,
)
from repro_torch.models.encdec import enc_len_for  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

pytestmark = pytest.mark.cuda

FAMILIES = ["qwen3-1.7b", "deepseek-moe-16b", "seamless-m4t-large-v2", "internvl2-26b"]
B, S = 2, 16
RTOL = 1e-4
GRAD_SHARE = 1e-4
LR = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _batch(cfg, device):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)}
    if cfg.n_encoder_layers:
        out["frames"] = (0.1 + 0.01 * rng.standard_normal(
            (B, enc_len_for(S + 1), cfg.d_model))).astype(np.float32)
    elif cfg.frontend_tokens:
        out["prefix"] = (0.1 + 0.01 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _pair(name, dev):
    cfg = registry.get_config(name).reduced(capacity_factor=8.0)
    cpu = registry.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = registry.get_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


def _step(model, cfg, run):
    state, metrics = make_train_step(model, run)(
        opt.init_opt_state(dict(model.named_parameters())), _batch(cfg, model.device))
    return ({k: float(v) for k, v in metrics.items()}, grads_to_reference(model),
            opt_state_to_reference(model, state), params_to_reference(model))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _close(got, want, share, rtol=RTOL, what=""):
    for (p, g), (q, w) in zip(_walk(got), _walk(want), strict=True):
        assert p == q
        np.testing.assert_allclose(g, w, rtol=rtol, atol=share * float(np.abs(w).max()),
                                   err_msg=f"{what}{p}")


def _params_after(got, want, first_moment):
    for (p, g), (_, w), (_, m) in zip(_walk(got), _walk(want), _walk(first_moment)):
        gr = np.abs(m) / (1 - 0.9)
        floor = GRAD_SHARE * gr.max()
        noisy = gr < floor
        np.testing.assert_allclose(g[~noisy], w[~noisy], rtol=RTOL,
                                   atol=1e-6 + LR * 1e-8 / floor, err_msg=p)
        np.testing.assert_allclose(g[noisy], w[noisy], rtol=0, atol=2 * LR, err_msg=p)


def _assert_same_step(card, cpu):
    (cm, cg, co, cp), (wm, wg, wo, wp) = card, cpu
    assert set(cm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(cm[k], wm[k], rtol=RTOL, atol=1e-7, err_msg=k)
    _close(cg, wg, GRAD_SHARE, what="grad ")
    assert int(co.step) == int(wo.step) == 1
    _close(co.m, wo.m, GRAD_SHARE, what="m ")
    _close(co.v, wo.v, 2 * GRAD_SHARE, rtol=2 * RTOL, what="v ")
    _params_after(cp, wp, wo.m)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_card_matches_cpu(dev, name):
    cfg, cpu, card = _pair(name, dev)
    run = RunConfig(learning_rate=LR, warmup_steps=1)
    _assert_same_step(_step(card, cfg, run), _step(cpu, cfg, run))


@pytest.mark.parametrize("gather", [False, True], ids=["accumulate", "gather_once"])
def test_microbatch_step_card_matches_cpu(dev, gather):
    cfg, cpu, card = _pair("qwen3-1.7b", dev)
    run = RunConfig(learning_rate=LR, warmup_steps=1, microbatch=2, gather_weights_once=gather)
    _assert_same_step(_step(card, cfg, run), _step(cpu, cfg, run))


def test_train_step_makes_no_host_sync(dev):
    cfg = registry.get_config("deepseek-moe-16b").reduced()
    model = registry.get_model(cfg, device=dev)
    step = make_train_step(model, RunConfig(learning_rate=LR, warmup_steps=1))
    state = opt.init_opt_state(dict(model.named_parameters()))
    batch = _batch(cfg, dev)
    state, _ = step(state, batch)  # warm-up: cuBLAS set-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert state.step.device.type == "cuda" and int(state.step) == 2
    assert np.isfinite(float(metrics["loss"]))


def test_trainer_checkpoints_and_resumes_on_card(dev, tmp_path):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    run = RunConfig(steps=6, checkpoint_every=4, warmup_steps=2, learning_rate=1e-3)

    def data():
        rng = np.random.default_rng(0)
        while True:
            yield {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)).to(dev)}

    model = registry.get_model(cfg, device=dev)
    t1 = Trainer(model, run, data(), tmp_path)
    _, state, last = t1.train(steps=4)
    assert t1.ckpt.latest_step() == 4 and np.isfinite(last["loss"])
    saved = (params_to_reference(model), opt_state_to_reference(model, state))
    fresh = registry.get_model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(9))
    t2 = Trainer(fresh, run, data(), tmp_path)
    start, _, state2 = t2.resume_or_init()
    assert start == 4 and state2.step.device.type == "cuda"
    for (p, a), (_, b) in zip(_walk(params_to_reference(fresh)), _walk(saved[0])):
        np.testing.assert_array_equal(a, b, err_msg=p)
    got = opt_state_to_reference(fresh, state2)
    for (p, a), (_, b) in zip(_walk({"m": got.m, "v": got.v}),
                              _walk({"m": saved[1].m, "v": saved[1].v})):
        np.testing.assert_array_equal(a, b, err_msg=p)
    _, state3, _ = t2.train(steps=6)
    assert int(state3.step) == 6 and t2.ckpt.latest_step() == 6
