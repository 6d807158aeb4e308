"""Tensor parallelism over the ``model`` axis on the card, against one slot.

On 4 slots of the first card (a ``(1, 4)`` or ``(2, 2)`` mesh of
``parallel/sharding.Mesh``), float32 with TF32 off:

* one ``DataParallelStep`` step of qwen3-1.7b reduced over ``(1, 4)`` --
  four model slots, every slot's backward on autograd's one worker thread
  for the card -- ends within a time limit (run in a thread, joined with a
  timeout: a hang fails), and equals one ``make_train_step`` step on one
  slot: loss and grad_norm at rtol 1e-4, the gradient (the rows' gathered
  gradients added in row order over their count) and the moments at 1e-4
  of each leaf's largest entry, the parameters after within 2 lr; also
  over ``(2, 2)``;
* the prefill fn and 8 greedy serve steps over ``(1, 4)`` give one slot's
  tokens;
* the step queues its work without a host sync (CUDA sync debug mode
  ``'error'``);
* with two cards or more, a step over ``make_host_mesh(2)`` (a model
  group across two cards) against one slot;
* one layout each of the hybrid, ssm and encoder-decoder families
  (``tests/test_torch_tp_families.py``'s configs) against the same layout
  on CPU slots: the forward at rtol/atol 1e-4, one train step's loss at
  1e-4 and grad_norm, m and v at 1e-4 (rwkv6-d256 at 1e-3, float32's own
  spread there), 8 greedy tokens equal;
* a model on ``meta`` laid out over ``(1, 4)`` from a seed: every slot's
  blocks are the whole draw's on the card, bitwise, and the card then
  holds the blocks' bytes alone; the model-parallel ``Trainer``'s
  checkpoint copies to the host within the held bytes plus one block.

Skipped without a CUDA device: the fixtures decide, not the import.  Run on
the card with ``PYTHONPATH=src python -m pytest -q
tests/test_torch_tp_cuda.py``.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch.mesh import grid_mesh, make_host_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.encdec import enc_len_for  # noqa: E402
from repro_torch.models.tensor_parallel import lay_out  # noqa: E402
from repro_torch.serve.serve_step import make_prefill_fn, make_serve_step  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

pytestmark = pytest.mark.cuda

RTOL = 1e-4
GRAD_SHARE = 1e-4
LR = 1e-2
HANG_S = 300  # a step of the reduced model takes well under a second


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _mesh(dev, shape):
    return grid_mesh([dev] * (shape[0] * shape[1]), shape[1])


def _batch(cfg, device, rows=4, seq=17):
    rng = np.random.default_rng(0)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)).to(device)}


def _ends(fn):
    """``fn()`` in a thread, joined with a timeout: its result, or a failed
    test where it does not end."""
    out, err = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # re-raised in the test
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(HANG_S)
    if t.is_alive():
        pytest.fail(f"the step did not end within {HANG_S} s: a hang")
    if err:
        raise err[0]
    return out[0]


def _tp_vs_one(dev, shape):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    run = RunConfig(learning_rate=LR, warmup_steps=1)
    one = registry.get_model(cfg, device=dev)
    model = registry.get_model(cfg, device=dev)
    batch = _batch(cfg, dev)
    s1, m1 = make_train_step(one, run)(opt.init_opt_state(dict(one.named_parameters())), batch)
    step = make_train_step(model, run, _mesh(dev, shape))
    assert step.n_model == shape[1]
    state, metrics = _ends(lambda: step(step.init_state(), batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(m1[k]), rtol=RTOL, err_msg=k)
    got = step.gather(state)
    rows = [rep.gathered_grads(model) for rep in step.replicas]
    after = step.collect()  # the first row's blocks, gathered on the CPU
    for name, p in one.named_parameters():
        mean = rows[0][name].clone()
        for r in rows[1:]:
            mean.add_(r[name])
        mean.div_(len(rows))
        for what, a, b in (("grad", mean, p.grad), ("m", got.m[name], s1.m[name]),
                           ("v", got.v[name], s1.v[name])):
            top = float(b.abs().max())
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=RTOL,
                                       atol=GRAD_SHARE * top, err_msg=f"{what} {name}")
        np.testing.assert_allclose(after.get_parameter(name).detach().numpy(),
                                   p.detach().cpu().numpy(), rtol=0, atol=2 * LR, err_msg=name)
    return step, state, batch


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_tp_step_ends_and_matches_one_slot(dev, shape):
    _tp_vs_one(dev, shape)


def test_every_card_tp_step_matches_one_slot(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("one card: a model group across cards needs two or more")
    cfg = registry.get_config("qwen3-1.7b").reduced()
    run = RunConfig(learning_rate=LR, warmup_steps=1)
    one = registry.get_model(cfg, device=dev)
    model = registry.get_model(cfg, device=dev)
    batch = _batch(cfg, dev)
    s1, m1 = make_train_step(one, run)(opt.init_opt_state(dict(one.named_parameters())), batch)
    step = make_train_step(model, run, make_host_mesh(2))
    state, metrics = _ends(lambda: step(step.init_state(), batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(m1[k]), rtol=RTOL, err_msg=k)
    got = step.gather(state)
    for name in s1.m:
        for what, a, b in (("m", got.m[name], s1.m[name]), ("v", got.v[name], s1.v[name])):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=RTOL,
                                       atol=GRAD_SHARE * float(b.abs().max()),
                                       err_msg=f"{what} {name}")


def test_tp_step_makes_no_host_sync(dev):
    step, state, batch = _tp_vs_one(dev, (1, 4))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = _ends(lambda: step(state, batch))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [int(s) for s in state.step.flat] == [2] * 4 and np.isfinite(float(metrics["loss"]))


def test_tp_prefill_and_greedy_tokens_equal_one_slot(dev):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    one = registry.get_model(cfg, device=dev)
    lo = lay_out(registry.get_model(cfg, device=dev), _mesh(dev, (1, 4)))
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).to(dev)
    runs = []
    for model in (lo, one):
        last = make_prefill_fn(model)(prompt)
        cache = model.init_cache(4, 24, dtype=torch.float32)
        with torch.inference_mode():
            for t in range(15):
                model.decode_step(cache, prompt[:, t:t + 1])
        step = make_serve_step(model)
        nxt, toks = prompt[:, 15:16], []
        for _ in range(8):
            nxt, _, cache = step(cache, nxt)
            toks.append(nxt)
        runs.append((last.float().cpu(), torch.cat(toks, 1).cpu()))
    (tp_last, tp_toks), (one_last, one_toks) = runs
    np.testing.assert_allclose(tp_last.numpy(), one_last.numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(tp_toks, one_toks)


FAMILY_CASES = [  # (architecture, reduced() overrides, (data, model), step tolerance)
    ("hymba-1.5b", {"d_model": 40}, (1, 4), 1e-4),
    ("rwkv6-1.6b", {"d_model": 256}, (2, 2), 1e-3),
    ("seamless-m4t-large-v2", {}, (1, 2), 1e-4),
]


def _family_run(cfg, device, shape, batch):
    """One layout's forward, one train step and 8 greedy tokens after a
    15-token prompt, on ``device``'s slots."""
    cpu = {k: v.to(device) for k, v in batch.items()}
    extra = (cpu["frames"],) if "frames" in cpu else ()
    model = registry.get_model(cfg, device=device)
    model.load_state_dict(registry.get_model(cfg, device="cpu").state_dict())  # the CPU's draw
    lo = lay_out(model, _mesh(device, shape))
    with torch.no_grad():
        logits, _ = lo.forward(cpu["tokens"], *extra)
    kw = {"enc_len": enc_len_for(24)} if extra else {}
    cache = lo.init_cache(4, 24, dtype=torch.float32, **kw)
    with torch.inference_mode():
        if extra:
            lo.prefill_encoder(cache, extra[0])
        for t in range(15):
            lo.decode_step(cache, cpu["tokens"][:, t:t + 1])
    serve = make_serve_step(lo)
    nxt, toks = cpu["tokens"][:, 15:16], []
    for _ in range(8):
        nxt, _, cache = serve(cache, nxt)
        toks.append(nxt.cpu())
    step = make_train_step(model, RunConfig(learning_rate=LR, warmup_steps=1), lo.mesh)
    state, metrics = _ends(lambda: step(step.init_state(), cpu))
    return logits.cpu(), torch.cat(toks, 1), step.gather(state, torch.device("cpu")), \
        {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("name,over,shape,tol", FAMILY_CASES)
def test_family_layout_matches_the_cpu_path(dev, name, over, shape, tol):
    cfg = registry.get_config(name).reduced(**over)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 24)))}
    if cfg.n_encoder_layers:
        batch["frames"] = torch.from_numpy(
            (0.1 + 0.01 * rng.standard_normal((4, enc_len_for(24), cfg.d_model)))
            .astype(np.float32))
    card = _family_run(cfg, dev, shape, batch)
    host = _family_run(cfg, torch.device("cpu"), shape, batch)
    np.testing.assert_allclose(card[0].numpy(), host[0].numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(card[1], host[1])
    np.testing.assert_allclose(card[3]["loss"], host[3]["loss"], rtol=RTOL)
    np.testing.assert_allclose(card[3]["grad_norm"], host[3]["grad_norm"], rtol=tol)
    for name_ in host[2].m:
        for what, a, b in (("m", card[2].m[name_], host[2].m[name_]),
                           ("v", card[2].v[name_], host[2].v[name_])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                       atol=tol * float(b.abs().max()), err_msg=f"{what} {name_}")


# ------------------------------------------------------------ from its own blocks --

@pytest.mark.parametrize("name", ["qwen3-1.7b", "internvl2-26b"])
def test_block_draw_on_the_card_is_the_whole_draws(dev, name):
    cfg = registry.get_config(name).reduced()
    whole = dict(registry.get_model(cfg, device=dev).named_parameters())
    lo = lay_out(registry.get_model(cfg, device="meta"), _mesh(dev, (1, 4)), seed=0)
    g = lo.groups[0]
    for k, sl in enumerate(g.slots):
        for pname, p in sl.named_parameters():
            assert p.device == dev and torch.equal(p, whole[pname][g.slices(k, pname)]), pname


def test_lay_out_from_a_seed_holds_the_blocks_alone(dev):
    cfg = registry.get_config("internvl2-26b").reduced()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    lo = lay_out(registry.get_model(cfg, device="meta", dtype=torch.bfloat16),
                 _mesh(dev, (1, 4)), seed=0)
    held = torch.cuda.memory_allocated() - base
    blocks = sum(p.numel() * p.element_size() for sl in lo.shards() for p in sl.parameters())
    n = sum(1 for sl in lo.shards() for _ in sl.parameters())
    assert blocks <= held <= blocks + 512 * n  # the allocator rounds each block to 512 B


def test_trainer_checkpoint_peak_within_held_plus_one_block(dev, tmp_path):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    batch = _batch(cfg, dev)
    run = RunConfig(steps=2, checkpoint_every=2, warmup_steps=1, async_checkpoint=False)
    trainer = Trainer(registry.get_model(cfg, device="meta"), run, iter([batch] * 2), tmp_path,
                      mesh=_mesh(dev, (1, 4)))
    peaks = {}
    tree_of = trainer._checkpoint_tree

    def measured(state):
        torch.cuda.synchronize()
        peaks["held"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tree = tree_of(state)
        peaks["save"] = torch.cuda.max_memory_allocated()
        return tree

    trainer._checkpoint_tree = measured
    _, state, _ = trainer.train(steps=2)
    one_block = max([p.numel() * p.element_size()
                     for sl in trainer.step_fn.laid.shards() for p in sl.parameters()]
                    + [t.numel() * t.element_size() for a in state.m.values() for t in a.flat])
    assert trainer.ckpt.latest_step() == 2
    assert peaks["save"] <= peaks["held"] + one_block
