"""Training over a mesh of slots on the card, against one slot and the CPU.

On 4 slots of the first card (``parallel/sharding.Mesh``, a stream a
slot), float32 with TF32 off:

* one ``DataParallelStep`` step of qwen3-1.7b reduced against one
  ``make_train_step`` step on one slot: loss and grad_norm at rtol 1e-4,
  the gradient mean (the replicas' gradients added in slot order over
  their count) and the moments at 1e-4 of each leaf's largest entry, the
  parameters after the step within 2 lr; every replica equal;
* the mesh step queues its work without a host sync (CUDA sync debug mode
  ``'error'``);
* the twin of ``tests/test_compression_multidevice.py`` on the card equals
  the same run on 4 CPU slots bitwise;
* ``pipeline_forward`` over 4 slots equals the layer stack applied
  microbatch by microbatch bitwise;
* with two cards or more, a step over every card against one slot.

Skipped without a CUDA device: the fixtures decide, not the import.  Run on
the card with ``PYTHONPATH=src python -m pytest -q
tests/test_torch_dist_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.parallel import compression as comp  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_forward  # noqa: E402
from repro_torch.parallel.sharding import Mesh, shard_map_compat  # noqa: E402
from repro_torch.parallel.sharding import PartitionSpec as P  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

pytestmark = pytest.mark.cuda

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


def _batch(cfg, device, rows=4, seq=17):
    rng = np.random.default_rng(0)
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)).to(device)}


def _mesh_vs_one(dev, mesh):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    run = RunConfig(learning_rate=LR, warmup_steps=1)
    one = registry.get_model(cfg, device=dev)
    model = registry.get_model(cfg, device=dev)
    model.load_state_dict(one.state_dict())
    batch = _batch(cfg, dev)
    s1, m1 = make_train_step(one, run)(opt.init_opt_state(dict(one.named_parameters())), batch)
    step = make_train_step(model, run, mesh)
    state, metrics = step(step.init_state(), batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(m1[k]), rtol=RTOL, err_msg=k)
    got = step.gather(state)
    for name, p in one.named_parameters():
        mean = None
        for rep in step.replicas:
            g = rep.get_parameter(name).grad.to(dev)
            mean = g.clone() if mean is None else mean.add_(g)
        mean.div_(step.n)
        for what, a, b in (("grad", mean, p.grad), ("m", got.m[name], s1.m[name]),
                           ("v", got.v[name], s1.v[name])):
            top = float(b.abs().max())
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=RTOL,
                                       atol=GRAD_SHARE * top, err_msg=f"{what} {name}")
        np.testing.assert_allclose(model.get_parameter(name).detach().cpu().numpy(),
                                   p.detach().cpu().numpy(), rtol=0, atol=2 * LR, err_msg=name)
    for rep in step.replicas[1:]:
        for a, b in zip(rep.parameters(), model.parameters()):
            assert torch.equal(a.to(dev), b)
    return step, state, batch


def test_mesh_step_matches_one_slot(dev):
    _mesh_vs_one(dev, Mesh([dev] * 4))


def test_mesh_step_makes_no_host_sync(dev):
    step, state, batch = _mesh_vs_one(dev, Mesh([dev] * 4))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [int(s) for s in state.step.flat] == [2] * 4 and np.isfinite(float(metrics["loss"]))


def test_every_card_mesh_step_matches_one_slot(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("one card: the every-card mesh needs two or more")
    _mesh_vs_one(dev, make_host_mesh())


def _twin(mesh):
    rng = np.random.default_rng(0)
    G = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))

    def sync(g, e):
        out, ne = comp.compressed_psum_tree({"g": g}, {"g": e}, axis_name="data")
        return out["g"], ne["g"]

    shmap = shard_map_compat(sync, mesh, (P("data"), P("data")), (P("data"), P("data")))
    err = torch.zeros((4, 64), device=mesh.home)
    trace = []
    for step in range(30):
        out, err = shmap(G.to(mesh.home) * (1.0 + 0.1 * step), err)
        trace.append((out.cpu().numpy(), err.cpu().numpy()))
    return trace


def test_compression_on_card_is_bitwise_the_cpu(dev):
    card, cpu = _twin(Mesh([dev] * 4)), _twin(Mesh(["cpu"] * 4))
    for (co, ce), (po, pe) in zip(card, cpu):
        assert np.array_equal(co, po) and np.array_equal(ce, pe)
        assert all(np.array_equal(co[0], co[k]) for k in range(1, 4))


def test_gpipe_is_bitwise_the_microbatched_stack(dev):
    cfg = registry.get_config("qwen3-1.7b").reduced(n_layers=8, dtype="bfloat16")
    from repro_torch.models.convert import stack_named
    from repro_torch.models.transformer import layer_apply

    model = registry.get_model(cfg, device=dev, dtype=torch.bfloat16)
    stacked = stack_named(model, dict(model.named_parameters()))["layers"]
    x = torch.randn((8, 32, cfg.d_model), device=dev).to(torch.bfloat16)

    def layer_fn(lp, h):
        pos = torch.arange(h.shape[1], device=h.device).expand(h.shape[0], h.shape[1])
        return layer_apply(lp, h, pos, cfg, 0)[0]

    def stack(h):
        for i in range(cfg.n_layers):
            h = layer_fn(sharding.tree_map(lambda p: p[i], stacked), h)
        return h

    with torch.no_grad():
        got = pipeline_forward(layer_fn, stacked, x, Mesh([dev] * 4, ("pod",)), n_micro=4)
        want = torch.cat([stack(m) for m in x.reshape(4, 2, 32, cfg.d_model)])
    assert torch.equal(got, want)
