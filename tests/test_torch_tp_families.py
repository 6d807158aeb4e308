"""Tensor parallelism over ``model`` for the hybrid, ssm and encoder-decoder
families, and the ``pod`` axis of the train step, on the CPU, against the
JAX package.

As ``tests/test_torch_tp.py`` does for the dense, moe and vlm families:
``(data, model)`` meshes of ``'cpu'`` slots, the reference being the JAX
package's unsharded function on the same seed-0 weights
(``params_to_reference``), which GSPMD's sharded result equals.  Held for
hymba ``reduced()`` (4 heads, 1 kv head, 8 SSD heads of 16: every split on
head boundaries) and ``reduced(d_model=40)`` (``d_inner`` 80 = 5 SSD heads,
2.5 a slot over 2 and 1.25 over 4: ``ssm_heads`` stays whole and each slot
runs the heads its columns touch, the small twin of hymba-1.5b's
full-width layout on 4 slots), rwkv6 ``reduced(d_model=256)`` (4 heads of
64) and seamless ``reduced()`` (2 kv heads: whole on 4 slots), each over
``(1, 2)``, ``(1, 4)`` and ``(2, 2)``:

* the forward at rtol/atol 1e-4, and the prefill fn;
* the teacher-forced ``decode_step`` against the reference's forward at
  2e-3, and 8 greedy serve tokens after a 16-token prompt exactly, each
  step's top-2 gap above 1e-4;
* the train step against the reference's unsharded step with
  ``tests/test_torch_tp.py``'s checks (loss, lr and grad_norm at rtol
  1e-4; the gradient and m at 1e-4 of the leaf's largest entry, v at
  twice that; rwkv6-d256's grad_norm, gradient, m and v at 1e-3, float32's
  own spread there: ``STEP_TOL``; the parameters after), every data row's
  parameters equal;

and rwkv6 ``reduced()`` (one head of 64) over two slots refused, naming
the shapes; a ``Trainer`` over ``(2, 2)`` on hymba whose checkpoint resumes
bitwise on one slot and, through ``elastic_remesh``, over ``(1, 2)``; a
step over a ``('pod', 'data', 'model')`` mesh of
``(2, 1, 2)`` bitwise equal to the same step over ``(2, 2)``, and a
``Trainer`` over it that resumes bitwise; the launcher and the serving
example laid out.  Each reference is computed once (``_reference``).
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
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import grid_mesh  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_to_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models.encdec import enc_len_for  # noqa: E402
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
CASES = {  # name: (architecture, reduced() overrides)
    "hymba": ("hymba-1.5b", {}),
    "hymba-d40": ("hymba-1.5b", {"d_model": 40}),
    "rwkv6-d256": ("rwkv6-1.6b", {"d_model": 256}),
    "seamless": ("seamless-m4t-large-v2", {}),
}
MESHES = ((1, 2), (1, 4), (2, 2))  # (data, model)
B, S = 4, 24
PROMPT = 16  # serve: a 16-token prompt, then 8 greedy steps
RTOL = ATOL = 1e-4  # forward
DEC_TOL = 2e-3  # decode against forward: the reference's own
GRAD_SHARE = 1e-4  # gradient atol, a share of the leaf's largest |g|
LR = 1e-2
# rwkv6-d256's gradient is float32's own to a few 1e-4: 195.6 of its grad
# norm of 197 is layer 0's ``u``, through the group norm's rsqrt(var + 1e-5)
# at the first position, where wkv is 0; weights perturbed by 1e-7
# (relative) move the norm by 3.9e-4, and against a run with float64 weights
# and activations the JAX package's step is 1.4e-4 off, the port's one slot
# 7e-6 and its layouts 1.2e-4.  So its grad_norm, gradient, m and v are held
# at 1e-3 (v at twice), its loss at 1e-4 as the others'
STEP_TOL = {"rwkv6-d256": 1e-3}


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


def _configs(case):
    name, over = CASES[case]
    return jax_registry.get_config(name).reduced(**over), registry.get_config(name).reduced(**over)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.n_encoder_layers:
        out["frames"] = (0.1 + 0.01 * rng.standard_normal(
            (B, enc_len_for(S), cfg.d_model))).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _extra(batch):
    return (batch["frames"],) if "frames" in batch else ()


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The port's seed-0 weights as the reference's tree, and the JAX
    package's forward, prefill, greedy serve tokens and logits, and one
    train step from fresh moments on them."""
    jcfg, cfg = _configs(case)
    tree = params_to_reference(registry.get_model(cfg, device="cpu"))
    model = jax_registry.get_model(jcfg)
    batch = _inputs(cfg)
    fwd = jax.jit(model.forward)
    extra = _extra(batch)
    logits, _ = fwd(tree, batch["tokens"], *extra)
    out = dict(tree=tree, batch=batch, logits=np.asarray(logits))
    proxy = types.SimpleNamespace(cfg=jcfg, forward=fwd, decode_step=jax.jit(model.decode_step))
    out["prefill"] = np.asarray(jax_serve.make_prefill_fn(proxy)(tree, batch["tokens"], *extra))
    if extra:
        cache = model.init_cache(B, S, dtype=jnp.float32, enc_len=enc_len_for(S))
        cache = jax.jit(model.prefill_encoder)(tree, cache, extra[0])
    else:
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
    jstep = jax_ts.make_train_step(model, JaxRunConfig(learning_rate=LR, warmup_steps=1))
    out["step"] = jax.tree.map(np.asarray, jax.jit(
        lambda p, b: jstep(p, jax_opt.init_opt_state(p), b))(tree, batch))
    return out


def _port(case):
    ref = _reference(case)
    cfg = _configs(case)[1]
    return cfg, params_from_reference(registry.get_model(cfg, device="cpu"), ref["tree"]), ref


def _cache(served, cfg, batch):
    if cfg.n_encoder_layers:
        cache = served.init_cache(B, S, dtype=torch.float32, enc_len=enc_len_for(S))
        with torch.no_grad():
            return served.prefill_encoder(cache, batch["frames"])
    return served.init_cache(B, S, dtype=torch.float32)


# ------------------------------------------------------------ forward, decode --

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_forward_equals_reference(case, shape):
    cfg, model, ref = _port(case)
    lo = lay_out(model, _mesh(shape))
    batch = _torch(ref["batch"])
    with torch.no_grad():
        logits, aux = lo.forward(batch["tokens"], *_extra(batch))
    assert logits.shape == ref["logits"].shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=RTOL, atol=ATOL)
    got = make_prefill_fn(lo)(batch["tokens"], *_extra(batch))
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_decode_and_greedy_tokens_equal_reference(case, shape):
    cfg, model, ref = _port(case)
    lo = lay_out(model, _mesh(shape))
    batch = _torch(ref["batch"])
    tokens = batch["tokens"]
    cache = _cache(lo, cfg, batch)
    assert cache["pos"].shape == shape
    assert all(len(p) == B // shape[0] for p in cache["pos"].flat)  # the rows split the batch
    got = []
    with torch.no_grad():
        for t in range(S):
            logits, cache = lo.decode_step(cache, tokens[:, t:t + 1])
            got.append(logits[:, 0].numpy())
    assert all(int(p[0]) == S for p in cache["pos"].flat)
    np.testing.assert_allclose(np.stack(got, axis=1), ref["logits"], rtol=DEC_TOL, atol=DEC_TOL)
    cache = _cache(lo, cfg, batch)
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


def test_layouts_of_the_reduced_configs():
    """Which blocks split, and the SSD columns each slot runs."""
    def layout(case, shape):
        return lay_out(_port(case)[1], _mesh(shape)).layout

    two, four = layout("hymba", (1, 2)), layout("hymba", (1, 4))
    assert two.heads and not two.kv and two.ssd and two.ssd_heads  # 8 SSD heads split
    assert [four.ssd_select(k).heads for k in range(4)] == [None] * 4
    d40 = layout("hymba-d40", (1, 4))
    assert d40.ssd and not d40.ssd_heads  # 5 SSD heads stay whole
    sels = [d40.ssd_select(k) for k in range(4)]  # 20 columns a slot of 5 heads of 16
    assert [(s.heads.start, s.heads.stop, s.pad) for s in sels] == [
        (0, 2, (0, 12)), (1, 3, (4, 8)), (2, 4, (8, 4)), (3, 5, (12, 0))]
    assert {p for _, p, _ in d40.region} == {
        ("attn", "wk"), ("attn", "wv"), ("ssd", "wb"), ("ssd", "wc"), ("ssd", "wdt"),
        ("ssd", "dt0")}
    rwkv = layout("rwkv6-d256", (1, 4))
    assert rwkv.heads and rwkv.ffn and rwkv.region == [
        ("layers", ("tm", "mu"), None), ("layers", ("cm", "mu"), slice(0, 1))]
    sea = layout("seamless", (1, 4))
    assert sea.heads and not sea.kv and sea.vocab
    assert {(k, p) for k, p, _ in sea.region} == {
        (k, (part, w)) for k, part in (("encoder", "attn"), ("decoder", "attn"),
                                       ("decoder", "cross")) for w in ("wk", "wv")}


def test_rwkv6_split_inside_a_head_raises_naming_the_shapes():
    """rwkv6 ``reduced()`` has one head of 64 columns: over two slots its
    r.k would be contracted across the slots, a layout that is refused,
    never run whole in its place."""
    cfg = registry.get_config("rwkv6-1.6b").reduced()
    model = registry.get_model(cfg, device="cpu")
    match = r"64 columns \(1 heads of 64\) over a 2-slot 'model' axis give each slot 32 columns"
    with pytest.raises(NotImplementedError, match=match):
        lay_out(model, _mesh((1, 2)))
    with pytest.raises(NotImplementedError, match=match):
        make_train_step(model, RunConfig(), _mesh((1, 2)))


# ------------------------------------------------------------ the train step --

def _close(got, want, share, rtol=RTOL, what=""):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=rtol,
                                   atol=share * float(np.abs(w).max()),
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _assert_np_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_train_step_equals_reference(case, shape):
    """``tests/test_torch_tp.py``'s checks of one mesh step."""
    cfg, model, ref = _port(case)
    step = make_train_step(model, RunConfig(learning_rate=LR, warmup_steps=1), _mesh(shape))
    assert isinstance(step, DataParallelStep) and step.n_model == shape[1]
    state, metrics = step(step.init_state(), _torch(ref["batch"]))
    p_want, o_want, m_want = ref["step"]
    tol = STEP_TOL.get(case, GRAD_SHARE)
    for k in ("loss", "lr", "grad_norm"):
        rtol = tol if k == "grad_norm" else RTOL
        np.testing.assert_allclose(float(metrics[k]), float(m_want[k]), rtol=rtol, atol=1e-7,
                                   err_msg=k)
    got = opt_state_to_reference(model, step.gather(state))
    assert int(got.step) == 1
    scale = min(1.0, 1.0 / max(float(m_want["grad_norm"]), 1e-9))
    grads = jax.tree.map(lambda m: m / np.float32(0.1 * scale), o_want.m)
    _close(jax.tree.map(lambda m: m / np.float32(0.1 * scale), got.m), grads, tol, rtol=tol,
           what="grad ")
    _close(got.m, o_want.m, tol, rtol=tol, what="m ")
    _close(got.v, o_want.v, 2 * tol, rtol=2 * tol, what="v ")
    rows = []
    for rep in step.replicas[::-1]:  # every data row's gathered parameters, the first last
        rep.gather_into(model)
        rows.insert(0, params_to_reference(model))
    for other in rows[1:]:
        _assert_np_equal(other, rows[0])
    for (path, w), g, mm in zip(jax.tree_util.tree_flatten_with_path(p_want)[0],
                                jax.tree.leaves(rows[0]), jax.tree.leaves(o_want.m)):
        gr = np.abs(mm) / 0.1
        floor = tol * gr.max()
        noisy = gr < floor
        np.testing.assert_allclose(g[~noisy], w[~noisy], rtol=RTOL,
                                   atol=1e-6 + LR * 1e-8 / floor, err_msg=str(path))
        np.testing.assert_allclose(g[noisy], w[noisy], rtol=0, atol=2 * LR, err_msg=str(path))


# ------------------------------------------------------------ the Trainer, pods --

def _data(cfg, seed):
    rng = np.random.default_rng(seed)
    return iter(lambda: {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32))}, None)


def _run():
    return RunConfig(steps=6, checkpoint_every=4, warmup_steps=2, learning_rate=1e-3,
                     async_checkpoint=False)


def _pod_mesh():
    return sharding.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 1, 2),
                         ("pod", "data", "model"))


def test_hymba_trainer_over_data_and_model_resumes_on_one_slot(tmp_path):
    cfg = registry.get_config("hymba-1.5b").reduced(d_model=40)
    model = registry.get_model(cfg, device="meta")
    trainer = Trainer(model, _run(), _data(cfg, 0), tmp_path / "run", mesh=_mesh((2, 2)))
    _, state, last = trainer.train(steps=4)
    assert trainer.ckpt.latest_step() == 4 and np.isfinite(last["loss"])
    want_o = opt_state_to_reference(model, trainer.step_fn.gather(state))
    one = registry.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    start, _, got = Trainer(one, _run(), _data(cfg, 1), tmp_path / "run").resume_or_init()
    assert start == 4 and int(got.step) == 4
    _assert_np_equal(params_to_reference(one), params_to_reference(trainer.step_fn.collect()))
    got = opt_state_to_reference(one, got)
    _assert_np_equal((got.m, got.v), (want_o.m, want_o.v))


def test_elastic_remesh_of_hymba_onto_a_model_axis(tmp_path):
    """A ``(2, 2)`` checkpoint of hymba (its SSD heads split inside a slot's
    columns) through ``elastic_remesh`` onto 2 survivors at
    ``model_parallel=2``: trained on bitwise as a resume on that mesh."""
    cfg = registry.get_config("hymba-1.5b").reduced(d_model=40)
    model = registry.get_model(cfg, device="meta")
    Trainer(model, _run(), _data(cfg, 0), tmp_path / "run", mesh=_mesh((2, 2))).train(steps=4)
    mesh, step, tree, _ = elastic_remesh(CheckpointManager(tmp_path / "run" / "ckpt"),
                                         checkpoint_skeleton(model),
                                         lambda m: checkpoint_shardings(model, m),
                                         devices=["cpu"] * 2, model_parallel=2)
    assert step == 4 and mesh.shape == {"data": 1, "model": 2}
    m2 = registry.get_model(cfg, device="meta")
    t2 = Trainer(m2, _run(), _data(cfg, 1), tmp_path / "elastic", mesh=mesh)
    _, s2, _ = t2.train(steps=6, restored=(step, tree))
    m3 = registry.get_model(cfg, device="meta")
    t3 = Trainer(m3, _run(), _data(cfg, 1), tmp_path / "run", mesh=_mesh((1, 2)))
    _, s3, _ = t3.train(steps=6)
    _assert_np_equal(params_to_reference(t2.step_fn.collect()),
                     params_to_reference(t3.step_fn.collect()))
    _assert_np_equal(*(opt_state_to_reference(m, t.step_fn.gather(s))
                       for m, t, s in ((m2, t2, s2), (m3, t3, s3))))


def test_pod_axis_step_is_bitwise_the_data_step():
    """``pod`` folds into the data rows, outermost: a step over ``(2, 1, 2)``
    ``('pod', 'data', 'model')`` is the step over ``(2, 2)``, bit for bit;
    any other axis larger than one is refused."""
    cfg = registry.get_config("hymba-1.5b").reduced()
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 17)).astype(np.int32))}
    run = RunConfig(learning_rate=LR, warmup_steps=1)
    outs = []
    for mesh in (_pod_mesh(), _mesh((2, 2))):
        model = registry.get_model(cfg, device="cpu")
        step = make_train_step(model, run, mesh)
        assert step.mesh.shape == {"data": 2, "model": 2} and len(step.replicas) == 2
        state, metrics = step(step.init_state(), batch)
        state, metrics = step(state, batch)
        outs.append((params_to_reference(step.collect()),
                     opt_state_to_reference(model, step.gather(state)),
                     {k: float(v) for k, v in metrics.items()}))
    (p1, o1, m1), (p2, o2, m2) = outs
    _assert_np_equal(p1, p2)
    _assert_np_equal((o1.m, o1.v, o1.step), (o2.m, o2.v, o2.step))
    assert m1 == m2
    other = sharding.Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 1, 2),
                          ("stage", "data", "model"))
    with pytest.raises(NotImplementedError, match="'pod', 'data' and 'model' axes"):
        make_train_step(registry.get_model(cfg, device="cpu"), run, other)


def test_trainer_over_a_pod_mesh_resumes(tmp_path):
    cfg = registry.get_config("hymba-1.5b").reduced()
    model = registry.get_model(cfg, device="meta")
    trainer = Trainer(model, _run(), _data(cfg, 0), tmp_path / "run", mesh=_pod_mesh())
    assert trainer.mesh.shape == {"data": 2, "model": 2}
    _, state, _ = trainer.train(steps=4)
    want_o = opt_state_to_reference(model, trainer.step_fn.gather(state))
    m2 = registry.get_model(cfg, device="meta")
    t2 = Trainer(m2, _run(), _data(cfg, 1), tmp_path / "run", mesh=_pod_mesh())
    start, _, s2 = t2.resume_or_init()
    assert start == 4
    _assert_np_equal(params_to_reference(t2.step_fn.collect()),
                     params_to_reference(trainer.step_fn.collect()))
    got = opt_state_to_reference(m2, t2.step_fn.gather(s2))
    _assert_np_equal((got.m, got.v), (want_o.m, want_o.v))
    _, s2, last = t2.train(steps=6)
    assert [int(s) for s in s2.step.flat] == [6] * 4 and np.isfinite(last["loss"])
    assert t2.ckpt.all_steps() == [4, 6]


# ------------------------------------------------------------ entry points --

def test_launcher_trains_seamless_over_a_model_axis_on_cpu(tmp_path, capsys):
    argv = ["--arch", "seamless-m4t-large-v2", "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "8", "--device", "cpu", "--model-parallel", "2", "--workdir", str(tmp_path)]
    assert launch.main(argv) == 0
    assert "mesh={'data': 1, 'model': 2}" in capsys.readouterr().out
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2


def test_serve_example_runs_hymba_laid_out_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"),
                        "--arch", "hymba-1.5b", "--device", "cpu", "--model-parallel", "4",
                        "--tokens", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "model_parallel=4" in r.stdout and "decode : 4 tokens" in r.stdout
