"""The LLM scaffold's serving path against the JAX package, on the CPU.

Both packages run in one process on the same seeded numpy inputs; the
weights come from the reference's ``model.init`` and are carried into the
port with ``params_from_reference``.  Held:

* every config, shape cell and run config field for field, the full
  configs' specs (paths, shapes, logical axes, init) without allocating,
  and ``pspec`` over every spec leaf on the (16, 16) and (2, 16, 16) meshes;
* the weight round trip, exactly;
* every architecture's ``forward`` (logits and aux) at rtol 1e-4, atol 1e-4,
  its teacher-forced ``decode_step`` against the JAX ``forward`` at the
  reference's 2e-3 (``tests/test_models.py``), its greedy serve tokens
  exactly over 8 steps (each step's top-2 gap above the logits tolerance,
  so no near-tie decides one), and ``make_prefill_fn``;
* the MoE architectures at their own capacity factor 1.25 with groups that
  leave padded tokens: dropped tokens and tied pad rows;
* the primitives: blockwise attention, the chunked decay scan, decode
  attention's uniform and ragged paths.

Each JAX output is computed once for each architecture (``_reference``).
The frontends' stub inputs are 0.1 + 0.01 N(0, 1), after the reference's
tests' constant 0.1: at unit-variance frames the reference's own jitted and
unrolled seamless forwards differ by 3.9e-4, past the tolerance, the
randomly initialised attention being that sharp
(``scripts/torch_models_conditioning.py``).
"""
import dataclasses
import functools
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jax_base  # noqa: E402
from repro.configs import shapes as jax_shapes  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import params as jax_params  # noqa: E402
from repro.models import registry as jax_registry  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.encdec import EncDec as JaxEncDec  # noqa: E402
from repro.parallel import sharding as jax_sharding  # noqa: E402
from repro.serve import serve_step as jax_serve  # noqa: E402
from repro_torch.configs import base, shapes  # noqa: E402
from repro_torch.models import layers, params, registry, ssm  # noqa: E402
from repro_torch.models.convert import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.models.encdec import EncDec, enc_len_for  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import Mesh, use_mesh  # noqa: E402
from repro_torch.serve.serve_step import make_prefill_fn, make_serve_step  # noqa: E402

ARCHS = registry.list_archs()
MOE = ["arctic-480b", "deepseek-moe-16b"]
B, S = 2, 24
PROMPT = S - 8  # serve: a 16-token prompt, then 8 greedy steps
RTOL = ATOL = 1e-4  # forward
DEC_TOL = 2e-3  # decode against forward: the reference's own
MOE_GROUP = 20  # B * S = 48 tokens -> groups of 20, the last padded by 12


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These models are small: one intra-op thread runs them about as fast
    alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, capacity):
    over = {"capacity_factor": 8.0} if capacity == "cf8" else {"moe_group_size": MOE_GROUP}
    return (jax_registry.get_config(name).reduced(**over),
            registry.get_config(name).reduced(**over))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    n = enc_len_for(S) if cfg.n_encoder_layers else cfg.frontend_tokens
    extra = ()
    if n:
        extra = ((0.1 + 0.01 * rng.standard_normal((B, n, cfg.d_model))).astype(np.float32),)
    return tokens, extra


def _jax_forward(fwd, cfg, tree, tokens, extra):
    if cfg.frontend_tokens:
        return fwd(tree, tokens, prefix_embeds=extra[0])
    return fwd(tree, tokens, *extra)


@functools.lru_cache(maxsize=None)
def _reference(name, capacity):
    """The JAX package's weights and outputs for one architecture: forward,
    and at capacity 8 the text-only forward, greedy serve tokens and logits,
    and the prefill fn's logits."""
    jcfg, cfg = _configs(name, capacity)
    model = jax_registry.get_model(jcfg)
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    tokens, extra = _inputs(cfg)
    fwd = jax.jit(model.forward)
    logits, aux = _jax_forward(fwd, jcfg, tree, tokens, extra)
    out = dict(tree=tree, tokens=tokens, extra=extra, logits=np.asarray(logits),
               aux=float(aux))
    if capacity != "cf8":
        return out
    out["text_logits"] = (np.asarray(fwd(tree, tokens)[0]) if jcfg.frontend_tokens
                          else out["logits"])
    proxy = types.SimpleNamespace(cfg=jcfg, forward=fwd, decode_step=jax.jit(model.decode_step))
    out["prefill"] = np.asarray(jax_serve.make_prefill_fn(proxy)(tree, tokens, *extra))
    cache = _jax_cache(model, jcfg, tree, extra)
    for t in range(PROMPT - 1):
        _, cache = proxy.decode_step(tree, cache, tokens[:, t:t + 1])
    step = jax_serve.make_serve_step(proxy)
    nxt, toks, step_logits = tokens[:, PROMPT - 1:PROMPT], [], []
    for _ in range(8):
        nxt, lg, cache = step(tree, cache, nxt, jax.random.PRNGKey(0))
        toks.append(np.asarray(nxt))
        step_logits.append(np.asarray(lg[:, -1]))
    out["serve_tokens"] = np.concatenate(toks, axis=1)
    out["serve_logits"] = np.stack(step_logits, axis=1)
    return out


def _jax_cache(model, cfg, tree, extra):
    if isinstance(model, JaxEncDec):
        cache = model.init_cache(B, S, dtype=jnp.float32, enc_len=enc_len_for(S))
        return jax.jit(model.prefill_encoder)(tree, cache, extra[0])
    return model.init_cache(B, S, dtype=jnp.float32)


def _port(name, capacity="cf8"):
    ref = _reference(name, capacity)
    cfg = _configs(name, capacity)[1]
    return cfg, params_from_reference(registry.get_model(cfg, device="cpu"), ref["tree"]), ref


def _cache(model, cfg, extra):
    if isinstance(model, EncDec):
        cache = model.init_cache(B, S, dtype=torch.float32, enc_len=enc_len_for(S))
        return model.prefill_encoder(cache, torch.from_numpy(extra[0]))
    return model.init_cache(B, S, dtype=torch.float32)


def _forward(model, cfg, tokens, extra):
    tokens = torch.from_numpy(tokens)
    extra = [torch.from_numpy(e) for e in extra]
    with torch.no_grad():
        if cfg.frontend_tokens:
            logits, aux = model.forward(tokens, prefix_embeds=extra[0])
        else:
            logits, aux = model.forward(tokens, *extra)
    return logits.numpy(), float(aux)


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("name", ARCHS)
def test_config_equals_reference(name):
    ours, theirs = registry.get_config(name), jax_registry.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("vocab_padded", "is_attention_free", "supports_long_context", "n_params",
                 "n_active_params"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    for over in ({}, {"capacity_factor": 8.0}, {"moe_group_size": MOE_GROUP}):
        r, rj = ours.reduced(**over), theirs.reduced(**over)
        assert dataclasses.asdict(r) == dataclasses.asdict(rj)
        assert (r.n_params, r.n_active_params) == (rj.n_params, rj.n_active_params)


@pytest.mark.parametrize("cls", ["ModelConfig", "ShapeConfig", "RunConfig"])
def test_config_classes_equal_reference(cls):
    def fields(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]
    assert fields(getattr(base, cls)) == fields(getattr(jax_base, cls))
    assert dataclasses.asdict(base.RunConfig()) == dataclasses.asdict(jax_base.RunConfig())
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()}


def test_registry_lists_the_reference_archs():
    assert registry.ARCHS == jax_registry.ARCHS
    assert registry.list_archs() == jax_registry.list_archs()
    with pytest.raises(KeyError):
        registry.get_config("bogus")


# ------------------------------------------------------------------ specs --

def _leaves(tree_paths, spec):
    return [(path, tuple(leaf.shape), tuple(leaf.axes), leaf.init)
            for path, leaf in tree_paths(spec)]


def _flat(tree, path=()):
    """{path: leaf} of a nested dict of arrays."""
    if not isinstance(tree, dict):
        return {path: tree}
    return {p: a for k in sorted(tree) for p, a in _flat(tree[k], path + (k,)).items()}


@pytest.mark.parametrize("name", ARCHS)
def test_full_spec_equals_reference(name):
    cfg = registry.get_config(name)
    ours = registry.model_spec(cfg)
    jmodel = jax_registry.get_model(jax_registry.get_config(name))
    theirs = jmodel.spec()
    assert _leaves(params.tree_paths, ours) == _leaves(jax_params.tree_paths, theirs)
    assert params.axes_tree(ours) == jax_params.axes_tree(theirs)
    abstract = _flat(params.abstract_params(ours))  # no allocation
    want = _flat(jmodel.abstract())
    assert list(abstract) == list(want)
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in abstract.values())
    assert [tuple(t.shape) for t in abstract.values()] == [tuple(a.shape) for a in want.values()]


@pytest.mark.parametrize("mesh_shape", [{"data": 16, "model": 16},
                                        {"pod": 2, "data": 16, "model": 16}])
def test_pspec_equals_reference_on_every_leaf(mesh_shape):
    mesh = types.SimpleNamespace(shape=mesh_shape)
    n = 0
    for name in ARCHS:
        for _, leaf in params.tree_paths(registry.model_spec(registry.get_config(name))):
            for shape in (None, leaf.shape):
                ours = sharding.pspec(leaf.axes, mesh=mesh, shape=shape)
                theirs = jax_sharding.pspec(leaf.axes, mesh=mesh, shape=shape)
                assert ours == tuple(theirs), (name, leaf)
                n += 1
    assert n > 300  # ~155 leaves over the ten specs, with and without shapes


@pytest.mark.parametrize("name", ARCHS)
def test_cache_layout_equals_reference(name):
    cfg = registry.get_config(name).reduced(capacity_factor=8.0)
    jmodel = jax_registry.get_model(jax_registry.get_config(name).reduced(capacity_factor=8.0))
    model = registry.get_model(cfg, device="cpu")
    ours = model.init_cache(B, S, dtype=torch.float32)
    theirs = jmodel.init_cache(B, S, dtype=jnp.float32)
    shape_of = lambda t: tuple(t.shape)  # noqa: E731
    assert jax.tree.map(shape_of, ours) == jax.tree.map(shape_of, theirs)
    axes = lambda t: t.axes  # noqa: E731
    is_ax = lambda x: isinstance(x, (sharding.Ax, jax_sharding.Ax))  # noqa: E731
    assert jax.tree.map(axes, model.cache_axes(), is_leaf=is_ax) == \
        jax.tree.map(axes, jmodel.cache_axes(), is_leaf=is_ax)


def test_rules_and_constrain():
    x = torch.ones(2, 3)
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    assert sharding.active_mesh() is None and sharding.constrain(x, "batch", "embed") is x
    over = {"embed": None, "mlp": ("data", "model")}
    with use_mesh(Mesh(["cpu"]), rules=over), jax_sharding.use_mesh(None, rules=over):
        assert sharding.active_rules() == jax_sharding.active_rules()
        assert sharding.active_rules()["embed"] is None
        got = sharding.pspec(("embed", "mlp", "heads"), mesh=mesh)
        assert got == tuple(jax_sharding.pspec(("embed", "mlp", "heads"), mesh=mesh))
        assert sharding.constrain(x, "batch", "embed") is x  # one slot: no-op
    assert sharding.active_rules() == sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    model = registry.get_model(registry.get_config("qwen3-1.7b").reduced(), device="cpu")
    with use_mesh(Mesh(["cpu", "cpu"])):  # a model not laid out: told how to lay it out
        with pytest.raises(NotImplementedError, match=r"lay_out\(model, mesh\)"):
            sharding.constrain(x, "batch", "embed")
        with pytest.raises(NotImplementedError, match=r"lay_out\(model, mesh\)"), \
                torch.no_grad():
            model.forward(torch.zeros((1, 4), dtype=torch.long))


# ---------------------------------------------------------------- weights --

@pytest.mark.parametrize("name", ARCHS)
def test_weight_round_trip_is_exact(name):
    ref = _reference(name, "cf8")
    cfg = _configs(name, "cf8")[1]
    model = params_from_reference(registry.get_model(cfg, device="cpu"), ref["tree"])
    want, back = _flat(ref["tree"]), _flat(params_to_reference(model))
    assert list(back) == list(want)
    for path, a in want.items():
        assert a.dtype == back[path].dtype and np.array_equal(a, back[path]), path
    if cfg.n_layers > 1:  # layers land unstacked, in order
        first = params.tree_paths(model.spec())[-1][0]
        if first[0] in params.STACKED:
            np.testing.assert_array_equal(model.leaf(first)[1].detach().numpy(),
                                          params.get_path(ref["tree"], first)[1])


def test_params_from_reference_refuses_a_wrong_shape():
    ref = _reference("qwen3-1.7b", "cf8")
    tree = jax.tree.map(lambda a: a, ref["tree"])
    tree["final_norm"]["scale"] = np.ones(3, np.float32)
    model = registry.get_model(_configs("qwen3-1.7b", "cf8")[1], device="cpu")
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(model, tree)


def test_init_follows_the_reference_law():
    cfg = registry.get_config("deepseek-moe-16b").reduced()
    spec = registry.model_spec(cfg)
    tree = params.init_params(spec, torch.Generator().manual_seed(3), device="cpu")
    model = registry.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    again = registry.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    other = registry.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    for path, leaf in params.tree_paths(spec):
        t = params.get_path(tree, path)
        assert t.dtype == torch.float32 and tuple(t.shape) == leaf.shape
        got = model.leaf(path)
        got = torch.stack(got) if isinstance(got, list) else got
        assert torch.equal(got, t), path  # the module draws as init_params
        if leaf.init != "normal":
            assert torch.all(t == (1.0 if leaf.init == "ones" else 0.0))
            continue
        fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
        if t.numel() >= 4096:  # fan_in from the stacked leaf, as the reference
            assert abs(t.std().item() * math.sqrt(fan_in) - 1.0) < 0.1, path
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    assert not all(torch.equal(a, b) for a, b in zip(model.parameters(), other.parameters()))
    bf = registry.get_model(cfg, device="cpu", dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())


# ----------------------------------------------------------------- models --

@pytest.mark.parametrize("name", ARCHS)
def test_forward_equals_reference(name):
    cfg, model, ref = _port(name)
    logits, aux = _forward(model, cfg, ref["tokens"], ref["extra"])
    n_pre = cfg.frontend_tokens if cfg.frontend == "patch" else 0
    assert logits.shape == (B, S + n_pre, cfg.vocab_padded)
    np.testing.assert_allclose(logits, ref["logits"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, ref["aux"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", MOE)
def test_moe_drops_and_padded_groups_equal_reference(name):
    cfg, model, ref = _port(name, "cf1.25")
    assert cfg.capacity_factor == 1.25 and (B * S) % cfg.moe_group_size
    logits, aux = _forward(model, cfg, ref["tokens"], ref["extra"])
    np.testing.assert_allclose(logits, ref["logits"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, ref["aux"], rtol=RTOL, atol=ATOL)
    roomy = params_from_reference(
        registry.get_model(dataclasses.replace(cfg, capacity_factor=8.0), device="cpu"),
        ref["tree"])
    no_drops, _ = _forward(roomy, roomy.cfg, ref["tokens"], ref["extra"])
    assert not np.allclose(logits, no_drops, rtol=RTOL, atol=ATOL)  # tokens were dropped


@pytest.mark.parametrize("name", ARCHS)
def test_decode_equals_reference_forward(name):
    cfg, model, ref = _port(name)
    cache = _cache(model, cfg, ref["extra"])
    got = []
    with torch.no_grad():
        for t in range(S):
            logits, cache = model.decode_step(cache, torch.from_numpy(ref["tokens"][:, t:t + 1]))
            got.append(logits[:, 0].numpy())
    assert int(cache["pos"][0]) == S
    np.testing.assert_allclose(np.stack(got, axis=1), ref["text_logits"], rtol=DEC_TOL,
                               atol=DEC_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_serve_tokens_equal_reference(name):
    cfg, model, ref = _port(name)
    cache = _cache(model, cfg, ref["extra"])
    tokens = torch.from_numpy(ref["tokens"])
    with torch.no_grad():
        for t in range(PROMPT - 1):
            _, cache = model.decode_step(cache, tokens[:, t:t + 1])
    step = make_serve_step(model)
    nxt, got, logits = tokens[:, PROMPT - 1:PROMPT], [], []
    for _ in range(8):
        nxt, lg, cache = step(cache, nxt)
        got.append(nxt.numpy())
        logits.append(lg[:, -1].numpy())
    logits = np.stack(logits, axis=1)
    masked = logits[..., :cfg.vocab_size]
    top2 = np.sort(masked, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert np.all(gap > ATOL + RTOL * np.abs(top2[..., 1])), gap.min()
    np.testing.assert_array_equal(np.concatenate(got, axis=1), ref["serve_tokens"])
    np.testing.assert_allclose(logits, ref["serve_logits"], rtol=DEC_TOL, atol=DEC_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_fn_equals_reference(name):
    cfg, model, ref = _port(name)
    got = make_prefill_fn(model)(torch.from_numpy(ref["tokens"]),
                                 *[torch.from_numpy(e) for e in ref["extra"]])
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=RTOL, atol=ATOL)


def test_sampled_serve_masks_the_padded_vocab_and_repeats_under_a_seed():
    cfg = registry.get_config("qwen3-1.7b").reduced()
    assert cfg.vocab_padded > cfg.vocab_size
    model = registry.get_model(cfg, device="cpu")

    def run(seed, temperature):
        gen = torch.Generator().manual_seed(seed)
        step = make_serve_step(model, temperature=temperature, generator=gen)
        cache = model.init_cache(4, 16, dtype=torch.float32)
        nxt, out = torch.zeros((4, 1), dtype=torch.long), []
        for _ in range(16):
            nxt, logits, cache = step(cache, nxt)
            assert nxt.shape == (4, 1) and logits.shape == (4, 1, cfg.vocab_padded)
            out.append(nxt)
        return torch.cat(out, dim=1)

    # at a temperature of 1e4 the logits hardly matter: unmasked, ~3/4 of
    # the draws would land in the padded slots
    hot = run(0, 1e4)
    assert int(hot.min()) >= 0 and int(hot.max()) < cfg.vocab_size
    assert len(torch.unique(hot)) > 20
    assert torch.equal(run(0, 1e4), hot) and not torch.equal(run(1, 1e4), hot)
    assert torch.equal(run(5, 1.0), run(5, 1.0))


def test_hybrid_window_vs_full_differ():
    cfg, model, ref = _port("hymba-1.5b")
    full = dataclasses.replace(cfg, attn_window=0, global_attn_layers=())
    model_full = params_from_reference(registry.get_model(full, device="cpu"), ref["tree"])
    a, _ = _forward(model, cfg, ref["tokens"], ())
    b, _ = _forward(model_full, full, ref["tokens"], ())
    assert not np.allclose(a, b)


# ------------------------------------------------------------- primitives --

def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal,window,q_offset,h,kh,sq,sk,block_k", [
    (True, 0, 0, 4, 2, 40, 40, 16),    # grouped heads, Sk % block_k != 0
    (True, 8, 0, 4, 1, 37, 37, 16),    # sliding window
    (True, 0, 20, 6, 3, 5, 25, 8),     # q_offset (chunked prefill)
    (True, 6, 17, 2, 2, 8, 25, 512),   # window + offset, one block
    (False, 0, 0, 4, 4, 7, 50, 512),   # cross attention
])
def test_blockwise_attention_equals_reference(causal, window, q_offset, h, kh, sq, sk, block_k):
    rng = np.random.default_rng(h * 100 + sk)
    q, k, v = _np(rng, 2, sq, h, 16), _np(rng, 2, sk, kh, 16), _np(rng, 2, sk, kh, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_k=block_k)
    want = np.asarray(jax_layers.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw))
    got = layers.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("inclusive,bonus,state0,log_decay,t,chunk", [
    (False, True, False, "mild", 37, 16),
    (True, False, True, "mild", 40, 8),
    (False, True, True, "strong", 23, 8),
    (True, False, False, "strong", 19, 64),
    (True, False, True, "per_head", 29, 8),
])
def test_chunked_decay_attention_equals_reference(inclusive, bonus, state0, log_decay, t, chunk):
    rng = np.random.default_rng(t)
    b, h, dk, dv = 2, 3, 8, 4
    r, k, v = _np(rng, b, t, h, dk), _np(rng, b, t, h, dk), _np(rng, b, t, h, dv)
    if log_decay == "per_head":  # SSD: scalar decay a head, broadcast over Dk
        logw = -np.abs(_np(rng, b, t, h, 1))
    else:
        logw = -rng.uniform(0.0, 1.0, (b, t, h, dk)).astype(np.float32)
        if log_decay == "strong":
            logw = logw - 20.0
    u = _np(rng, h, dk) if bonus else None
    s0 = _np(rng, b, h, dk, dv) if state0 else None
    kw = dict(chunk=chunk, inclusive=inclusive)
    jargs = [None if a is None else jnp.asarray(a) for a in (r, k, v, logw, u, s0)]
    targs = [None if a is None else torch.from_numpy(a) for a in (r, k, v, logw, u, s0)]
    want_out, want_state = jax_ssm.chunked_decay_attention(*jargs, **kw)
    got_out, got_state = ssm.chunked_decay_attention(*targs, **kw)
    assert np.all(np.isfinite(got_out.numpy()))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bonus", [True, False])
def test_decay_attention_step_equals_reference(bonus):
    rng = np.random.default_rng(7)
    r, k, logw = _np(rng, 2, 3, 8), _np(rng, 2, 3, 8), -np.abs(_np(rng, 2, 3, 8))
    v, state = _np(rng, 2, 3, 4), _np(rng, 2, 3, 8, 4)
    u = _np(rng, 3, 8) if bonus else None
    want = jax_ssm.decay_attention_step(
        *[None if a is None else jnp.asarray(a) for a in (r, k, v, logw, u, state)])
    got = ssm.decay_attention_step(
        *[None if a is None else torch.from_numpy(a) for a in (r, k, v, logw, u, state)])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 3])
def test_decode_attention_uniform_and_ragged_paths_agree(window):
    cfg = registry.get_config("qwen3-1.7b").reduced()
    ref = _reference("qwen3-1.7b", "cf8")
    lp = jax.tree.map(lambda a: a[0], ref["tree"]["layers"]["attn"])
    attn = {k: torch.tensor(a) for k, a in lp.items()}
    rng = np.random.default_rng(window)
    x, ck, cv = _np(rng, 3, 1, cfg.d_model), _np(rng, 3, 12, 2, 16), _np(rng, 3, 12, 2, 16)
    pos = np.full((3,), 7, np.int32)
    outs = []
    for uniform in (True, False):
        k_t, v_t = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        o, k_t, v_t = layers.decode_attention(attn, torch.from_numpy(x), k_t, v_t,
                                              torch.from_numpy(pos).long(), cfg, window=window,
                                              uniform_pos=uniform)
        outs.append((o.numpy(), k_t.numpy(), v_t.numpy()))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    want = jax_layers.decode_attention(lp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(pos), cfg, window=window)
    for a, b in zip(outs[0], want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    ragged = np.array([2, 7, 11], np.int32)  # each row at its own step
    k_t, v_t = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    o, k_t, v_t = layers.decode_attention(attn, torch.from_numpy(x), k_t, v_t,
                                          torch.from_numpy(ragged).long(), cfg, window=window,
                                          uniform_pos=False)
    want = jax_layers.decode_attention(lp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(ragged), cfg, window=window, uniform_pos=False)
    for a, b in zip((o, k_t, v_t), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
