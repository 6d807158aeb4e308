"""The six architectures that phase 19 serves at full size, against the JAX package, on the CPU.

deepseek-moe-16b, granite-3-2b, minicpm-2b, nemotron-4-15b, rwkv6-1.6b and
seamless-m4t-large-v2, each at ``reduced()`` widths and 3 layers but with
the architecture's **own vocabulary** (49,155 to 256,206 words), so its
own ``vocab_padded`` and padded slots: the head and the masking that
``chip_smoke.py`` phase 19 runs at full size on the card.  The weights are
the reference's ``model.init`` carried over with ``params_from_reference``;
the inputs are seeded numpy.  Held, at ``tests/test_torch_models.py``'s
tolerances:

* the forward's logits (B, S, vocab_padded) at rtol 1e-4, atol 1e-4;
* teacher-forced ``decode_step`` against the JAX forward at 2e-3;
* 8 greedy serve tokens exactly (each step's top-2 gap above the logits
  tolerance), and their logits at 2e-3;
* ``make_prefill_fn``;
* no greedy or sampled token of either package at or past ``vocab_size``.

An MoE model runs at capacity 8, which drops no token, as phase 19 gates
it.  The sampler: Gumbel-max from a ``torch.Generator`` cannot draw
``jax.random.categorical``'s tokens, but both draw from one law; 20,000
draws of each on fixed logits with padded slots are held to softmax(x / T)
by a chi-square bound at p = 1e-4.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.models import registry as jax_registry  # noqa: E402
from repro.models.encdec import EncDec as JaxEncDec  # noqa: E402
from repro.serve import serve_step as jax_serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.encdec import EncDec, enc_len_for  # noqa: E402
from repro_torch.serve.serve_step import make_prefill_fn, make_serve_step  # noqa: E402

ARCHS = ["deepseek-moe-16b", "granite-3-2b", "minicpm-2b", "nemotron-4-15b", "rwkv6-1.6b",
         "seamless-m4t-large-v2"]
B, S = 2, 24
PROMPT = S - 8  # a 16-token prompt, then 8 serve steps
LAYERS = 3
RTOL = ATOL = 1e-4  # forward
DEC_TOL = 2e-3  # decode against forward: the reference's own
HOT = 1e4  # a temperature at which the logits hardly matter: the padded slots would win
N_DRAWS = 20_000
P_VALUE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These models are small: one intra-op thread runs them about as fast
    alone, and the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow(get_config, name):
    """``name`` at reduced widths and ``LAYERS`` layers, its vocabulary its
    own; an MoE model at capacity 8."""
    cfg = get_config(name)
    over = dict(n_layers=LAYERS, vocab_size=cfg.vocab_size)
    if cfg.n_experts:
        over["capacity_factor"] = 8.0
    if cfg.n_encoder_layers:
        over["n_encoder_layers"] = LAYERS
    return cfg.reduced(**over)


def _inputs(cfg):
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if not cfg.n_encoder_layers:
        return tokens, ()
    frames = 0.1 + 0.01 * rng.standard_normal((B, enc_len_for(S), cfg.d_model))
    return tokens, (frames.astype(np.float32),)


def _jax_cache(model, tree, extra):
    if isinstance(model, JaxEncDec):
        cache = model.init_cache(B, S, dtype=jnp.float32, enc_len=enc_len_for(S))
        return jax.jit(model.prefill_encoder)(tree, cache, extra[0])
    return model.init_cache(B, S, dtype=jnp.float32)


def _jax_serve(proxy, model, tree, tokens, extra, temperature):
    """8 serve steps of the JAX package after the prompt: (tokens, logits)."""
    cache = _jax_cache(model, tree, extra)
    for t in range(PROMPT - 1):
        _, cache = proxy.decode_step(tree, cache, tokens[:, t:t + 1])
    step = jax.jit(jax_serve.make_serve_step(proxy, temperature=temperature))
    nxt, toks, logits = tokens[:, PROMPT - 1:PROMPT], [], []
    for k in range(8):
        nxt, lg, cache = step(tree, cache, nxt, jax.random.PRNGKey(k))
        toks.append(np.asarray(nxt))
        logits.append(np.asarray(lg[:, -1]))
    return np.concatenate(toks, axis=1), np.stack(logits, axis=1)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's weights and outputs for one architecture: the
    forward, the prefill fn, 8 greedy serve steps and 8 hot sampled ones."""
    jcfg = _narrow(jax_registry.get_config, name)
    model = jax_registry.get_model(jcfg)
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    tokens, extra = _inputs(jcfg)
    fwd = jax.jit(model.forward)
    proxy = types.SimpleNamespace(cfg=jcfg, forward=fwd, decode_step=jax.jit(model.decode_step))
    out = dict(tree=tree, tokens=tokens, extra=extra,
               logits=np.asarray(fwd(tree, tokens, *extra)[0]),
               prefill=np.asarray(jax_serve.make_prefill_fn(proxy)(tree, tokens, *extra)))
    out["serve_tokens"], out["serve_logits"] = _jax_serve(proxy, model, tree, tokens, extra, 0.0)
    out["hot_tokens"], _ = _jax_serve(proxy, model, tree, tokens, extra, HOT)
    return out


def _port(name):
    ref = _reference(name)
    cfg = _narrow(registry.get_config, name)
    return cfg, params_from_reference(registry.get_model(cfg, device="cpu"), ref["tree"]), ref


def _cache(model, extra):
    if isinstance(model, EncDec):
        cache = model.init_cache(B, S, dtype=torch.float32, enc_len=enc_len_for(S))
        return model.prefill_encoder(cache, torch.from_numpy(extra[0]))
    return model.init_cache(B, S, dtype=torch.float32)


def _serve(model, ref, **sampling):
    """8 serve steps of the port after the prompt: (tokens, logits)."""
    cache = _cache(model, ref["extra"])
    tokens = torch.from_numpy(ref["tokens"]).long()
    with torch.no_grad():
        for t in range(PROMPT - 1):
            _, cache = model.decode_step(cache, tokens[:, t:t + 1])
    step = make_serve_step(model, **sampling)
    nxt, toks, logits = tokens[:, PROMPT - 1:PROMPT], [], []
    for _ in range(8):
        nxt, lg, cache = step(cache, nxt)
        toks.append(nxt.numpy())
        logits.append(lg[:, -1].numpy())
    assert int(cache["pos"][0]) == PROMPT - 1 + 8
    return np.concatenate(toks, axis=1), np.stack(logits, axis=1)


def test_the_six_keep_their_own_padded_vocabularies():
    padded = {name: _narrow(registry.get_config, name).vocab_padded for name in ARCHS}
    assert padded == {name: registry.get_config(name).vocab_padded for name in ARCHS}
    assert padded == {name: _narrow(jax_registry.get_config, name).vocab_padded
                      for name in ARCHS}
    # granite, minicpm and seamless have padded slots; the others' vocabularies are multiples of 512
    assert sorted(n for n in ARCHS if padded[n] > registry.get_config(n).vocab_size) == \
        ["granite-3-2b", "minicpm-2b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("name", ARCHS)
def test_forward_equals_reference(name):
    cfg, model, ref = _port(name)
    with torch.no_grad():
        logits, _ = model.forward(torch.from_numpy(ref["tokens"]),
                                  *[torch.from_numpy(e) for e in ref["extra"]])
    assert tuple(logits.shape) == (B, S, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_equals_reference_forward(name):
    _, model, ref = _port(name)
    cache = _cache(model, ref["extra"])
    got = []
    with torch.no_grad():
        for t in range(S):
            logits, cache = model.decode_step(cache, torch.from_numpy(ref["tokens"][:, t:t + 1]))
            got.append(logits[:, 0].numpy())
    assert int(cache["pos"][0]) == S
    np.testing.assert_allclose(np.stack(got, axis=1), ref["logits"], rtol=DEC_TOL, atol=DEC_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_serve_tokens_equal_reference(name):
    cfg, model, ref = _port(name)
    toks, logits = _serve(model, ref)
    top2 = np.sort(logits[..., :cfg.vocab_size], axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert np.all(gap > ATOL + RTOL * np.abs(top2[..., 1])), gap.min()
    np.testing.assert_array_equal(toks, ref["serve_tokens"])
    np.testing.assert_allclose(logits, ref["serve_logits"], rtol=DEC_TOL, atol=DEC_TOL)
    assert toks.max() < cfg.vocab_size


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_fn_equals_reference(name):
    _, model, ref = _port(name)
    got = make_prefill_fn(model)(torch.from_numpy(ref["tokens"]),
                                 *[torch.from_numpy(e) for e in ref["extra"]])
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_sampled_tokens_stay_in_the_vocabulary(name):
    """At a temperature where the logits hardly matter, neither package's
    draws land at or past ``vocab_size`` (unmasked, a draw would take a
    padded slot at the padded share's odds: granite 509 of 49,664, minicpm
    127 of 122,880, seamless 306 of 256,512; the sampler test below holds
    the mask where the padded slots would win), and the port's repeat under
    one seed."""
    cfg, model, ref = _port(name)
    draw = lambda seed: _serve(model, ref, temperature=HOT,  # noqa: E731
                               generator=torch.Generator().manual_seed(seed))[0]
    toks = draw(0)
    assert 0 <= toks.min() and toks.max() < cfg.vocab_size
    assert 0 <= ref["hot_tokens"].min() and ref["hot_tokens"].max() < cfg.vocab_size
    np.testing.assert_array_equal(draw(0), toks)
    assert not np.array_equal(draw(1), toks)


def test_sampler_draws_from_the_softmax_as_jax_does():
    """20,000 draws of each package's sampled serve step on fixed logits
    (12 slots, the last 3 padded and the largest, temperature 0.7), each
    held to softmax(x[:9] / 0.7) by a chi-square bound at p = 1e-4."""
    vocab, padded, temperature = 9, 12, 0.7
    x = np.random.default_rng(7).normal(size=padded).astype(np.float32)
    x[vocab:] = x.max() + 3.0  # unmasked, the padded slots would take most draws
    want = np.exp((x[:vocab] - x[:vocab].max()) / temperature)
    want /= want.sum()
    assert want.min() * N_DRAWS >= 5  # the chi-square approximation holds
    bound = stats.chi2.isf(P_VALUE, vocab - 1)

    def model(as_array):
        logits = as_array(np.broadcast_to(x, (N_DRAWS, 1, padded)).copy())
        return types.SimpleNamespace(cfg=types.SimpleNamespace(vocab_size=vocab),
                                     decode_step=lambda *a: (logits, a[-2]))

    port = make_serve_step(model(torch.from_numpy), temperature=temperature,
                           generator=torch.Generator().manual_seed(0))
    ours, _, _ = port(None, torch.zeros((N_DRAWS, 1), dtype=torch.long))
    ref = jax_serve.make_serve_step(model(jnp.asarray), temperature=temperature)
    theirs, _, _ = ref(None, None, jnp.zeros((N_DRAWS, 1), jnp.int32), jax.random.PRNGKey(0))
    for draws in (ours.numpy()[:, 0], np.asarray(theirs)[:, 0]):
        assert draws.min() >= 0 and draws.max() < vocab
        counts = np.bincount(draws, minlength=vocab)
        chi2 = float((((counts - N_DRAWS * want) ** 2) / (N_DRAWS * want)).sum())
        assert chi2 < bound, (chi2, bound, counts)
