"""The LLM scaffold's serving path on the card, against the port's CPU path.

For every architecture at its reduced configuration (capacity factor 8,
and the MoE architectures also at their own 1.25 with padded groups), in
float32 with TF32 off: parameters made once on the CPU from a seed and
copied to the card;

* ``forward`` logits and aux on the card against the CPU at rtol 1e-4,
  atol 1e-4;
* teacher-forced ``decode_step`` on the card against the card's own
  ``forward`` at 2e-3 (the reference's ``tests/test_models.py``);
* greedy ``make_serve_step`` tokens over 8 steps equal to the CPU path's,
  each step's top-2 gap above the logits tolerance.

Skipped without a CUDA device: the fixtures decide, not the import.  Run
on the card with ``PYTHONPATH=src python -m pytest -q
tests/test_torch_models_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import registry  # noqa: E402
from repro_torch.models.encdec import enc_len_for  # noqa: E402
from repro_torch.serve.serve_step import make_serve_step  # noqa: E402

pytestmark = pytest.mark.cuda

B, S = 2, 24
PROMPT = S - 8
RTOL = ATOL = 1e-4
DEC_TOL = 2e-3
MOE = ["arctic-480b", "deepseek-moe-16b"]
CASES = [(n, 8.0) for n in registry.list_archs()] + [(n, 1.25) for n in MOE]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _config(name, capacity):
    cfg = registry.get_config(name).reduced(capacity_factor=capacity)
    return cfg if capacity == 8.0 else dataclasses.replace(cfg, moe_group_size=20)


def _inputs(cfg):
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    n = enc_len_for(S) if cfg.n_encoder_layers else cfg.frontend_tokens
    extra = ()
    if n:
        extra = (torch.from_numpy(
            (0.1 + 0.01 * rng.standard_normal((B, n, cfg.d_model))).astype(np.float32)),)
    return tokens, extra


def _pair(cfg, dev):
    cpu = registry.get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = registry.get_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _forward(model, cfg, tokens, extra, text_only=False):
    dev = model.device
    tokens = tokens.to(dev)
    extra = [e.to(dev) for e in extra]
    with torch.inference_mode():
        if cfg.frontend_tokens:
            out = model.forward(tokens) if text_only else model.forward(tokens, extra[0])
        else:
            out = model.forward(tokens, *extra)
    return out[0].cpu(), float(out[1])


def _cache(model, cfg, extra):
    if cfg.n_encoder_layers:
        cache = model.init_cache(B, S, dtype=torch.float32, enc_len=enc_len_for(S))
        with torch.inference_mode():
            return model.prefill_encoder(cache, extra[0].to(model.device))
    return model.init_cache(B, S, dtype=torch.float32)


def _serve(model, cfg, tokens, extra):
    cache = _cache(model, cfg, extra)
    tokens = tokens.to(model.device)
    with torch.inference_mode():
        for t in range(PROMPT - 1):
            _, cache = model.decode_step(cache, tokens[:, t:t + 1])
    step = make_serve_step(model)
    nxt, out, logits = tokens[:, PROMPT - 1:PROMPT], [], []
    for _ in range(8):
        nxt, lg, cache = step(cache, nxt)
        out.append(nxt)
        logits.append(lg[:, -1, :cfg.vocab_size])
    return torch.cat(out, dim=1).cpu(), torch.stack(logits, dim=1).cpu()


@pytest.mark.parametrize("name,capacity", CASES)
def test_forward_on_the_card_equals_the_cpu_path(dev, name, capacity):
    cfg = _config(name, capacity)
    cpu, card = _pair(cfg, dev)
    tokens, extra = _inputs(cfg)
    want, want_aux = _forward(cpu, cfg, tokens, extra)
    got, got_aux = _forward(card, cfg, tokens, extra)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_aux, want_aux, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", registry.list_archs())
def test_decode_on_the_card_equals_its_forward(dev, name):
    cfg = _config(name, 8.0)
    _, card = _pair(cfg, dev)
    tokens, extra = _inputs(cfg)
    want, _ = _forward(card, cfg, tokens, extra, text_only=True)
    cache = _cache(card, cfg, extra)
    got = []
    with torch.inference_mode():
        for t in range(S):
            logits, cache = card.decode_step(cache, tokens[:, t:t + 1].to(dev))
            got.append(logits[:, 0].cpu())
    assert int(cache["pos"][0]) == S
    np.testing.assert_allclose(torch.stack(got, dim=1).numpy(), want.numpy(), rtol=DEC_TOL,
                               atol=DEC_TOL)


@pytest.mark.parametrize("name", registry.list_archs())
def test_greedy_serve_on_the_card_equals_the_cpu_path(dev, name):
    cfg = _config(name, 8.0)
    cpu, card = _pair(cfg, dev)
    tokens, extra = _inputs(cfg)
    got, _ = _serve(card, cfg, tokens, extra)
    want, logits = _serve(cpu, cfg, tokens, extra)
    top2 = logits.topk(2, dim=-1).values  # no near-tie decides a step
    assert bool(((top2[..., 0] - top2[..., 1]) > ATOL + RTOL * top2[..., 0].abs()).all())
    assert torch.equal(got, want)
    assert int(got.max()) < cfg.vocab_size
