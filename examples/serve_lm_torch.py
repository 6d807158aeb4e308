"""Batched autoregressive serving with a KV/state cache, on the PyTorch port.

The twin of ``examples/serve_lm.py`` on ``repro_torch``: a reduced-config
model from the zoo, the prompt batch teacher-forced through the serve step
(one token a call against the cache, the cache warm-up), then the decode
loop.  Works for every family -- attention KV caches, RWKV6's constant-size
state and Hymba's hybrid window+SSM cache -- because each model implements
``init_cache`` / ``decode_step`` behind the same interface.
``--model-parallel N`` lays the model out over N slots of the device
(``models/tensor_parallel.lay_out``, every family; rwkv6's reduced config
has one head of 64 columns, which two slots would split, and raises):
the model is built on ``meta`` and each slot draws only its blocks of the
seed-0 weights, the same bits as the whole model's.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch rwkv6-1.6b --tokens 32
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --model-parallel 2

It runs on the card by default and raises without one unless ``--device
cpu``.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.dispatcher import resolve_device  # noqa: E402
from repro_torch.launch.mesh import grid_mesh  # noqa: E402
from repro_torch.models.registry import get_config, get_model, list_archs  # noqa: E402
from repro_torch.models.tensor_parallel import lay_out  # noqa: E402
from repro_torch.serve.serve_step import make_serve_step  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if args.model_parallel > 1:
        model = lay_out(get_model(cfg, device="meta"),
                        grid_mesh([dev] * args.model_parallel, args.model_parallel), seed=0)
    else:
        model = get_model(cfg, device=dev)
    B, P = args.batch, args.prompt_len
    max_len = P + args.tokens

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)).to(dev)

    cache = model.init_cache(B, max_len, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = make_serve_step(model, temperature=args.temperature, generator=gen)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # prefill: teacher-force the prompt through decode_step (cache warm-up)
    t0 = time.perf_counter()
    for i in range(P):
        _, _, cache = step(cache, prompts[:, i:i + 1])
    sync()
    t_prefill = time.perf_counter() - t0

    # decode loop
    tok = prompts[:, -1:]
    out = []
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        tok, _, cache = step(cache, tok)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    gen_tokens = torch.cat(out, dim=1).cpu().numpy()
    print(f"arch={cfg.name} family={cfg.family} batch={B} device={dev} "
          f"model_parallel={args.model_parallel}")
    print(f"prefill: {P} tokens in {t_prefill * 1e3:.1f} ms")
    print(f"decode : {args.tokens} tokens in {t_decode * 1e3:.1f} ms "
          f"({B * args.tokens / t_decode:.1f} tok/s)")
    print(f"sample row 0: {gen_tokens[0][:16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
