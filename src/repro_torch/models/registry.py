"""Architecture registry: ``--arch <id>`` -> (config, model)."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import ModelConfig

ARCHS = {
    "rwkv6-1.6b": "rwkv6_1p6b",
    "arctic-480b": "arctic_480b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "hymba-1.5b": "hymba_1p5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-1.7b": "qwen3_1p7b",
    "minicpm-2b": "minicpm_2b",
    "granite-3-2b": "granite_3_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "internvl2-26b": "internvl2_26b",
}


def list_archs():
    return sorted(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def model_class(cfg: ModelConfig):
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.rwkv6 import RWKV6
    from repro_torch.models.transformer import Decoder

    if cfg.family == "ssm":
        return RWKV6
    if cfg.family in ("audio", "encdec"):
        return EncDec
    return Decoder  # dense | moe | hybrid | vlm


def model_spec(cfg: ModelConfig) -> dict:
    """The spec of ``cfg``'s model (layers stacked), with no allocation."""
    return model_class(cfg).build_spec(cfg)


def get_model(cfg: ModelConfig, device=None, dtype=torch.float32, generator=None):
    """``cfg``'s model with its parameters in ``dtype`` on ``device``
    (default ``'cuda'``; raises without a card unless ``device='cpu'``),
    drawn from ``generator`` (default: one seeded 0 on that device).  On
    ``device='meta'`` it holds no parameters: the model to lay out over a
    mesh from a seed or a checkpoint (``models/tensor_parallel.lay_out``,
    ``train/trainer.Trainer``)."""
    return model_class(cfg)(cfg, device=device, dtype=dtype, generator=generator)
