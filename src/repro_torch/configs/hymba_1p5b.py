"""hymba-1.5b -- parallel attention + mamba heads, mostly SWA.
[arXiv:2411.13676; hf]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Global (full) attention on layers {0, 15, 31}; the rest use a 2048-token
sliding window => bounded decode cache => runs long_500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    attn_window=2048,
    global_attn_layers=(0, 15, 31),
)
