"""rwkv6-1.6b -- Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # 2048 / head_size 64
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    mlp_act="relu2",  # channel-mix squared relu
)
