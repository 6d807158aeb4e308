"""deepseek-moe-16b -- 2 shared + 64 routed top-6, fine-grained experts.
[arXiv:2401.06066; hf]
28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    capacity_factor=1.25,
)
