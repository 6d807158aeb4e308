"""arctic-480b -- 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    n_experts_per_token=2,
    moe_d_ff=4864,
    dense_residual_ff=4864,  # arctic's parallel dense residual path
    capacity_factor=1.25,
)
