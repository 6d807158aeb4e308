"""internvl2-26b -- InternViT (stubbed patch frontend) + InternLM2 backbone.
[arXiv:2404.16821; hf]
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The vision frontend is a stub: input_specs() provides precomputed patch
embeddings (B, 1024, d) prepended to the text sequence."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    frontend="patch",
    frontend_tokens=1024,
)
