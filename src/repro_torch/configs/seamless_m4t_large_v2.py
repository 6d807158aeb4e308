"""seamless-m4t-large-v2 -- enc-dec multimodal (audio frontend stubbed).
[arXiv:2308.11596; hf]
24L decoder + 24L encoder, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
The speech frontend is a stub: input_specs() provides precomputed frame
embeddings (B, seq//4, d)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_act="gelu",
    frontend="frames",
)
