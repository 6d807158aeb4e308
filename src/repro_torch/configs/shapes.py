"""The four assigned input-shape cells (LM-family)."""
from repro_torch.configs.base import ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}
