"""Model/run configuration system of the LLM scaffold.

The port's own copy of the reference's ``configs/base.py``: every field,
default and property is the reference's, and the tests hold them equal.
One frozen dataclass covers all 10 assigned architecture families (dense,
MoE, SSM, hybrid, enc-dec, VLM/audio backbones).  Architecture configs live
in ``repro_torch/configs/<arch>.py`` (exact public hyper-parameters);
input-shape configs in ``repro_torch/configs/shapes.py``;
``models.registry.get_config`` resolves ``--arch`` names.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- layer variations -------------------------------------------------
    mlp_act: str = "swiglu"  # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_residual_ff: int = 0  # arctic-style parallel dense FFN
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    moe_group_size: int = 512  # tokens per dispatch group (cost ~ linear)

    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    attn_window: int = 0  # 0 = full attention
    global_attn_layers: tuple = ()  # hybrid: layers with full attention

    # --- enc-dec ------------------------------------------------------------
    n_encoder_layers: int = 0

    # --- modality frontend (STUB: precomputed embeddings via input_specs) ---
    frontend: str = "none"  # none | patch(vision) | frames(audio)
    frontend_tokens: int = 0

    # --- numerics / training ------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    zloss: float = 1e-4

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, (self.name, "GQA group")

    @property
    def vocab_padded(self) -> int:
        """Embedding-table size padded for even sharding (512 | 16*32)."""
        return -(-self.vocab_size // 512) * 512

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state => can run the long_500k shape."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.attn_window > 0:
            return True
        return False

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.family == "ssm":
            # rwkv6: time-mix (r,k,v,w,g,o ~ 6 d^2) + channel-mix
            attn = 6 * d * d
        mlp_mult = 3 if self.mlp_act == "swiglu" else 2
        dense_mlp = mlp_mult * d * self.d_ff
        per_layer = attn + dense_mlp
        if self.n_experts:
            expert = mlp_mult * d * self.moe_d_ff
            per_layer = attn + self.n_experts * expert + self.n_shared_experts * expert
            if self.dense_residual_ff:
                per_layer += mlp_mult * d * self.dense_residual_ff
            per_layer += d * self.n_experts  # router
        if self.family == "hybrid":
            di = self.ssm_expand * d
            per_layer += 2 * d * di + di * d + di * (2 * self.ssm_state + 1)
        total = L * per_layer + self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + dense_mlp + attn // 2)
        return int(total)

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k only)."""
        if not self.n_experts:
            return self.n_params
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        mlp_mult = 3 if self.mlp_act == "swiglu" else 2
        expert = mlp_mult * d * self.moe_d_ff
        per_layer = attn + (self.n_experts_per_token + self.n_shared_experts) * expert
        if self.dense_residual_ff:
            per_layer += mlp_mult * d * self.dense_residual_ff
        per_layer += d * self.n_experts
        total = L * per_layer + 2 * self.vocab_size * d
        return int(total)

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_heads % 2 == 0 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=128,
            scan_layers=self.scan_layers,
            dtype="float32",  # CPU smoke tests stay in f32
        )
        if self.n_experts:
            small.update(n_experts=4, n_experts_per_token=min(2, self.n_experts_per_token),
                         n_shared_experts=min(1, self.n_shared_experts), moe_d_ff=64,
                         dense_residual_ff=64 if self.dense_residual_ff else 0)
        if self.ssm_state:
            small.update(ssm_state=4)
        if self.n_encoder_layers:
            small.update(n_encoder_layers=2)
        if self.attn_window:
            small.update(attn_window=16)
        if self.global_attn_layers:
            small.update(global_attn_layers=(0,))
        if self.frontend_tokens:
            small.update(frontend_tokens=8)
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


@dataclass(frozen=True)
class RunConfig:
    """Launcher-level knobs (mesh, optimizer, fault tolerance)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    schedule: str = "wsd"  # wsd | cosine | constant
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatch: int = 0  # 0 = no gradient accumulation
    steps: int = 100
    seed: int = 0
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    grad_compression: str = "none"  # none | int8
    async_checkpoint: bool = True
    # Hoist the FSDP weight all-gather out of the gradient-accumulation
    # loop: constrain params to a data-replicated layout ONCE before the
    # microbatch scan; the constraint's transpose is a single grad
    # reduce-scatter after it.  Collectives go from A + b*W to A + W
    # (see EXPERIMENTS.md §Perf/2 it.3).  Costs one replicated f32 copy of
    # the weights + grads in HBM, so off for memory-tight giants.
    gather_weights_once: bool = False
