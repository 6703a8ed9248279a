"""Model configuration for every architecture family in the zoo (a copy of
``repro.models.config``; the port runs the dense, MoE, SSM and hybrid
families).

A single frozen dataclass describes dense, MoE, SSM (Mamba2), hybrid (Jamba),
encoder-decoder (Whisper) and VLM-backbone (Qwen2-VL) models.  Family-specific
fields default to "off" so that a dense config stays small.

Every architecture in ``repro_torch.configs`` instantiates exactly one of
these; reduced smoke variants use ``ModelConfig.reduced()``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (Mixtral / DeepSeek-V3 / Jamba style)."""

    num_experts: int = 0            # routed experts
    experts_per_token: int = 0      # top-k
    num_shared_experts: int = 0     # DeepSeek shared expert(s), always active
    d_ff_expert: int = 0            # per-expert FFN hidden size
    capacity_factor: float = 1.25   # static capacity for sort-based dispatch
    router_aux_loss_coef: float = 0.01
    router_dtype: str = "float32"
    # expert-parallel layout: "auto" (batch over data, experts over model
    # where divisible), "ep_full" (experts over model x data, batch
    # replicated in the dispatch buffer), "unconstrained" (GSPMD decides)
    layout: str = "auto"

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    d_state: int = 0
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk_size: int = 128           # SSD chunk length (MXU-aligned)
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def enabled(self) -> bool:
        return self.d_state > 0

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention settings."""

    q_lora_rank: int = 0            # 0 => dense q projection
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default: d_model // num_heads

    # --- attention flavour -------------------------------------------------
    attention: str = "gqa"          # gqa | mla | none
    sliding_window: int = 0         # >0 => SWA (Mixtral)
    qkv_bias: bool = False          # Qwen-style QKV bias
    mla: MLAConfig = field(default_factory=MLAConfig)

    # --- positional encoding ----------------------------------------------
    pos_embedding: str = "rope"     # rope | mrope | sinusoidal | learned
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE (t,h,w) section split

    # --- FFN ----------------------------------------------------------------
    mlp_activation: str = "silu"    # silu (SwiGLU) | gelu (plain)
    moe: MoEConfig = field(default_factory=MoEConfig)
    moe_layer_period: int = 0       # every Nth layer is MoE (Jamba: 2); 0=all
    first_dense_layers: int = 0     # DeepSeek-V3: first k layers stay dense

    # --- SSM / hybrid -------------------------------------------------------
    ssm: SSMConfig = field(default_factory=SSMConfig)
    attn_layer_period: int = 0      # Jamba: 1 attention layer every N (8)
    attn_layer_offset: int = 0      # index of the attention layer in a period

    # --- encoder-decoder ----------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0        # whisper: 1500 frames
    max_target_positions: int = 0   # whisper decoder: 448

    # --- multimodal frontend stub -------------------------------------------
    frontend: Optional[str] = None  # vision_stub | audio_stub | None

    # --- extras ---------------------------------------------------------------
    mtp_depth: int = 0              # DeepSeek multi-token-prediction depth
    mtp_loss_coef: float = 0.1
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    max_seq_len: int = 131_072

    # --- dtypes ---------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- layout ---------------------------------------------------------------
    # Megatron-style vocab padding: embedding/lm-head vocab dim rounds up
    # to this multiple so vocab-parallel sharding divides any TP extent
    # (<=128).  The parameter layout keeps it so bridged weights line up
    # with the JAX package.  Padded ids are masked to -1e30 in lm_logits;
    # 0 disables.
    vocab_pad_multiple: int = 128

    # --- citation -------------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.num_heads

    def layer_kind(self, i: int) -> str:
        """Return 'attn' or 'ssm' for decoder layer ``i`` (hybrid interleave)."""
        if self.arch_type == "ssm":
            return "ssm"
        if self.attn_layer_period > 0:
            return ("attn" if i % self.attn_layer_period == self.attn_layer_offset
                    else "ssm")
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if not self.moe.enabled:
            return False
        if i < self.first_dense_layers:
            return False
        if self.moe_layer_period > 0:
            return i % self.moe_layer_period == (self.moe_layer_period - 1)
        return True

    # ---------------------------------------------------------------- counting
    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        if m <= 0:
            return self.vocab_size
        return -(-self.vocab_size // m) * m

    def param_count(self) -> int:
        """Exact parameter count (used for 6·N·D roofline bookkeeping)."""
        from repro_torch.models import params as P
        return P.count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models import params as P
        return P.count_params(self, active_only=True)

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                vocab_size: int = 512, max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (CPU-runnable)."""
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        head_dim = max(16, d_model // heads)
        changes = dict(
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=2 * d_model if self.d_ff else 0,
            vocab_size=vocab_size,
            max_seq_len=4096,
        )
        if self.moe.enabled:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, max_experts),
                experts_per_token=min(self.moe.experts_per_token, 2),
                d_ff_expert=2 * d_model,
            )
        if self.ssm.enabled:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=32, head_dim=32, chunk_size=32)
        if self.mla.enabled:
            changes["mla"] = MLAConfig(
                q_lora_rank=0, kv_lora_rank=64,
                qk_nope_head_dim=head_dim, qk_rope_head_dim=head_dim // 2,
                v_head_dim=head_dim)
        if self.attn_layer_period > 0:
            # keep an attn layer inside the reduced stack
            changes["attn_layer_period"] = num_layers
            changes["attn_layer_offset"] = num_layers - 1
        if self.moe_layer_period > 0:
            changes["moe_layer_period"] = 2
        if self.first_dense_layers > 0:
            changes["first_dense_layers"] = 1
        if self.is_encoder_decoder:
            changes["encoder_layers"] = num_layers
            changes["encoder_seq_len"] = 64
            changes["max_target_positions"] = 64
        if self.mtp_depth > 0:
            changes["mtp_depth"] = 1
        if self.mrope_sections:
            changes["mrope_sections"] = (head_dim // 4, head_dim // 8,
                                         head_dim // 8)
        return dataclasses.replace(self, **changes)

    def validate(self) -> None:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        if self.attention == "mla":
            assert self.mla.enabled
        if self.arch_type == "ssm":
            assert self.ssm.enabled and self.attention in ("none", "gqa")
        if self.arch_type == "hybrid":
            assert self.ssm.enabled and self.attn_layer_period > 0
        if self.pos_embedding == "mrope":
            assert sum(self.mrope_sections) * 2 == self.resolved_head_dim, (
                self.mrope_sections, self.resolved_head_dim)
