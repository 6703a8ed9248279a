"""Jamba-v0.1 (52B total) [arXiv:2403.19887] — hybrid Mamba + attention
1:7, MoE.

32L d_model=4096; an attention layer every 8 (offset 4) with GQA kv=8;
MoE with 16 experts top-2 every other layer (offset 1); d_ff=14336;
vocab=65536; no positional encoding.

As in the JAX package, every SSM layer is the SSD (Mamba2) mixer where
Jamba's own is Mamba-1 (state-space duality makes the two interchangeable
at this granularity).  ``MoEConfig.layout`` is kept as the JAX package
sets it and read by nothing until the multi-device slice.
"""

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_layer_period=8,
    attn_layer_offset=4,
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff_expert=14336,
                  layout="unconstrained"),
    moe_layer_period=2,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, n_groups=1,
                  conv_kernel=4, chunk_size=128),
    pos_embedding="none",    # Jamba uses no positional encoding
    source="arXiv:2403.19887 (Jamba)",
)
