"""Mixtral-8x7B [arXiv:2401.04088] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, SWA 4096.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff_expert=14336),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088 (Mixtral of Experts)",
)
