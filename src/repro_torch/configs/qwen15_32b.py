"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family card] — dense MHA, QKV bias.

64L d_model=5120 40H (kv=40, MHA) d_ff=27392 vocab=152064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B (family card)",
)
