"""Granite-3.0-2B-base [hf:ibm-granite/granite-3.0-2b-base] — dense GQA.

40L d_model=2048 32H (GQA kv=8, head_dim 64) d_ff=8192 vocab=49155.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
    rope_theta=10_000_000.0,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
