"""Qwen2-VL-2B language backbone [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 — M-RoPE with
(t,h,w) sections (16,24,24) over head_dim 128; dynamic-resolution vision
encoder is a stub (the data pipeline supplies random patch embeddings).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    pos_embedding="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    tie_embeddings=True,
    source="arXiv:2409.12191 (Qwen2-VL)",
)
