"""Whisper-medium [arXiv:2212.04356] — encoder-decoder, conv frontend stub.

24+24L d_model=1024 16H (MHA) d_ff=4096 vocab=51865; encoder consumes 1500
mel-frame embeddings (the conv frontend is a stub: random frames stand in
for it); decoder max 448 positions with learned embeddings; GELU MLP,
LayerNorm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp_activation="gelu",
    norm_type="layernorm",
    pos_embedding="learned",
    encoder_seq_len=1500,
    max_target_positions=448,
    frontend="audio_stub",
    qkv_bias=True,
    source="arXiv:2212.04356 (Whisper)",
)
