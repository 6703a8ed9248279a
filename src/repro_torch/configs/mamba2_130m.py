"""Mamba2-130m [arXiv:2405.21060] — attention-free SSD (state-space duality).

24L d_model=768, d_inner=1536 (expand 2), 24 SSD heads of dim 64,
ssm_state=128, vocab=50280.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,            # unused (attention-free); kept for bookkeeping
    num_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    pos_embedding="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_kernel=4, chunk_size=128),
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba2 / SSD)",
)
