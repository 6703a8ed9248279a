"""DeepSeek-V3 (671B total / 37B active) [arXiv:2412.19437].

61L d_model=7168, 128 heads MLA (q_lora 1536, kv_lora 512, nope 128,
rope 64, v 128); first 3 layers dense (d_ff=18432); remaining 58 layers
MoE with 1 shared + 256 routed experts top-8 (expert d_ff=2048);
vocab=129280; multi-token prediction depth 1.  The dense decode caches
the compressed latent and the shared rope key; the paged engine refuses
MLA, as the JAX one does.
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,              # dense-layer FFN width
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    # layout is kept as the JAX package sets it and read by nothing
    # until the multi-device slice
    moe=MoEConfig(num_experts=256, experts_per_token=8,
                  num_shared_experts=1, d_ff_expert=2048,
                  layout="unconstrained"),
    first_dense_layers=3,
    mtp_depth=1,
    source="arXiv:2412.19437 (DeepSeek-V3)",
)
