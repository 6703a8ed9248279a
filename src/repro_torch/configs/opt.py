"""OPT series [arXiv:2205.01068] — the paper's experimental models (§4.2).

Geometry from the OPT paper, Table 1.
"""

from repro_torch.models.config import ModelConfig

_OPT_GEOMETRY = {
    # name: (layers, d_model, heads, d_ff)
    "opt-125m": (12, 768, 12, 3072),
    "opt-350m": (24, 1024, 16, 4096),
    "opt-1.3b": (24, 2048, 32, 8192),
    "opt-2.7b": (32, 2560, 32, 10240),
    "opt-6.7b": (32, 4096, 32, 16384),
    "opt-13b": (40, 5120, 40, 20480),
    "opt-30b": (48, 7168, 56, 28672),
}


def opt_config(name: str) -> ModelConfig:
    layers, d, heads, ff = _OPT_GEOMETRY[name]
    return ModelConfig(
        name=name,
        arch_type="dense",
        num_layers=layers,
        d_model=d,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=ff,
        vocab_size=50272,
        mlp_activation="gelu",
        norm_type="layernorm",
        pos_embedding="learned",
        max_target_positions=2048,
        tie_embeddings=True,
        qkv_bias=True,
        source="arXiv:2205.01068 (OPT)",
    )


OPT_NAMES = tuple(_OPT_GEOMETRY)
CONFIG = opt_config("opt-125m")
