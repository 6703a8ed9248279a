"""Architecture registry: qwen2-7b, the paper's OPT series, mamba2-130m,
mixtral-8x7b and jamba-v0.1-52b."""

from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["ARCHS", "get_config", "list_archs"]
