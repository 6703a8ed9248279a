"""Architecture registry: qwen2-7b, the paper's OPT series, mamba2-130m
and mixtral-8x7b."""

from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["ARCHS", "get_config", "list_archs"]
