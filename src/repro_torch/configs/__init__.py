"""Architecture registry: qwen2-7b and the paper's OPT series."""

from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["ARCHS", "get_config", "list_archs"]
