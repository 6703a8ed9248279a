"""Architecture registry: the dense qwen2-7b, granite-3-2b, qwen1.5-32b,
llama3-405b and the paper's OPT series, mamba2-130m, mixtral-8x7b,
deepseek-v3-671b, jamba-v0.1-52b, whisper-medium and qwen2-vl-2b."""

from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["ARCHS", "get_config", "list_archs"]
