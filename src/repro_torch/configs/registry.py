"""Registry: ``--arch <id>`` lookup for the families the port runs
(the dense qwen2-7b, granite-3-2b, qwen1.5-32b, llama3-405b and OPT
series, mamba2-130m, mixtral-8x7b, deepseek-v3-671b, the jamba hybrid,
the whisper-medium encoder-decoder and the qwen2-vl-2b VLM backbone),
with the ``-smoke`` reduced variants, plus the four assigned input
shapes of the production mesh's dry-run matrix."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek_v3_671b
from repro_torch.configs.granite_3_2b import CONFIG as _granite_3_2b
from repro_torch.configs.jamba_v01_52b import CONFIG as _jamba_v01_52b
from repro_torch.configs.llama3_405b import CONFIG as _llama3_405b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.opt import OPT_NAMES, opt_config
from repro_torch.configs.qwen15_32b import CONFIG as _qwen15_32b
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2_7b
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl_2b
from repro_torch.configs.whisper_medium import CONFIG as _whisper_medium
from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {"qwen2-7b": _qwen2_7b,
                                  "mamba2-130m": _mamba2_130m,
                                  "mixtral-8x7b": _mixtral_8x7b,
                                  "jamba-v0.1-52b": _jamba_v01_52b,
                                  "deepseek-v3-671b": _deepseek_v3_671b,
                                  "granite-3-2b": _granite_3_2b,
                                  "qwen1.5-32b": _qwen15_32b,
                                  "llama3-405b": _llama3_405b,
                                  "whisper-medium": _whisper_medium,
                                  "qwen2-vl-2b": _qwen2_vl_2b}
ASSIGNED = tuple(ARCHS)

for _n in OPT_NAMES:
    ARCHS[_n] = opt_config(_n)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: SSM / hybrid / sliding-window only
LONG_CONTEXT_OK = ("mamba2-130m", "jamba-v0.1-52b", "mixtral-8x7b")


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    cfg.validate()
    return cfg


def list_archs(assigned_only: bool = False) -> List[str]:
    return list(ASSIGNED) if assigned_only else sorted(ARCHS)


def shape_applicable(arch: str, shape: str) -> bool:
    """Whether (arch, shape) is part of the dry-run matrix."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True


def input_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
