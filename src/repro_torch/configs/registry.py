"""Registry: ``--arch <id>`` lookup for the families the port runs
(qwen2-7b, the OPT series, mamba2-130m, mixtral-8x7b and the jamba
hybrid), with the ``-smoke`` reduced variants."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.jamba_v01_52b import CONFIG as _jamba_v01_52b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral_8x7b
from repro_torch.configs.opt import OPT_NAMES, opt_config
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2_7b
from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {"qwen2-7b": _qwen2_7b,
                                  "mamba2-130m": _mamba2_130m,
                                  "mixtral-8x7b": _mixtral_8x7b,
                                  "jamba-v0.1-52b": _jamba_v01_52b}
for _n in OPT_NAMES:
    ARCHS[_n] = opt_config(_n)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    cfg.validate()
    return cfg


def list_archs() -> List[str]:
    return sorted(ARCHS)
