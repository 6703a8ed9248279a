"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; there is no silent CPU fallback.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present — pass ``device="cpu"`` to run the plain PyTorch versions.
    ``cuda`` without an index becomes the current card's ``cuda:<n>``, the
    device its tensors report."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator_for(device: torch.device, seed: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (or the
    caller's own, checked to live on the same device type)."""
    if generator is None:
        return torch.Generator(device=device).manual_seed(seed)
    if generator.device.type != device.type:
        raise ValueError(f"generator lives on {generator.device}, "
                         f"tensors on {device}")
    return generator
