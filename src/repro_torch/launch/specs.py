"""Input geometry shared by the data pipeline and the launchers (the
port's copy of ``vlm_split`` from ``repro.launch.specs``; the rest of that
module, the abstract input specs of the multi-device dry run, is not
ported)."""

from __future__ import annotations

from typing import Tuple


def vlm_split(seq_len: int) -> Tuple[int, int]:
    """(vision tokens, text tokens) for a VLM sequence budget."""
    v = min(1024, seq_len // 4)
    return v, seq_len - v
