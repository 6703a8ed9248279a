"""Tiny versions of the benchmark's configurations and cells, for runs on
the CPU: two layers of width 64, 500 tokens, rows of 32.  Every other
field, and every cell's limits, are the real files'."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.lib import registry as REG  # noqa: E402

CELLS = ("opt-1.3b.diloco-int8", "granite-3-2b.train-4k")
SIZES = {"opt-1.3b": dict(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=4, d_ff=128, vocab_size=500,
                          max_target_positions=64),
         "granite-3-2b": dict(num_layers=2, d_model=64, num_heads=4,
                              num_kv_heads=2, head_dim=16, d_ff=128,
                              vocab_size=500, max_seq_len=64)}


def conf(name: str, **model) -> dict:
    c = copy.deepcopy(REG.config(name))
    c["model"].update(SIZES[name], **model)
    return c


def cell(name: str) -> dict:
    w = copy.deepcopy(REG.workload(name))
    w["traffic_params"]["seq_len"] = 32
    return w


def argv(name: str, seed: int = 2147483711, seconds: float = 0.0):
    return ["--workload", name, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", "0"]
