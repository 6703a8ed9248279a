"""What every run shares: the arguments, the guards (cards present, no
JAX loaded), the context a traffic kind runs in, and the record it hands
back for the metric readers."""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from portbench.lib.registry import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="portbench/run.py",
        description="Run one benchmark cell of the PyTorch port once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port's own nvcc outputs go to ``build/kernels`` of the checkout
    already (``repro_torch.kernels.build``)."""
    base = ROOT / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def require_cards(n: int) -> None:
    """Raise unless ``n`` CUDA cards are present: a measurement never
    falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA card is available; nothing "
                         "is measured on the CPU")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"portbench: the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} are present")


def forbidden_loaded(modules: Optional[List[str]] = None) -> List[str]:
    """Modules of JAX, Flax or the JAX package among ``modules`` (those
    of this process by default), compared by whole top-level name
    (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Ctx:
    """What a traffic kind runs with.  ``seed`` makes the weights;
    ``data_seed`` (the same number, kept non-negative) the batches."""
    cell: Dict[str, Any]
    conf: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    min_window: int = 1

    @property
    def model(self) -> Dict[str, Any]:
        return self.conf["model"]

    @property
    def data_seed(self) -> int:
        from portbench.lib.weights import seed_bits
        return seed_bits(self.seed)


@dataclass
class Run:
    """A traffic kind's record of its timed call."""
    window: Any                       # lib.tap.Window
    attempted: int                    # steps or rounds in the window
    failed: int                       # of those, with a non-finite loss
    tokens: int                       # trained in the window
    flops: float                      # model FLOPs of the window
    prog: Optional[Dict[str, Any]]    # the check steps' readings
    step_flops: float = 0.0           # model FLOPs of one (inner) step
    setup_s: float = 0.0
    power_w: Optional[float] = None
    power_samples: int = 0
    trace: Any = None                 # lib.profile.Trace, --trace 1
    stack_trace: Any = None           # the same, with Python stacks
    phase_s: Dict[str, float] = field(default_factory=dict)
    rounds: int = 0                   # rounds of the whole timed call
    work: Dict[str, Any] = field(default_factory=dict)


def fa2_work(model: Dict[str, Any], batch: int, seq: int,
             calls_per_step: int) -> Dict[str, int]:
    """The shapes of a step's attention calls, for ``fa2_roofline``."""
    H = model["num_heads"]
    return {"calls_per_step": calls_per_step, "batch": batch, "seq": seq,
            "heads": H, "kv_heads": model["num_kv_heads"],
            "head_dim": model.get("head_dim") or model["d_model"] // H}
