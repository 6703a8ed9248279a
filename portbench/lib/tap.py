"""The window and the tap on the program's train step.

The timed call runs ``check + W`` steps (or rounds) of the program's own
loop.  The tap wraps its train step and, counting calls:

* after call 0, keeps each leaf's norm of the first gradient as AdamW
  read it, ``mu / (1 - b1)`` of the optimizer state after one step;
* keeps each check step's loss;
* before call ``check``, the parameters that step receives are those the
  check steps left: it keeps each leaf's change from the seed's weights
  (made again for the purpose and dropped), then opens the window;
* drives the traced stretches of a ``--trace 1`` run.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from portbench.lib import weights as W
from portbench.lib.profile import Stretch


class Window:
    def __init__(self, device: torch.device):
        self.device = device
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.peak_bytes: Optional[int] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open(self) -> None:
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t0 = time.perf_counter()

    def close(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def _norms(tree: Any, like: Optional[Any] = None) -> torch.Tensor:
    """Each leaf's fp32 norm (of ``tree - like`` when given), stacked."""
    out = []
    for p in W.paths(tree):
        x = W.get(tree, p).float()
        if like is not None:
            x = x - W.get(like, p).float()
        out.append(x.norm())
    return torch.stack(out)


class Tap:
    def __init__(self, model: Dict[str, Any], seed: int,
                 device: torch.device, check: int, b1: float,
                 window: Window, stretches: Sequence[Stretch] = ()):
        self.model, self.seed, self.device = model, seed, device
        self.check, self.b1 = check, b1
        self.window, self.stretches = window, stretches
        self.i = 0
        self._losses: List[torch.Tensor] = []
        self._grad1: Optional[torch.Tensor] = None
        self.paths: List[tuple] = []
        self.prog: Optional[Dict[str, Any]] = None

    def _check_end(self, params: Any) -> None:
        init = W.make(self.model, self.seed, self.device,
                      getattr(torch, self.model["param_dtype"]))
        with torch.no_grad():
            dparam = _norms(params, init)
        del init
        self.paths = W.paths(params)
        host = torch.cat([torch.stack(self._losses).float(),
                          self._grad1, dparam]).tolist()
        n, m = len(self._losses), len(self.paths)
        self.prog = {"losses": host[:n],
                     "grad1": dict(zip(self.paths, host[n:n + m])),
                     "dparam": dict(zip(self.paths, host[n + m:]))}
        self._losses.clear()
        self._grad1 = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def wrap(self, step_fn: Callable) -> Callable:
        def step(params, opt_state, batch):
            i = self.i
            if i == self.check:
                self._check_end(params)
                self.window.open()
            for s in self.stretches:
                s.at(i - self.check)
            params, opt_state, mx = step_fn(params, opt_state, batch)
            if i == 0:
                with torch.no_grad():
                    self._grad1 = _norms(opt_state["mu"]) / (1.0 - self.b1)
            if i < self.check:
                self._losses.append(mx["loss"].detach())
            self.i += 1
            return params, opt_state, mx
        return step
