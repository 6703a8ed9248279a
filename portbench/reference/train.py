"""The plain reference's training runs: the first steps of a cell from
the seed's weights and batches, and what the benchmark compares of them:
the losses named in ``compare_steps``, each leaf's norm of the first
gradient as the optimizer read it, and each leaf's norm of the
parameters' change after the steps.  ``quant`` runs the lower-precision
control; ``rows`` leaves rows out (a fault check).

Only the first step's loss (each replica's, in local SGD) is compared:
after one AdamW step, round-off in the bf16 weights turns into loss gaps
that swing from seed to seed, in sound runs and in the float8 control
alike (an opt-1.3b run read 0.030 at a later step where 48 others read
at most 0.010; PERF.md, PR 30).  What the later steps make is compared
through the change of the weights."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from portbench.lib import weights as W
from portbench.reference import model as RM
from portbench.reference import optim as RO

STORAGE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _stacked(path: tuple, model: Dict[str, Any]) -> bool:
    return path[:2] == ("decoder", "g0") and model["num_layers"] > 1


def to_pieces(tree: Dict[str, Any], model: Dict[str, Any]) -> RO.Pieces:
    """fp32 pieces of every leaf, one a layer for the stacked ones, each a
    leaf of its own that autograd differentiates."""
    P: RO.Pieces = {}
    for path in W.paths(tree):
        t = W.get(tree, path)
        parts = t.unbind(0) if _stacked(path, model) else [t]
        P[path] = [x.detach().float().clone().requires_grad_(True)
                   for x in parts]
    return P


def decay_map(model: Dict[str, Any]) -> Dict[tuple, bool]:
    sp = W.specs(model)
    return {p: len(W.get(sp, p)[0]) >= 2 for p in W.paths(sp)}


def _flat(ps: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in ps])


def _device_batch(b: Dict[str, np.ndarray], device: torch.device):
    return (torch.from_numpy(np.ascontiguousarray(b["tokens"])).to(device),
            torch.from_numpy(np.ascontiguousarray(b["labels"])).to(device))


def _delta_norms(now: Dict[tuple, torch.Tensor],
                 init: Dict[tuple, torch.Tensor]) -> Dict[tuple, float]:
    return {k: float((now[k].float() - init[k].float()).norm())
            for k in now}


def trainer(model: Dict[str, Any], opt: Dict[str, Any],
            batches: Iterable[Dict[str, np.ndarray]], steps: int, seed: int,
            device: torch.device, *, microbatches: int = 1,
            rows: Optional[List[int]] = None, quant: bool = False
            ) -> Dict[str, Any]:
    storage = STORAGE[model["param_dtype"]]
    with RM.fp32_matmul():
        tree = W.make(model, seed, device, storage)
        P = to_pieces(tree, model)
        init = {k: _flat(list(W.get(tree, k).unbind(0))
                         if _stacked(k, model) else [W.get(tree, k)])
                for k in P}
        del tree
        adam = RO.AdamW(P, opt, decay_map(model))
        losses, grad1 = [], None
        it = iter(batches)
        for t in range(steps):
            tokens, labels = _device_batch(next(it), device)
            loss, G = RM.loss_and_grads(P, model, tokens, labels,
                                        microbatches=microbatches,
                                        rows=rows, quant=quant)
            norms = adam.step(P, G, storage)
            del G
            if t == 0:
                grad1 = norms
            losses.append(loss)
        dparam = _delta_norms({k: _flat(ps) for k, ps in P.items()}, init)
    return {"losses": losses, "grad1": grad1, "dparam": dparam,
            "compare_steps": [0]}


def local_sgd(model: Dict[str, Any], opt: Dict[str, Any],
              ls: Dict[str, Any], streams: List[Iterable[Dict]],
              rounds: int, seed: int, device: torch.device, *,
              rows: Optional[List[int]] = None, quant: bool = False
              ) -> Dict[str, Any]:
    """Synchronous DiLoCo: each replica from the global weights runs K
    AdamW steps on its own stream (its AdamW state kept across rounds),
    sends start - local through int8 with its error feedback, the mean
    of what was sent takes the Nesterov outer step.  Losses in the order
    rounds, replicas, steps; the first gradient is replica 0's first
    step's; the change is of the global weights after ``rounds``.

    ``compare_steps``: each replica's first step, the loss of the seed's
    weights on its own batch; the outer steps are compared through the
    change of the global weights."""
    storage = STORAGE[model["param_dtype"]]
    R, K = ls["replicas"], ls["inner_steps"]
    with RM.fp32_matmul():
        tree = W.make(model, seed, device, storage)
        work = to_pieces(tree, model)
        glob = {k: _flat(ps) for k, ps in work.items()}
        init = {k: v.to(storage) for k, v in glob.items()}
        del tree
        decay = decay_map(model)
        adams = [RO.AdamW(work, opt, decay) for _ in range(R)]
        errs: List[Dict[tuple, Optional[torch.Tensor]]] = [
            {k: None for k in glob} for _ in range(R)]
        mom = {k: torch.zeros_like(v) for k, v in glob.items()}
        its = [iter(s) for s in streams]
        losses, grad1 = [], None
        for _ in range(rounds):
            acc = {k: torch.zeros_like(v) for k, v in glob.items()}
            for r in range(R):
                with torch.no_grad():
                    for k, ps in work.items():
                        off = 0
                        for p in ps:
                            n = p.numel()
                            p.copy_(glob[k][off:off + n].view_as(p))
                            off += n
                for _k in range(K):
                    tokens, labels = _device_batch(next(its[r]), device)
                    loss, G = RM.loss_and_grads(P=work, model=model,
                                                tokens=tokens, labels=labels,
                                                rows=rows, quant=quant)
                    norms = adams[r].step(work, G, storage)
                    del G
                    if grad1 is None:
                        grad1 = norms
                    losses.append(loss)
                with torch.no_grad():
                    for k, ps in work.items():
                        d = glob[k] - _flat(ps)
                        if ls["compress"] == "int8":
                            sent, errs[r][k] = RO.compress(
                                d, errs[r][k] if ls["error_feedback"]
                                else None, ls["block"])
                        else:
                            sent = d
                        acc[k].add_(sent)
                        del d, sent
            for k in acc:
                acc[k].div_(float(R))
            RO.outer_step(glob, acc, mom, ls["outer_lr"],
                          ls["outer_momentum"], ls["nesterov"], storage)
            del acc
        dparam = _delta_norms(glob, init)
    return {"losses": losses, "grad1": grad1, "dparam": dparam,
            "compare_steps": [r * K for r in range(R)]}
