"""Parameter bridge between the JAX package and the port, through numpy.

Leaves are keyed by the path strings ``jax.tree_util.keystr`` gives a
nested dict (``"['decoder']['g0']['s0_attn']['wq']"``), the scheme the
JAX package's checkpoint manifests use.  The bridge takes and returns
plain numpy; the caller on the JAX side does
``jax.tree.map(np.asarray, params)``.  bfloat16 leaves cross as their raw
16-bit patterns, so the copy is exact in both directions.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import model_spec

PyTree = Any


def keystr(path: Tuple[str, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def flatten(tree: PyTree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], prefix + (k,))
    else:
        yield keystr(prefix), tree


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")      # own, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                 # ships with JAX on the test side
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: PyTree, cfg: ModelConfig,
                      device: DeviceLike = None) -> PyTree:
    """JAX-layout numpy params -> the port's tensors on ``device``.

    Checks the tree against ``model_spec(cfg)``: same keys, same shapes."""
    dev = resolve_device(device)
    spec = dict(flatten(model_spec(cfg)))
    got = dict(flatten(tree))
    if set(spec) != set(got):
        raise KeyError(f"parameter keys differ from {cfg.name}'s spec: "
                       f"missing {sorted(set(spec) - set(got))}, "
                       f"extra {sorted(set(got) - set(spec))}")
    for key, s in spec.items():
        if tuple(got[key].shape) != s.shape:
            raise ValueError(f"{key}: shape {tuple(got[key].shape)}, "
                             f"spec {s.shape}")

    def build(node: PyTree) -> PyTree:
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return _to_tensor(np.asarray(node), dev)
    return build(tree)


def params_to_numpy(params: PyTree) -> PyTree:
    """Inverse of :func:`params_from_numpy`."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return _to_numpy(params)
