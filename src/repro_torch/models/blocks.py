"""Stacked-group execution of the paged decode step.

Port of the paged part of ``repro.models.blocks``.  A
:class:`~repro_torch.models.params.ScanGroup` stacks ``depth`` identical
units on a leading ``layers`` axis; where the JAX package ran the unit
under ``lax.scan``, the port loops over that axis in Python, taking views
of each layer's parameters and page pools (the pools are updated in
place through those views).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attn_decode_paged, mlp_forward
from repro_torch.models.params import ScanGroup, tree_map

PyTree = Any

PAGED_SUBLAYERS = ("attn", "mlp", "moe")


def init_paged_sublayer_cache(kind: str, cfg: ModelConfig, num_blocks: int,
                              block_size: int,
                              dtype: torch.dtype = torch.bfloat16,
                              device: torch.device = torch.device("cpu")
                              ) -> PyTree:
    """Per-sublayer page pools (no batch dim — sequences share the pool
    through their block tables).  int8 pools carry fp32 ``k_scale`` /
    ``v_scale`` pools alongside, one scale per (page slot, kv head)."""
    if kind == "attn":
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        shape = (num_blocks, block_size, K, hd)
        pools = {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                 "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
        if dtype == torch.int8:
            pools["k_scale"] = torch.ones(shape[:3], dtype=torch.float32,
                                          device=device)
            pools["v_scale"] = torch.ones(shape[:3], dtype=torch.float32,
                                          device=device)
        return pools
    if kind in ("mlp", "moe"):
        return {}                                  # stateless
    raise NotImplementedError(
        f"paged decode supports sublayers {PAGED_SUBLAYERS}, got {kind!r} "
        "(SSM/MLA/xattn caches are not token-paged)")


def _sublayer_decode_paged(kind: str, p: PyTree, x: torch.Tensor,
                           cache: PyTree, cfg: ModelConfig,
                           ctx: Dict[str, Any]):
    if kind == "attn":
        return attn_decode_paged(
            p, x, cfg, cache=cache,
            block_tables=ctx["block_tables"], seq_lens=ctx["seq_lens"],
            positions=ctx["positions"], num_feed=ctx.get("num_feed"),
            impl=ctx.get("attn_impl", "kernel"))
    if kind == "mlp":
        return mlp_forward(p, x, cfg), cache
    raise NotImplementedError(f"paged decode of {kind!r} sublayers is not "
                              "ported yet")


def group_decode_paged(gparams: PyTree, group: ScanGroup, x: torch.Tensor,
                       cache: PyTree, cfg: ModelConfig, ctx: Dict[str, Any]
                       ) -> Tuple[torch.Tensor, PyTree]:
    def unit(p_unit: PyTree, c_unit: PyTree, h: torch.Tensor):
        for j, kind in enumerate(group.sublayers):
            key = f"s{j}_{kind}"
            h, _ = _sublayer_decode_paged(kind, p_unit[key], h, c_unit[key],
                                          cfg, ctx)
        return h

    if group.depth == 1:
        return unit(gparams, cache, x), cache
    for i in range(group.depth):
        x = unit(tree_map(lambda a: a[i], gparams),
                 tree_map(lambda a: a[i], cache), x)
    return x, cache
