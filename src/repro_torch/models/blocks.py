"""Stacked-group execution: the train/prefill forward, the dense-cache
decode step and the paged decode step.

Port of ``repro.models.blocks`` for attn, mla, mlp, moe, ssm (Mamba2)
and xattn (whisper's cross-attention) units.  A
:class:`~repro_torch.models.params.ScanGroup` stacks ``depth`` identical
units on a leading ``layers`` axis; where the JAX package ran the unit
under ``lax.scan``, the port loops over that axis in Python, taking views
of each layer's parameters (and caches, which the decode steps update in
place through those views).  ``ctx`` threads ``attn_impl``, ``remat`` and
``use_kernel`` (the SSD scan kernel) from the step down to every
sublayer, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.act_sharding import BATCH, constrain, gathered
from repro_torch.models import mamba2, mla, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attn_decode, attn_decode_paged,
                                       attn_forward, mlp_forward,
                                       xattn_decode, xattn_forward)
from repro_torch.models.params import ScanGroup, tree_map

PyTree = Any

# Rematerialization of each stacked unit (JAX ``REMAT_POLICIES``): "full"
# saves nothing inside a unit and recomputes it in the backward; "dots"
# saves every matmul output and recomputes the rest; "dots_no_batch" saves
# only matmuls without a batch dimension (the projections, not the
# attention products).  torch.utils.checkpoint, non-reentrant, with a
# selective-checkpoint policy for the two "dots" variants.
REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")


def _save_ops(remat: str):
    aten = torch.ops.aten
    ops = {aten.mm.default, aten.addmm.default}
    if remat == "dots":
        ops |= {aten.bmm.default, aten.baddbmm.default}
    return ops


def _remat(fn, remat: str):
    """``fn`` under the rematerialization policy ``remat``."""
    if remat == "none":
        return fn
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; expected one of "
                         f"{REMAT_POLICIES}")
    kw: Dict[str, Any] = {"use_reentrant": False}
    if remat != "full":
        save = _save_ops(remat)

        def policy(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE if op in save
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)
    return functools.partial(ckpt.checkpoint, fn, **kw)


# --------------------------------------------------------------------------- #
# Train / prefill
# --------------------------------------------------------------------------- #

def _sublayer_train(kind: str, p: PyTree, x: torch.Tensor,
                    aux: torch.Tensor, cfg: ModelConfig,
                    ctx: Dict[str, Any]):
    p = gathered(p)                    # FSDP: the sublayer's whole weights
    if kind == "attn":
        return attn_forward(p, x, cfg, positions=ctx["positions"],
                            causal=ctx.get("causal", True),
                            impl=ctx.get("attn_impl", "kernel")), aux
    if kind == "mla":
        return mla.mla_forward(p, x, cfg, positions=ctx["positions"],
                               causal=ctx.get("causal", True),
                               impl=ctx.get("attn_impl", "kernel")), aux
    if kind == "mlp":
        return mlp_forward(p, x, cfg), aux
    if kind == "moe":
        y, l = moe.moe_forward(p, x, cfg)
        return y, aux + l
    if kind == "ssm":
        return mamba2.ssm_forward(p, x, cfg,
                                  use_kernel=ctx.get("use_kernel", False)), aux
    if kind == "xattn":
        return xattn_forward(p, x, ctx["enc"], cfg,
                             impl=ctx.get("attn_impl", "kernel")), aux
    raise ValueError(kind)


def group_forward(gparams: PyTree, group: ScanGroup, x: torch.Tensor,
                  cfg: ModelConfig, ctx: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden, aux_loss).  Each stacked leaf is unbound once, so
    the backward stacks the per-layer gradients in one op instead of
    scattering each into a zero-filled copy of the stack."""

    def unit(p_unit: PyTree, h: torch.Tensor, aux: torch.Tensor):
        for j, kind in enumerate(group.sublayers):
            h, aux = _sublayer_train(kind, p_unit[f"s{j}_{kind}"], h, aux,
                                     cfg, ctx)
            h = constrain(h, BATCH, None, None)   # stays batch-sharded
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if group.depth == 1:
        return unit(gparams, x, aux)
    body = _remat(unit, ctx.get("remat", "none"))
    layers = tree_map(lambda a: a.unbind(0), gparams)
    for i in range(group.depth):
        x, aux = body(tree_map(lambda t: t[i], layers), x, aux)
    return x, aux


# --------------------------------------------------------------------------- #
# Decode (single token, dense cache — the launcher's fallback path)
# --------------------------------------------------------------------------- #

DENSE_SUBLAYERS = ("attn", "mla", "ssm", "mlp", "moe", "xattn")


def _dense_only(kind: str) -> None:
    if kind not in DENSE_SUBLAYERS:
        raise ValueError(f"dense decode supports sublayers "
                         f"{DENSE_SUBLAYERS}, got {kind!r}")


def init_sublayer_cache(kind: str, cfg: ModelConfig, batch: int,
                        max_len: int, dtype: torch.dtype = torch.bfloat16,
                        device: DeviceLike = None) -> PyTree:
    """One sublayer's dense cache: (B, T, K, D) K/V for attn, the latent
    and rope key for mla, the fp32 recurrent state and conv buffers for
    ssm (whatever ``dtype`` is, as in the JAX package), the encoder's
    (B, encoder_seq_len, K, D) K/V for xattn (filled once by
    ``model.warm_cross_cache``), nothing for mlp and moe.  On the card
    unless ``device="cpu"`` is asked for."""
    _dense_only(kind)
    device = resolve_device(device)
    if kind in ("attn", "xattn"):
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        T = max_len if kind == "attn" else cfg.encoder_seq_len
        shape = (batch, T, K, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "mla":
        return mla.init_mla_cache(cfg, batch, max_len, dtype, device)
    if kind == "ssm":
        return mamba2.init_ssm_cache(cfg, batch, device=device)
    return {}                                      # stateless: mlp / moe


def _sublayer_decode(kind: str, p: PyTree, x: torch.Tensor, cache: PyTree,
                     cfg: ModelConfig, ctx: Dict[str, Any]):
    _dense_only(kind)
    if kind == "attn":
        y, ck, cv = attn_decode(p, x, cfg, cache_k=cache["k"],
                                cache_v=cache["v"], index=ctx["index"],
                                positions=ctx["positions"])
        return y, {"k": ck, "v": cv}
    if kind == "mla":
        return mla.mla_decode(p, x, cfg, cache=cache, index=ctx["index"],
                              positions=ctx["positions"])
    if kind == "ssm":
        return mamba2.ssm_decode(p, x, cfg, cache=cache)
    if kind == "moe":
        return moe.moe_forward(p, x, cfg)[0], cache    # aux dropped
    if kind == "xattn":
        if ctx.get("enc") is not None:
            # the legacy path: re-project the encoder K/V this step, through
            # the JAX package's default (chunked) attention; the serving
            # path reads the warmed cache
            return xattn_forward(p, x, ctx["enc"], cfg,
                                 impl="chunked"), cache
        return xattn_decode(p, x, cfg, cache_k=cache["k"],
                            cache_v=cache["v"]), cache
    return mlp_forward(p, x, cfg), cache


def init_group_cache(group: ScanGroup, cfg: ModelConfig, batch: int,
                     max_len: int, dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> PyTree:
    unit = {f"s{j}_{kind}": init_sublayer_cache(kind, cfg, batch, max_len,
                                                dtype, device)
            for j, kind in enumerate(group.sublayers)}
    if group.depth == 1:
        return unit
    return tree_map(lambda a: a[None].expand((group.depth,) + a.shape)
                    .contiguous(), unit)


def group_decode(gparams: PyTree, group: ScanGroup, x: torch.Tensor,
                 cache: PyTree, cfg: ModelConfig, ctx: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, PyTree]:
    """One token through the group.  The cache is updated IN PLACE (each
    layer's new state is copied into its view of the stacked cache), which
    takes the place of the JAX scan's stacked new cache; returns (hidden,
    the same cache)."""
    def unit(p_unit: PyTree, c_unit: PyTree, h: torch.Tensor):
        for j, kind in enumerate(group.sublayers):
            key = f"s{j}_{kind}"
            h, new = _sublayer_decode(kind, p_unit[key], h, c_unit[key],
                                      cfg, ctx)
            for name, t in new.items():
                if t is not c_unit[key][name]:
                    c_unit[key][name].copy_(t)
        return h

    if group.depth == 1:
        return unit(gparams, cache, x), cache
    for i in range(group.depth):
        x = unit(tree_map(lambda a: a[i], gparams),
                 tree_map(lambda a: a[i], cache), x)
    return x, cache


# --------------------------------------------------------------------------- #
# Decode (paged KV cache — the serving-engine path)
# --------------------------------------------------------------------------- #

PAGED_SUBLAYERS = ("attn", "mlp", "moe")


def init_paged_sublayer_cache(kind: str, cfg: ModelConfig, num_blocks: int,
                              block_size: int,
                              dtype: torch.dtype = torch.bfloat16,
                              device: DeviceLike = None) -> PyTree:
    """Per-sublayer page pools (no batch dim — sequences share the pool
    through their block tables).  int8 pools carry fp32 ``k_scale`` /
    ``v_scale`` pools alongside, one scale per (page slot, kv head).  The
    pools live on the card unless ``device="cpu"`` is asked for."""
    device = resolve_device(device)
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
    if kind == "moe":
        return moe.moe_forward(p, x, cfg)[0], cache    # aux dropped
    raise NotImplementedError(
        f"paged decode supports sublayers {PAGED_SUBLAYERS}, got {kind!r} "
        "(SSM/MLA/xattn caches are not token-paged)")


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
