"""Full-model paged decode: embedding, the stacked decoder groups, the LM
head (port of the paged-decode part of ``repro.models.model``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import params as P
from repro_torch.models.blocks import (PAGED_SUBLAYERS, group_decode_paged,
                                       init_paged_sublayer_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norm

PyTree = Any


def embed_tokens(params: PyTree, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]["tok"]
    return emb[tokens.long()].to(getattr(torch, cfg.compute_dtype))


def lm_logits(params: PyTree, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["tok"].to(h.dtype).T
    else:
        logits = h @ params["lm_head"].to(h.dtype)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # vocab-padding mask: padded ids never win softmax/argmax
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def paged_decode_supported(cfg: ModelConfig) -> bool:
    """Whether the paged serving engine can run this architecture: every
    decoder sublayer must be token-paged or stateless (attn/mlp/moe)."""
    if cfg.is_encoder_decoder or cfg.arch_type in ("ssm", "hybrid") \
            or cfg.attention != "gqa":
        return False
    return all(kind in PAGED_SUBLAYERS
               for g in P.decoder_groups(cfg) for kind in g.sublayers)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: torch.device = torch.device("cpu")) -> PyTree:
    """Per-layer page pools (no batch dim — sequences share the pool via
    their block tables; block 0 is the null page, see serve.paged_cache).
    Stacked groups carry a leading depth axis, as the parameters do."""
    cache: Dict[str, Any] = {}
    for gi, g in enumerate(P.decoder_groups(cfg)):
        unit = {}
        for j, kind in enumerate(g.sublayers):
            one = init_paged_sublayer_cache(kind, cfg, num_blocks,
                                            block_size, dtype, device)
            if g.depth > 1:
                one = P.tree_map(
                    lambda a: a[None].expand((g.depth,) + a.shape)
                    .contiguous(), one)
            unit[f"s{j}_{kind}"] = one
        cache[f"g{gi}"] = unit
    return cache


def decode_step_paged(params: PyTree, cfg: ModelConfig, cache: PyTree,
                      tokens: torch.Tensor, block_tables: torch.Tensor,
                      seq_lens: torch.Tensor, *, attn_impl: str = "kernel",
                      num_feed: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, PyTree]:
    """One decode / chunked-prefill step over a paged KV cache with
    per-sequence positions.

    tokens: (B, C) int teacher-forced rows (C == 1 is plain decode);
    block_tables: (B, NB) int32 page ids; seq_lens: (B,) int32 cache
    positions already written — row ``c`` is written at position
    ``seq_lens[b] + c`` and attends to ``seq_lens[b] + c + 1`` positions.
    ``num_feed``: (B,) rows actually fed; rows past it write to the null
    page and the logits come from row ``num_feed - 1`` (row ``C - 1`` when
    omitted).  The page pools in ``cache`` are updated in place.  Returns
    (logits (B, vocab), cache).
    """
    B, C = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    pos_bc = seq_lens.long()[:, None] \
        + torch.arange(C, device=tokens.device)[None, :]     # (B, C)
    if "pos" in params["embed"]:
        pos_tab = params["embed"]["pos"]
        idx = pos_bc.clamp(0, pos_tab.shape[0] - 1)
        x = x + pos_tab[idx].to(x.dtype)
    ctx: Dict[str, Any] = {"positions": pos_bc,
                           "block_tables": block_tables,
                           "seq_lens": seq_lens,
                           "num_feed": num_feed,
                           "attn_impl": attn_impl}
    for gi, g in enumerate(P.decoder_groups(cfg)):
        x, _ = group_decode_paged(params["decoder"][f"g{gi}"], g, x,
                                  cache[f"g{gi}"], cfg, ctx)
    h = norm(params["final_norm"], x, cfg)
    if num_feed is None:
        h_last = h[:, C - 1]
    else:
        last = (num_feed.long() - 1).clamp(0, C - 1)
        h_last = h[torch.arange(B, device=h.device), last]
    return lm_logits(params, cfg, h_last), cache
