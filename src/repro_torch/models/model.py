"""Full-model passes: the train loss (with DeepSeek's multi-token
prediction loss), full-sequence logits, whisper's encoder, the dense-cache
decode step and the paged decode step (port of ``repro.models.model`` for
attn + mlp decoders, their mixture-of-experts variant, multi-head latent
attention, the Mamba2 stack, the jamba hybrid, the whisper
encoder-decoder and the Qwen2-VL backbone).

Batch dict keys: ``tokens`` (B, S) int decoder input ids; ``labels``
(B, S) int next-token targets, -1 masked (with a vision prefix they cover
it too: (B, Sv + S)); ``positions`` (B, S), or (3, B, S) for M-RoPE,
optional; ``vision_embeds`` (B, Sv, d), the VLM frontend stub's output,
prepended to the token embeddings; ``frames`` (B, Se, d), the audio
frontend stub's output, which the encoder reads.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.act_sharding import (BATCH, REPLICATED,
                                                  by_rows, constrain,
                                                  gathered, is_sharded,
                                                  vocab_parallel_embedding)
from repro_torch.models import params as P
from repro_torch.models.blocks import (PAGED_SUBLAYERS, _sublayer_train,
                                       group_decode, group_decode_paged,
                                       group_forward, init_group_cache,
                                       init_paged_sublayer_cache)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norm, project_cross_kv

PyTree = Any


def embed_tokens(params: PyTree, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]["tok"]
    if is_sharded(emb):
        return vocab_parallel_embedding(tokens, emb).to(
            getattr(torch, cfg.compute_dtype))
    return emb[tokens.long()].to(getattr(torch, cfg.compute_dtype))


def lm_logits(params: PyTree, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = h @ gathered(params["embed"]["tok"]).to(h.dtype).T
    else:
        logits = h @ gathered(params["lm_head"]).to(h.dtype)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # vocab-padding mask: padded ids never win softmax/argmax.  Out of
        # place, since the logits sit under autograd when training.
        pad = torch.arange(cfg.padded_vocab_size,
                           device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logits.gather(-1, labels[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean CE in fp32.  labels == -1 are ignored.  Returns (loss,
    number of counted tokens).  Vocab-sharded logits (a DTensor) are
    gathered over the vocab first: the log-normaliser needs every row
    whole (a known cost of the mesh, not of one device); each rank then
    picks its own rows' gold logits (``act_sharding.by_rows``)."""
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logits = constrain(logits.float(), BATCH, None, REPLICATED)
    logz = torch.logsumexp(logits, dim=-1)
    gold = (by_rows(_gold, logits, safe) if is_sharded(logits)
            else _gold(logits, safe))
    nll = (logz - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    return nll.sum() / denom, denom


def default_positions(batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                      seq_len: int, bsz: int) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(seq_len, dtype=torch.int32,
                       device=batch["tokens"].device)
    pos = pos[None, :].expand(bsz, seq_len)
    if cfg.pos_embedding == "mrope":
        return pos[None].expand(3, bsz, seq_len)
    return pos


@functools.lru_cache(maxsize=8)
def _sinusoidal_table(n: int, d: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """The encoder's (n, d) sinusoidal table in ``dtype`` on ``device``,
    built once (the JAX package's jit folds it into a constant; building
    it in numpy every forward held the card idle)."""
    with torch.inference_mode(False):
        return torch.from_numpy(P._sinusoidal(n, d)).to(device, dtype)


def encoder_forward(params: PyTree, cfg: ModelConfig, frames: torch.Tensor,
                    ctx: Dict[str, Any]) -> torch.Tensor:
    """Whisper's encoder over ``frames`` (B, S, d): cast to the compute
    dtype, plus the sinusoidal table in that dtype, then the (attn, mlp)
    units non-causal (absolute positions only, no rope) and the encoder's
    final norm.  ``ctx`` carries ``attn_impl`` and ``remat``."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    B, S, d = x.shape
    x = x + _sinusoidal_table(S, d, x.dtype, x.device)[None]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    enc_ctx = dict(ctx, causal=False, positions=pos[None].expand(B, S))
    for gi, g in enumerate(P.encoder_groups(cfg)):
        x, _ = group_forward(params["encoder"][f"g{gi}"], g, x, cfg, enc_ctx)
    return norm(gathered(params["encoder"]["final_norm"]), x, cfg)


def decoder_trunk(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
                  ctx: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, g in enumerate(P.decoder_groups(cfg)):
        x, a = group_forward(params["decoder"][f"g{gi}"], g, x, cfg, ctx)
        aux = aux + a
    return norm(gathered(params["final_norm"]), x, cfg), aux


def _embed_with_positions(params: PyTree, cfg: ModelConfig,
                          batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings plus the learned positions where the model has
    them, after the vision prefix where the batch has one."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    if "pos" in params["embed"]:
        pos = gathered(params["embed"]["pos"])
        x = x + pos[:tokens.shape[1]].to(x.dtype)[None]
    if "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    return x


def _trunk_ctx(params: PyTree, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor], x: torch.Tensor,
               **ctx: Any) -> Dict[str, Any]:
    """The decoder's context: positions over ``x``'s length (the vision
    prefix's included), causal, and for an encoder-decoder the encoder's
    output of ``batch["frames"]`` under ``enc``."""
    B, S = x.shape[:2]
    out = dict(ctx, positions=default_positions(batch, cfg, S, B),
               causal=True)
    if cfg.is_encoder_decoder:
        out["enc"] = encoder_forward(
            params, cfg, batch["frames"],
            {k: v for k, v in ctx.items() if k in ("remat", "attn_impl")})
    return out


def _mtp_loss(params: PyTree, cfg: ModelConfig, h: torch.Tensor,
              tokens: torch.Tensor, labels: torch.Tensor,
              ctx: Dict[str, Any]) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction: depth k's block merges the
    previous depth's normed hidden state (the trunk's, after the shared
    ``final_norm``, at k = 0) with the embeddings of the tokens k + 1
    ahead, runs one block of the last layer's mixer and an MLP (in sorted
    key order), the shared ``final_norm`` and ``lm_logits``, and scores
    the labels k + 1 ahead; the sum over depths is scaled by
    ``mtp_loss_coef / mtp_depth``, as in the JAX package."""
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    prev = h                                              # (B, S, d)
    for k in range(cfg.mtp_depth):
        mp = gathered(params["mtp"][f"d{k}"])
        shift = k + 1
        prev_trim = prev[:, :-1, :]
        emb_next = embed_tokens(params, cfg, tokens[:, shift:])
        merged = torch.cat([norm(mp["norm_prev"], prev_trim, cfg),
                            norm(mp["norm_emb"], emb_next, cfg)], dim=-1)
        x = merged @ mp["proj"].to(merged.dtype)
        sub_ctx = dict(ctx, positions=ctx["positions"][..., shift:])
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for key, p_sub in sorted(mp["block"].items()):
            x, aux = _sublayer_train(key.split("_", 1)[1], p_sub, x, aux,
                                     cfg, sub_ctx)
        x = norm(gathered(params["final_norm"]), x, cfg)
        loss_k, _ = cross_entropy(lm_logits(params, cfg, x),
                                  labels[:, shift:])
        total = total + loss_k
        prev = x
    return total * cfg.mtp_loss_coef / max(cfg.mtp_depth, 1)


def forward_train(params: PyTree, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor], *, remat: str = "none",
                  attn_impl: str = "kernel"
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (scalar loss, metrics).

    ``attn_impl`` selects the attention of every attention sublayer:
    "naive" (fp32 oracle), "chunked" (plain online softmax, the JAX
    package's default) or "kernel" (the FA-2 CUDA kernels with their
    backward kernels; the plain versions on CPU tensors).  All three
    train.  With ``mtp_depth > 0`` the multi-token-prediction loss is
    added and reported as ``mtp_loss``."""
    x = constrain(_embed_with_positions(params, cfg, batch), BATCH, None,
                  None)
    ctx = _trunk_ctx(params, cfg, batch, x, remat=remat, attn_impl=attn_impl)
    h, aux = decoder_trunk(params, cfg, x, ctx)
    logits = constrain(lm_logits(params, cfg, h), BATCH, None, "model")
    loss, n_tok = cross_entropy(logits, batch["labels"])
    metrics = {"ce_loss": loss, "aux_loss": aux, "tokens": n_tok}
    total = loss + aux
    if cfg.mtp_depth > 0:
        mtp = _mtp_loss(params, cfg, h, batch["tokens"], batch["labels"],
                        ctx)
        metrics["mtp_loss"] = mtp
        total = total + mtp
    return total, metrics


def forward_logits(params: PyTree, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], *,
                   attn_impl: str = "naive",
                   use_kernel: bool = True) -> torch.Tensor:
    """Full-sequence logits (tests / prefill scoring).  ``use_kernel``
    runs every ssm sublayer's scan through the SSD kernel (its plain
    version on CPU tensors; it has no backward); False runs the plain
    ``ssd_reference``, the JAX package's default."""
    x = constrain(_embed_with_positions(params, cfg, batch), BATCH, None,
                  None)
    ctx = _trunk_ctx(params, cfg, batch, x, attn_impl=attn_impl,
                     use_kernel=use_kernel)
    h, _ = decoder_trunk(params, cfg, x, ctx)
    return constrain(lm_logits(params, cfg, h), BATCH, None, "model")


# --------------------------------------------------------------------------- #
# Dense-cache decode (the launcher's fallback for non-paged architectures)
# --------------------------------------------------------------------------- #

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> PyTree:
    """Dense per-batch caches: (B, T, K, D) K/V in ``dtype`` for attention
    sublayers, (B, encoder_seq_len, K, D) for cross-attention ones (see
    :func:`warm_cross_cache`), fp32 state and conv buffers for ssm
    sublayers; stacked groups carry a leading depth axis.  On the card
    unless ``device="cpu"`` is asked for."""
    return {f"g{gi}": init_group_cache(g, cfg, batch, max_len, dtype, device)
            for gi, g in enumerate(P.decoder_groups(cfg))}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> PyTree:
    """:func:`init_cache` as ``meta`` tensors: shapes and dtypes, no
    storage."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def warm_cross_cache(params: PyTree, cfg: ModelConfig, cache: PyTree,
                     enc: torch.Tensor) -> PyTree:
    """Fill every xattn sublayer's cache with the encoder K/V projected
    from ``enc`` (B, T, d) once, layer by layer and in place (cast to the
    cache's dtype), so that decode steps read the cache instead of
    re-projecting the whole encoder output every token.  Returns the same
    cache."""
    with torch.no_grad():
        for gi, g in enumerate(P.decoder_groups(cfg)):
            for j, kind in enumerate(g.sublayers):
                if kind != "xattn":
                    continue
                key = f"s{j}_{kind}"
                p, c = params["decoder"][f"g{gi}"][key], cache[f"g{gi}"][key]
                for i in range(g.depth):
                    pi = p if g.depth == 1 else P.tree_map(
                        lambda a: a[i], p)
                    ci = c if g.depth == 1 else P.tree_map(
                        lambda a: a[i], c)
                    k, v = project_cross_kv(pi, enc, cfg)
                    ci["k"].copy_(k)
                    ci["v"].copy_(v)
    return cache


def decode_step(params: PyTree, cfg: ModelConfig, cache: PyTree,
                tokens: torch.Tensor, index: int, *,
                positions: Optional[torch.Tensor] = None,
                enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, PyTree]:
    """One decode step.  tokens: (B, 1) int; index: the cache offset every
    sequence shares.  The cache is updated in place.  A learned position
    table is read at row ``min(index, rows - 1)``, as the JAX package's
    ``dynamic_slice_in_dim`` clamps.  With ``enc`` (B, T, d), cross-
    attention re-projects the encoder K/V this step (the legacy path);
    without it, it reads the cache :func:`warm_cross_cache` filled.
    Returns (logits (B, vocab), cache)."""
    B = tokens.shape[0]
    index = int(index)
    x = embed_tokens(params, cfg, tokens)
    if "pos" in params["embed"]:
        pos_tab = params["embed"]["pos"]
        row = min(index, pos_tab.shape[0] - 1)
        x = x + pos_tab[row:row + 1].to(x.dtype)[None]
    if positions is None:
        positions = torch.full((B, 1), index, dtype=torch.int32,
                               device=tokens.device)
        if cfg.pos_embedding == "mrope":
            positions = positions[None].expand(3, B, 1)
    ctx: Dict[str, Any] = {"index": index, "positions": positions}
    if enc is not None:
        ctx["enc"] = enc
    for gi, g in enumerate(P.decoder_groups(cfg)):
        x, _ = group_decode(params["decoder"][f"g{gi}"], g, x,
                            cache[f"g{gi}"], cfg, ctx)
    h = norm(params["final_norm"], x, cfg)
    return lm_logits(params, cfg, h)[:, 0, :], cache


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
                     device: DeviceLike = None) -> PyTree:
    """Per-layer page pools (no batch dim — sequences share the pool via
    their block tables; block 0 is the null page, see serve.paged_cache).
    Stacked groups carry a leading depth axis, as the parameters do.  The
    pools live on the card unless ``device="cpu"`` is asked for."""
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
    positions = pos_bc
    if cfg.pos_embedding == "mrope":
        positions = pos_bc[None].expand(3, B, C)
    ctx: Dict[str, Any] = {"positions": positions,
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
