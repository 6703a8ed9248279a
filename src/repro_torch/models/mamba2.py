"""Mamba2 (SSD) mixer sublayer: full-sequence (prefill) and decode (port
of ``repro.models.mamba2``).

Projection layout follows the JAX package: *separate* z/x/B/C/dt
projections instead of one fused ``in_proj`` (mathematically identical).
The full-sequence pass runs the SSD scan through the CUDA kernel
(``use_kernel=True``; its plain version on CPU tensors) or through the
plain oracle ``ssd_reference``; the decode step runs the recurrence
``ssd_step`` against a dense fp32 cache.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.act_sharding import (BATCH, REPLICATED,
                                                  axis_extent, by_rows,
                                                  constrain, is_sharded,
                                                  scan_parallel)
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import norm, rms_gate_norm


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B,S,C); w: (K,C).  The sum of shifted
    slices in x's dtype, in the JAX package's order."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    S = x.shape[1]
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i].to(x.dtype)
    return out


def _conv_step(buf: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step causal conv.  buf: (B,K-1,C) past inputs; x_t: (B,C).
    Returns (y (B,C), the new buffer)."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)           # (B,K,C)
    y = (window * w.to(x_t.dtype)).sum(dim=1)
    return y, window[:, 1:, :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0) at every x.
    ``F.softplus`` returns x itself above its threshold of 20, which
    differs from this by under exp(-20) there."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _project(p: Dict[str, Any], h: torch.Tensor):
    z = h @ p["wz"].to(h.dtype)
    x = h @ p["wx"].to(h.dtype)
    B = h @ p["wB"].to(h.dtype)
    C = h @ p["wC"].to(h.dtype)
    dt = _softplus((h @ p["wdt"].to(h.dtype)).float()
                   + p["dt_bias"].float())
    return z, x, B, C, dt


def ssm_forward(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                use_kernel: bool = True) -> torch.Tensor:
    """Full-sequence Mamba2 sublayer.  x: (B,S,d).  ``use_kernel`` runs the
    scan through ``ops.ssd`` (the CUDA kernel, which has no backward),
    else through ``ssd_reference``; on DTensors each rank scans its own
    rows and heads (``act_sharding.scan_parallel``)."""
    ssm = cfg.ssm
    Bsz, S, d = x.shape
    nh = ssm.num_heads(d)

    h = norm(p["norm"], x, cfg)
    # the mixer's inputs pinned (and so their gradients): channels and
    # heads over model, B and C whole, the sequence never split
    heads = _heads_part(nh)
    z, xin, Bp, Cp, dt = (constrain(t, BATCH, None, part) for t, part in zip(
        _project(p, h), ("model", heads, REPLICATED, REPLICATED, "model")))
    xin = constrain(F.silu(_causal_conv(xin, p["conv_x"])), BATCH, None,
                    heads)
    Bp = constrain(F.silu(_causal_conv(Bp, p["conv_B"])), BATCH, None,
                   REPLICATED)
    Cp = constrain(F.silu(_causal_conv(Cp, p["conv_C"])), BATCH, None,
                   REPLICATED)

    xh = xin.reshape(Bsz, S, nh, ssm.head_dim)
    Bh = Bp.reshape(Bsz, S, ssm.n_groups, ssm.d_state)
    Ch = Cp.reshape(Bsz, S, ssm.n_groups, ssm.d_state)
    A = -ssd_ref.exp_fp64(p["A_log"].float())

    scan = ssd if use_kernel else ssd_ref.ssd_reference
    scan = functools.partial(scan, chunk_size=ssm.chunk_size)
    if is_sharded(xh):            # each rank scans its own rows and heads
        y = scan_parallel(scan, xh, dt, A, Bh, Ch)
    else:
        y = scan(xh, dt, A, Bh, Ch)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(Bsz, S, ssm.d_inner(d))
    # column-parallel into the out projection, as Megatron lays out an MLP
    y = constrain(rms_gate_norm(p["gate_norm"], y, z, cfg.norm_eps), BATCH,
                  None, "model")
    return x + y @ p["out"].to(x.dtype)


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The recurrent state and the conv buffers of one sublayer, in fp32
    whatever the model's dtype (as the JAX package's dense decode path
    keeps them).  On the card unless ``device="cpu"`` is asked for."""
    dev = resolve_device(device)
    ssm = cfg.ssm
    d = cfg.d_model
    di, nh = ssm.d_inner(d), ssm.num_heads(d)
    gs = ssm.n_groups * ssm.d_state
    K = ssm.conv_kernel

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return {"state": zeros(batch, nh, ssm.head_dim, ssm.d_state),
            "conv_x": zeros(batch, K - 1, di),
            "conv_B": zeros(batch, K - 1, gs),
            "conv_C": zeros(batch, K - 1, gs)}


def _heads_part(nh: int):
    """The x channels' part under a mesh: over ``model`` where it divides
    the heads, so that each rank's channels are whole heads, else whole
    (the split into heads then needs no uneven reshape)."""
    return "model" if nh % axis_extent("model") == 0 else REPLICATED


def _step(state, x, dt, B, C, A):
    return ssd_ref.ssd_step(state, x, dt, A, B, C)


def ssm_decode(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
               cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode.  x: (B,1,d).  The conv buffers step in h's
    dtype and are stored back in the cache's; returns (y, new cache)."""
    ssm = cfg.ssm
    Bsz, _, d = x.shape
    nh = ssm.num_heads(d)

    h = norm(p["norm"], x, cfg)[:, 0, :]                          # (B,d)
    z, xin, Bp, Cp, dt = _project(p, h)                           # dt (B,nh)

    xin, conv_x = _conv_step(cache["conv_x"].to(h.dtype), xin, p["conv_x"])
    Bp, conv_B = _conv_step(cache["conv_B"].to(h.dtype), Bp, p["conv_B"])
    Cp, conv_C = _conv_step(cache["conv_C"].to(h.dtype), Cp, p["conv_C"])
    xin, Bp, Cp = F.silu(xin), F.silu(Bp), F.silu(Cp)

    xh = constrain(xin, BATCH, _heads_part(nh)).reshape(Bsz, nh,
                                                        ssm.head_dim)
    Bh = Bp.reshape(Bsz, ssm.n_groups, ssm.d_state)
    Ch = Cp.reshape(Bsz, ssm.n_groups, ssm.d_state)
    A = -ssd_ref.exp_fp64(p["A_log"].float())

    if is_sharded(xh):              # each rank steps its own rows
        y, state = by_rows(_step, cache["state"], xh, dt, Bh, Ch, whole=(A,),
                           outs=2)
    else:
        y, state = ssd_ref.ssd_step(cache["state"], xh, dt, A, Bh, Ch)
    y = y + p["D"].to(y.dtype)[None, :, None] * xh
    y = y.reshape(Bsz, 1, ssm.d_inner(d))
    y = rms_gate_norm(p["gate_norm"], y, z[:, None, :], cfg.norm_eps)
    out = x + y @ p["out"].to(x.dtype)
    new_cache = {"state": state.to(cache["state"].dtype),
                 "conv_x": conv_x.to(cache["conv_x"].dtype),
                 "conv_B": conv_B.to(cache["conv_B"].dtype),
                 "conv_C": conv_C.to(cache["conv_C"].dtype)}
    return out, new_cache
