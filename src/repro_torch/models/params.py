"""Parameter specs, initialization and counting for the decoders the port
runs.

Port of ``repro.models.params`` for attn + mlp decoders, their
mixture-of-experts variant (``moe``), multi-head latent attention
(``mla``) with DeepSeek's dense-prefix group and multi-token-prediction
(``mtp``) block, the Mamba2 (``ssm``) stack, the jamba hybrid, whose
8-layer period stacks as one group of 16 sublayers, and whisper's
encoder-decoder (an ``encoder`` subtree of (attn, mlp) units and its
``final_norm``; decoder units of (attn, xattn, mlp)).
The parameter tree keeps the JAX layout exactly —
``wq`` (d, H, hd), group keys ``g0/s0_attn/s1_mlp`` or ``g0/s0_ssm``, a
leading ``layers`` axis on stacked groups — so weights bridged from the
JAX package (``repro_torch.bridge``) drop straight in.  The SSM decay
leaves ``A_log`` and ``dt_bias`` stay fp32 whatever ``param_dtype`` is,
as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, generator_for, resolve_device
from repro_torch.models.config import ModelConfig

PyTree = Any


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | pos
    fan_in_dims: Tuple[int, ...] = (0,)   # dims contracted by the matmul

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def tree_map(fn: Callable, tree: PyTree) -> PyTree:
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: PyTree) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like: PyTree, leaves: List[Any]) -> PyTree:
    """A tree shaped like ``like`` holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node: PyTree) -> PyTree:
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


# --------------------------------------------------------------------------- #
# Sub-layer specs
# --------------------------------------------------------------------------- #

def _norm_spec(cfg: ModelConfig, dim: int, axis: str = "embed") -> Dict[str, ParamSpec]:
    out = {"scale": ParamSpec((dim,), (axis,), "ones")}
    if cfg.norm_type == "layernorm":
        out["bias"] = ParamSpec((dim,), (axis,), "zeros")
    return out


def attn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s: Dict[str, Any] = {"norm": _norm_spec(cfg, d)}
    s["wq"] = ParamSpec((d, H, hd), ("embed", "heads", "head"))
    s["wk"] = ParamSpec((d, K, hd), ("embed", "kv_heads", "head"))
    s["wv"] = ParamSpec((d, K, hd), ("embed", "kv_heads", "head"))
    s["wo"] = ParamSpec((H, hd, d), ("heads", "head", "embed"),
                        fan_in_dims=(0, 1))
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((H, hd), ("heads", "head"), "zeros")
        s["bk"] = ParamSpec((K, hd), ("kv_heads", "head"), "zeros")
        s["bv"] = ParamSpec((K, hd), ("kv_heads", "head"), "zeros")
    return s


def mla_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, H, m = cfg.d_model, cfg.num_heads, cfg.mla
    s: Dict[str, Any] = {"norm": _norm_spec(cfg, d)}
    if m.q_lora_rank > 0:
        s["wq_a"] = ParamSpec((d, m.q_lora_rank), ("embed", "q_rank"))
        s["q_norm"] = _norm_spec(cfg, m.q_lora_rank, "q_rank")
        s["wq_b"] = ParamSpec((m.q_lora_rank, H, m.qk_head_dim),
                              ("q_rank", "heads", "head"))
    else:
        s["wq"] = ParamSpec((d, H, m.qk_head_dim), ("embed", "heads", "head"))
    # latent KV: down-projection to kv_lora_rank (+ the shared rope dims)
    s["wkv_a"] = ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "kv_rank"))
    s["kv_norm"] = _norm_spec(cfg, m.kv_lora_rank, "kv_rank")
    s["wkv_b"] = ParamSpec((m.kv_lora_rank, H,
                            m.qk_nope_head_dim + m.v_head_dim),
                           ("kv_rank", "heads", "head"))
    s["wo"] = ParamSpec((H, m.v_head_dim, d), ("heads", "head", "embed"),
                        fan_in_dims=(0, 1))
    return s


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s: Dict[str, Any] = {"norm": _norm_spec(cfg, d)}
    s["wi"] = ParamSpec((d, f), ("embed", "mlp"))
    if cfg.mlp_activation == "silu":
        s["wg"] = ParamSpec((d, f), ("embed", "mlp"))
    s["wo"] = ParamSpec((f, d), ("mlp", "embed"))
    return s


def moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, m = cfg.d_model, cfg.moe
    f = m.d_ff_expert or cfg.d_ff
    s: Dict[str, Any] = {"norm": _norm_spec(cfg, d)}
    s["router"] = ParamSpec((d, m.num_experts), ("embed", "experts"))
    s["wi"] = ParamSpec((m.num_experts, d, f), ("experts", "embed", "mlp"),
                        fan_in_dims=(1,))
    if cfg.mlp_activation == "silu":
        s["wg"] = ParamSpec((m.num_experts, d, f), ("experts", "embed", "mlp"),
                            fan_in_dims=(1,))
    s["wo"] = ParamSpec((m.num_experts, f, d), ("experts", "mlp", "embed"),
                        fan_in_dims=(1,))
    if m.num_shared_experts > 0:
        fs = f * m.num_shared_experts
        s["shared_wi"] = ParamSpec((d, fs), ("embed", "mlp"))
        if cfg.mlp_activation == "silu":
            s["shared_wg"] = ParamSpec((d, fs), ("embed", "mlp"))
        s["shared_wo"] = ParamSpec((fs, d), ("mlp", "embed"))
    return s


def ssm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, ssm = cfg.d_model, cfg.ssm
    di = ssm.d_inner(d)
    nh = ssm.num_heads(d)
    gs = ssm.n_groups * ssm.d_state
    k = ssm.conv_kernel
    s: Dict[str, Any] = {"norm": _norm_spec(cfg, d)}
    s["wz"] = ParamSpec((d, di), ("embed", "mamba_inner"))
    s["wx"] = ParamSpec((d, di), ("embed", "mamba_inner"))
    s["wB"] = ParamSpec((d, gs), ("embed", "state"))
    s["wC"] = ParamSpec((d, gs), ("embed", "state"))
    s["wdt"] = ParamSpec((d, nh), ("embed", "mamba_heads"))
    s["conv_x"] = ParamSpec((k, di), (None, "mamba_inner"))
    s["conv_B"] = ParamSpec((k, gs), (None, "state"))
    s["conv_C"] = ParamSpec((k, gs), (None, "state"))
    s["A_log"] = ParamSpec((nh,), ("mamba_heads",), "ssm_a")
    s["D"] = ParamSpec((nh,), ("mamba_heads",), "ones")
    s["dt_bias"] = ParamSpec((nh,), ("mamba_heads",), "dt_bias")
    s["gate_norm"] = ParamSpec((di,), ("mamba_inner",), "ones")
    s["out"] = ParamSpec((di, d), ("mamba_inner", "embed"))
    return s


def xattn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Cross-attention (the whisper decoder): the self-attention leaves,
    q from the decoder stream and k/v from the encoder output."""
    return attn_specs(cfg)


SUBLAYER_BUILDERS = {"attn": attn_specs, "mla": mla_specs, "mlp": mlp_specs,
                     "moe": moe_specs, "ssm": ssm_specs,
                     "xattn": xattn_specs}
# leaves drawn and kept in fp32 whatever ``param_dtype`` is
FP32_INITS = ("ssm_a", "dt_bias")


# --------------------------------------------------------------------------- #
# Layer grouping (stacked groups)
# --------------------------------------------------------------------------- #

@dataclass(frozen=True)
class ScanGroup:
    """``depth`` stacked units, each applying ``sublayers`` in order."""

    sublayers: Tuple[str, ...]
    depth: int
    first_layer: int


def _layer_signature(cfg: ModelConfig, i: int) -> Tuple[str, ...]:
    if cfg.layer_kind(i) == "ssm":
        mixer = "ssm"
    elif cfg.attention == "mla":
        mixer = "mla"
    else:
        mixer = "attn"
    if cfg.layer_is_moe(i):
        return (mixer, "moe")
    if cfg.d_ff == 0:
        return (mixer,)          # pure-SSM blocks (Mamba2) carry no FFN
    return (mixer, "mlp")


def layer_groups(cfg: ModelConfig) -> List[ScanGroup]:
    """The decoder stack as stacked groups: DeepSeek's dense prefix (the
    first ``first_dense_layers`` layers) as a group of its own, then the
    rest as one group of its repeating period."""
    sigs = [_layer_signature(cfg, i) for i in range(cfg.num_layers)]
    groups: List[ScanGroup] = []
    start = 0
    if cfg.first_dense_layers > 0:
        # as in the JAX package, the prefix is first_dense_layers deep
        # even when the model has fewer layers
        k = cfg.first_dense_layers
        assert all(s == sigs[0] for s in sigs[:k])
        groups.append(ScanGroup(sigs[0], k, 0))
        start = k
    rest = sigs[start:]
    if not rest:
        return groups
    period = 1
    for p in range(1, len(rest) + 1):
        if len(rest) % p == 0 and all(
                rest[i] == rest[i % p] for i in range(len(rest))):
            period = p
            break
    unit: List[str] = []
    for sig in rest[:period]:
        unit.extend(sig)
    groups.append(ScanGroup(tuple(unit), len(rest) // period, start))
    return groups


def encoder_groups(cfg: ModelConfig) -> List[ScanGroup]:
    """The whisper encoder: ``encoder_layers`` units of (attn, mlp)."""
    assert cfg.is_encoder_decoder
    return [ScanGroup(("attn", "mlp"), cfg.encoder_layers, 0)]


def decoder_groups(cfg: ModelConfig) -> List[ScanGroup]:
    if cfg.is_encoder_decoder:
        return [ScanGroup(("attn", "xattn", "mlp"), cfg.num_layers, 0)]
    return layer_groups(cfg)


# --------------------------------------------------------------------------- #
# Spec tree for a whole model
# --------------------------------------------------------------------------- #

def _stack(spec_tree: PyTree, depth: int) -> PyTree:
    return tree_map(lambda s: ParamSpec((depth,) + s.shape,
                                        ("layers",) + s.axes, s.init,
                                        tuple(d + 1 for d in s.fan_in_dims)),
                    spec_tree)


def group_spec(cfg: ModelConfig, group: ScanGroup) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for j, kind in enumerate(group.sublayers):
        if kind not in SUBLAYER_BUILDERS:
            raise NotImplementedError(f"sublayer {kind!r} is not ported")
        tree[f"s{j}_{kind}"] = SUBLAYER_BUILDERS[kind](cfg)
    return _stack(tree, group.depth) if group.depth > 1 else tree


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {}
    spec["embed"] = {"tok": ParamSpec((cfg.padded_vocab_size, d),
                                      ("vocab", "embed"), fan_in_dims=())}
    if cfg.pos_embedding == "learned":
        n_pos = cfg.max_target_positions or cfg.max_seq_len
        spec["embed"]["pos"] = ParamSpec((n_pos, d), (None, "embed"), "pos",
                                         fan_in_dims=())
    if cfg.is_encoder_decoder:
        spec["encoder"] = {f"g{gi}": group_spec(cfg, g)
                           for gi, g in enumerate(encoder_groups(cfg))}
        spec["encoder"]["final_norm"] = _norm_spec(cfg, d)
    spec["decoder"] = {f"g{gi}": group_spec(cfg, g)
                       for gi, g in enumerate(decoder_groups(cfg))}
    spec["final_norm"] = _norm_spec(cfg, d)
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((d, cfg.padded_vocab_size),
                                    ("embed", "vocab"))
    if cfg.mtp_depth > 0:
        # DeepSeek's MTP modules: one block each, the last layer's mixer
        # and a dense MLP at d_ff
        mixer = _layer_signature(cfg, cfg.num_layers - 1)[0]
        spec["mtp"] = {f"d{k}": {
            "proj": ParamSpec((2 * d, d), ("mlp", "embed")),
            "norm_prev": _norm_spec(cfg, d),
            "norm_emb": _norm_spec(cfg, d),
            "block": {f"s0_{mixer}": SUBLAYER_BUILDERS[mixer](cfg),
                      "s1_mlp": mlp_specs(cfg)}}
            for k in range(cfg.mtp_depth)}
    return spec


# --------------------------------------------------------------------------- #
# Materialization
# --------------------------------------------------------------------------- #

def _sinusoidal(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * i / d)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return out.astype(np.float32)


def _init_one(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device, cfg: ModelConfig) -> torch.Tensor:
    """Same distributions as ``repro.models.params._init_one``; each leaf
    is drawn directly in the parameter dtype on the device, so a bf16
    model never holds an fp32 copy of itself.  The SSM decay leaves
    (``FP32_INITS``) are drawn and kept in fp32."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "pos":
        return torch.from_numpy(_sinusoidal(*spec.shape)).to(device, dtype)
    if spec.init == "ssm_a":
        # A in [1, 16) => A_log = log(A)
        u = torch.rand(spec.shape, dtype=torch.float32, device=device,
                       generator=gen)
        return torch.log(1.0 + 15.0 * u)
    if spec.init == "dt_bias":
        lo, hi = cfg.ssm.dt_min, cfg.ssm.dt_max
        u = torch.rand(spec.shape, dtype=torch.float32, device=device,
                       generator=gen)
        dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
        return dt + torch.log(-torch.expm1(-dt))      # inverse softplus
    if spec.init != "normal":
        raise NotImplementedError(f"init {spec.init!r} is not ported")
    fan_in = max(1, int(np.prod([spec.shape[d] for d in spec.fan_in_dims]))
                 if spec.fan_in_dims else spec.shape[-1])
    out = torch.randn(spec.shape, dtype=dtype, device=device, generator=gen)
    return out.mul_(1.0 / math.sqrt(fan_in))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *, seed: int = 0) -> PyTree:
    """Random weights from a ``torch.Generator`` (seeded with ``seed`` when
    none is given).  Runs on the card unless ``device="cpu"`` is asked
    for.  Parity tests load the JAX package's weights through the bridge
    instead: the two RNGs give different numbers."""
    dev = resolve_device(device)
    gen = generator_for(dev, seed, generator)
    dtype = getattr(torch, cfg.param_dtype)
    return tree_map(lambda s: _init_one(s, gen, dtype, dev, cfg),
                    model_spec(cfg))


def _leaf_dtype(cfg: ModelConfig, spec: ParamSpec) -> torch.dtype:
    return torch.float32 if spec.init in FP32_INITS \
        else getattr(torch, cfg.param_dtype)


def abstract_params(cfg: ModelConfig) -> PyTree:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    storage): fp32 for the SSM decay leaves, ``param_dtype`` otherwise."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=_leaf_dtype(cfg, s),
                                          device="meta"), model_spec(cfg))


def param_axes(cfg: ModelConfig) -> PyTree:
    """Each leaf's logical axis names, one per dim."""
    return tree_map(lambda s: s.axes, model_spec(cfg))


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total (or per-token-active) parameter count.

    ``active_only`` scales every leaf with an ``experts`` axis (the routed
    experts and the router) by top-k/num_experts — the MoE 6·N_active·D
    convention, as in the JAX package."""
    m = cfg.moe
    total = 0
    for leaf in tree_leaves(model_spec(cfg)):
        sz = leaf.size()
        if active_only and m.enabled and "experts" in leaf.axes:
            sz = int(sz * m.experts_per_token / m.num_experts)
        total += sz
    return total
