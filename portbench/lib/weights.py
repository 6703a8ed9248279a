"""Weights made from the seed, on the device, in the type they are
trained in: one ``normal_`` call over a flat buffer for every weight
matrix (each leaf a view of it, scaled by 1/sqrt(its fan-in)), ones for
the norm scales and zeros for the biases.  The same seed and device give
the same weights, so the reference makes them again rather than keeping
a copy.

The tree is laid out as the port's dense decoders take it (``embed/tok``,
``embed/pos``, ``decoder/g0/s0_attn``, ``decoder/g0/s1_mlp`` with a
leading layers axis, ``final_norm``), written out here so that the
benchmark does not read it from the program.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Spec = Tuple[Tuple[int, ...], str, int]      # (shape, init, fan_in)


def padded_vocab(model: Dict[str, Any]) -> int:
    m = model.get("vocab_pad_multiple", 128)
    v = model["vocab_size"]
    return -(-v // m) * m if m > 0 else v


def _norm(model: Dict[str, Any], lead: Tuple[int, ...]) -> Dict[str, Spec]:
    d = model["d_model"]
    out = {"scale": (lead + (d,), "ones", 0)}
    if model["norm_type"] == "layernorm":
        out["bias"] = (lead + (d,), "zeros", 0)
    return out


def specs(model: Dict[str, Any]) -> Dict[str, Any]:
    """The nested tree of (shape, init, fan_in) for a dense decoder."""
    d, L = model["d_model"], model["num_layers"]
    H, K = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    f = model["d_ff"]
    lead = (L,) if L > 1 else ()
    attn: Dict[str, Any] = {
        "norm": _norm(model, lead),
        "wq": (lead + (d, H, hd), "normal", d),
        "wk": (lead + (d, K, hd), "normal", d),
        "wv": (lead + (d, K, hd), "normal", d),
        "wo": (lead + (H, hd, d), "normal", H * hd)}
    if model.get("qkv_bias"):
        attn["bq"] = (lead + (H, hd), "zeros", 0)
        attn["bk"] = (lead + (K, hd), "zeros", 0)
        attn["bv"] = (lead + (K, hd), "zeros", 0)
    mlp: Dict[str, Any] = {"norm": _norm(model, lead),
                           "wi": (lead + (d, f), "normal", d),
                           "wo": (lead + (f, d), "normal", f)}
    if model["mlp_activation"] == "silu":
        mlp["wg"] = (lead + (d, f), "normal", d)
    embed: Dict[str, Any] = {"tok": ((padded_vocab(model), d), "normal", d)}
    if model["pos_embedding"] == "learned":
        embed["pos"] = ((model["max_target_positions"], d), "normal", d)
    tree = {"embed": embed,
            "decoder": {"g0": {"s0_attn": attn, "s1_mlp": mlp}},
            "final_norm": _norm(model, ())}
    if not model.get("tie_embeddings"):
        tree["lm_head"] = ((d, padded_vocab(model)), "normal", d)
    return tree


def paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, ...]]:
    """Leaf paths in sorted-key order (the order ``jax.tree.leaves`` and
    the port's ``tree_leaves`` use)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]
    return [prefix]


def get(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def leaves(tree: Any) -> List[Any]:
    return [get(tree, p) for p in paths(tree)]


def seed_bits(seed: int) -> int:
    return seed % (1 << 63)


def make(model: Dict[str, Any], seed: int, device: torch.device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The weights of ``model`` from ``seed`` on ``device``."""
    sp = specs(model)
    ps = paths(sp)
    normal = [p for p in ps if get(sp, p)[1] == "normal"]
    total = sum(math.prod(get(sp, p)[0]) for p in normal)
    gen = torch.Generator(device=device).manual_seed(seed_bits(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    out: Dict[str, Any] = {}
    off = 0
    for p in ps:
        shape, init, fan_in = get(sp, p)
        if init == "normal":
            n = math.prod(shape)
            t = flat[off:off + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
            off += n
        elif init == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.zeros(shape, dtype=dtype, device=device)
        node = out
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = t
    return out
