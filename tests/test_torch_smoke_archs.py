"""The port's twin of ``tests/test_smoke_archs.py``: for each of the ten
assigned architectures, the reduced variant (2 layers, d_model <= 512,
<= 4 experts) through the port on the CPU — a finite ``forward_train``,
one optimizer step that moves every parameter leaf, decode-step shapes
(whisper against its encoder's output) — and the full configs' parameter
counts in the published ranges."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

# the assigned architectures, as ``repro/configs/registry.py`` lists them
ARCHS = ["qwen2-vl-2b", "mamba2-130m", "jamba-v0.1-52b", "deepseek-v3-671b",
         "whisper-medium", "llama3-405b", "qwen2-7b", "qwen1.5-32b",
         "granite-3-2b", "mixtral-8x7b"]


def _batch(cfg, seed=0, B=2, S=32):
    rs = np.random.RandomState(seed)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": toks, "labels": toks.clone()}
    if cfg.arch_type == "vlm":
        Sv = 8
        batch["vision_embeds"] = torch.from_numpy(
            rs.randn(B, Sv, cfg.d_model).astype(np.float32)).bfloat16()
        lbl = torch.full((B, S + Sv), -1, dtype=toks.dtype)
        lbl[:, Sv:] = toks
        batch["labels"] = lbl
        batch["positions"] = torch.arange(S + Sv, dtype=torch.int32)[
            None, None].expand(3, B, S + Sv)
    elif cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rs.randn(
            B, cfg.encoder_seq_len, cfg.d_model).astype(np.float32)
        ).bfloat16()
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_limits(arch):
    cfg = get_config(arch).reduced()
    assert cfg.num_layers <= 2 or cfg.attn_layer_period > 0
    assert cfg.d_model <= 512
    if cfg.moe.enabled:
        assert cfg.moe.num_experts <= 4
    cfg.validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_step(arch):
    cfg = get_config(arch).reduced()
    params = P.init_params(cfg, device="cpu", seed=0)
    with torch.no_grad():
        loss, metrics = M.forward_train(params, cfg, _batch(cfg))
    assert loss.shape == ()
    assert np.isfinite(float(loss)), f"{arch}: loss not finite"
    assert float(metrics["tokens"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_optimizer_step(arch):
    """Every leaf moves.  The weights are held in fp32 here: Adam's first
    step moves each by about the learning rate, 1e-3, and a bf16 weight
    near 1.0 (a norm's scale) rounds such a step away (its spacing there
    is 2**-7)."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="float32")
    params = P.init_params(cfg, device="cpu", seed=0)
    before = [p.detach().clone() for p in P.tree_leaves(params)]
    opt_cfg = adamw.OptConfig(learning_rate=1e-3, warmup_steps=0)
    opt = adamw.init_opt_state(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, remat="none")
    new_params, new_opt, metrics = step(params, opt, _batch(cfg))
    assert int(new_opt["step"]) == 1
    assert np.isfinite(float(metrics["loss"]))
    keys = [k for k, _ in flatten(new_params)]
    for key, a, b in zip(keys, before, P.tree_leaves(new_params)):
        assert a.shape == b.shape and a.dtype == b.dtype, key
        assert torch.isfinite(b.float()).all(), key
        assert float((a.float() - b.detach().float()).abs().max()) > 0, \
            f"{arch}: the optimizer step did not move {key}"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_shapes(arch):
    cfg = get_config(arch).reduced()
    B, T = 2, 16
    params = P.init_params(cfg, device="cpu", seed=0)
    cache = M.init_cache(cfg, B, T, device="cpu")
    enc = None
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            frames = torch.randn(B, cfg.encoder_seq_len, cfg.d_model,
                                 generator=torch.Generator().manual_seed(0))
            enc = M.encoder_forward(params, cfg, frames.bfloat16(), {})
            assert enc.shape == (B, cfg.encoder_seq_len, cfg.d_model)
        tok = torch.randint(0, cfg.vocab_size, (B, 1),
                            generator=torch.Generator().manual_seed(1))
        logits, cache = M.decode_step(params, cfg, cache, tok, 0, enc=enc)
        logits, cache = M.decode_step(params, cfg, cache, tok, 1, enc=enc)
    assert logits.shape == (B, cfg.padded_vocab_size)
    assert torch.isfinite(logits[:, :cfg.vocab_size].float()).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_published(arch):
    """Full configs: exact parameter counts in the published ballpark."""
    expected_b = {
        "qwen2-vl-2b": (1.2, 1.8),       # LM backbone of the 2B model
        "mamba2-130m": (0.12, 0.14),
        "jamba-v0.1-52b": (50, 53),
        "deepseek-v3-671b": (660, 685),
        "whisper-medium": (0.7, 0.9),
        "llama3-405b": (400, 412),
        "qwen2-7b": (7.0, 7.8),
        "qwen1.5-32b": (30, 36),
        "granite-3-2b": (2.3, 2.7),
        "mixtral-8x7b": (45, 48),
    }
    lo, hi = expected_b[arch]
    n = get_config(arch).param_count() / 1e9
    assert lo <= n <= hi, f"{arch}: {n:.2f}B not in [{lo},{hi}]"
