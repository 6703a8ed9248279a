"""Shared fixtures.  NOTE: no --xla_force_host_platform_device_count here —
smoke tests and benches must see 1 CPU device; multi-device tests spawn
subprocesses with their own XLA_FLAGS."""

import dataclasses

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without CUDA)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def tiny(cfg, **kw):
    """Reduced fp32 variant for numerics-sensitive tests."""
    red = cfg.reduced(**kw)
    return dataclasses.replace(red, param_dtype="float32",
                               compute_dtype="float32")


def no_drop(cfg):
    """MoE variant with capacity high enough to avoid drops."""
    if not cfg.moe.enabled:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe,
                                     capacity_factor=float(cfg.moe.num_experts)))
