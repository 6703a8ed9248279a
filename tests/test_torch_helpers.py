"""Shared set-up for the PyTorch port's parity tests: the same tiny configs
in both packages and the JAX package's weights bridged into the port
through numpy.  Its own tests check that the two config copies agree."""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import tiny  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for a module's tests (autouse where a test
    module imports it): the tiny shapes gain nothing from more, and under
    several pytest workers every process's threads contend for the cores
    (two files took 841 s with torch's default threads, 112 s with one,
    six copies at once on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (arch, patch): GQA g=2 with QKV bias; the paper's OPT (learned positions,
# LayerNorm, GELU, tied padded head); GQA g=7, qwen2-7b's own group size
PARITY_ARCHS = [
    ("qwen2-7b", dict(num_kv_heads=2)),
    ("opt-125m", {}),
    ("qwen2-7b", dict(num_heads=7, num_kv_heads=1)),
]
ARCH_IDS = ["qwen2-g2", "opt-125m", "qwen2-g7"]


def configs(arch, **patch):
    """(JAX config, port config), tiny fp32 and field-for-field equal."""
    jcfg = tiny(jax_config(arch))
    tcfg = dataclasses.replace(torch_config(arch + "-smoke"),
                               param_dtype="float32",
                               compute_dtype="float32")
    if patch:
        jcfg = dataclasses.replace(jcfg, **patch)
        tcfg = dataclasses.replace(tcfg, **patch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def bridged(jcfg, tcfg, seed=0):
    """JAX init_params weights and the same weights as port tensors."""
    jp = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def t(x, dtype=None):
    """numpy / JAX array -> CPU tensor (a copy)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


@pytest.mark.parametrize("arch,patch", PARITY_ARCHS, ids=ARCH_IDS)
def test_config_copies_agree(arch, patch):
    jcfg, tcfg = configs(arch, **patch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.padded_vocab_size == jcfg.padded_vocab_size
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim


# the published configs' parameter counts, total and active a token
FULL_COUNTS = {"deepseek-v3-671b": (671_712_662_528, 38_135_436_288),
               "granite-3-2b": (2_533_787_648, 2_533_787_648),
               "qwen1.5-32b": (35_197_096_960, 35_197_096_960),
               "llama3-405b": (405_853_388_800, 405_853_388_800),
               "whisper-medium": (812_003_328, 812_003_328),
               "qwen2-vl-2b": (1_543_714_304, 1_543_714_304)}


@pytest.mark.parametrize("arch", ["qwen2-7b", "opt-125m", "opt-1.3b",
                                  "mixtral-8x7b", "jamba-v0.1-52b",
                                  *FULL_COUNTS])
def test_full_configs_and_param_counts_agree(arch):
    jcfg, tcfg = jax_config(arch), torch_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    if arch in FULL_COUNTS:
        assert (tcfg.param_count(), tcfg.active_param_count()) == \
            FULL_COUNTS[arch]
