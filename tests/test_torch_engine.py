"""The port's ``ServeEngine`` against the JAX package's: the same bridged
weights and requests give the same greedy completions token for token
and the same deterministic stats, with nothing leaked, for a dense
(qwen2) and a mixture-of-experts (mixtral) model."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.faultinject import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.core.energy.devices import CLOUD_H100  # noqa: E402
from repro_torch.core.faultinject import FaultPlan  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

from test_torch_helpers import bridged, configs  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401

STATS = ("steps", "tokens_generated", "prefix_hit_tokens", "cow_forks_total",
         "peak_cache_bytes", "requests_failed")
BASE = dict(max_slots=3, block_size=4, num_blocks=40, max_blocks_per_seq=10)
SETUPS = {
    "default": {},
    "preemption": dict(num_blocks=9, max_blocks_per_seq=8),
    "token-by-token": dict(prefill_chunk=1, prefix_sharing=False),
    "int8": dict(cache_dtype="int8"),
    "injected-crashes": dict(max_requeues=2),
}


# (arch, patch): GQA g=2 with QKV bias; the MoE family (4 experts, top-2,
# a 6-token window), whose decode steps dispatch over the flat batch and
# whose chunk steps per row, idle slots and padding rows included
MODELS = {"qwen2-g2": ("qwen2-7b", dict(num_kv_heads=2)),
          "mixtral": ("mixtral-8x7b", dict(num_kv_heads=2,
                                           sliding_window=6))}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    arch, patch = MODELS[request.param]
    jcfg, tcfg = configs(arch, **patch)
    jp, tp = bridged(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _mixed(Request, vocab, n=5):
    """tests/test_serve_engine.py::_mixed_requests."""
    return [Request(uid=f"r{i}", max_new=5 + (3 * i) % 7,
                    prompt=list(map(int, np.random.RandomState(i).randint(
                        0, vocab, 3 + 3 * i))))
            for i in range(n)]


def _shared(Request, vocab):
    """tests/test_serve_engine.py's shared-prefix workload."""
    sys_p = list(map(int, np.random.RandomState(7).randint(0, vocab, 17)))
    return [Request(uid=f"r{i}", max_new=5,
                    prompt=sys_p + list(map(int, np.random.RandomState(
                        50 + i).randint(0, vocab, 3 + i))))
            for i in range(4)]


def _run_both(model, ecfg_kw, workload, fault_seed=None):
    jcfg, tcfg, jp, tp = model
    kw = dict(BASE, **ecfg_kw)
    jplan = tplan = None
    if fault_seed is not None:
        jplan = JaxFaultPlan(seed=fault_seed, crash_prob=0.15)
        tplan = FaultPlan(seed=fault_seed, crash_prob=0.15)
    je = JE.ServeEngine(jp, jcfg, JE.EngineConfig(**kw), fault_plan=jplan)
    te = TE.ServeEngine(tp, tcfg, TE.EngineConfig(**kw), torch_device="cpu",
                        fault_plan=tplan)
    jo = je.run(workload(JE.Request, jcfg.vocab_size))
    to = te.run(workload(TE.Request, tcfg.vocab_size))
    return je, te, jo, to


def _assert_same(je, te, jo, to):
    assert set(jo) == set(to)
    for uid in jo:
        assert to[uid].tokens == jo[uid].tokens, uid
        assert to[uid].preemptions == jo[uid].preemptions, uid
        assert to[uid].failed == jo[uid].failed, uid
    js, ts = je.stats(), te.stats()
    for key in STATS:
        assert ts[key] == js[key], key
    assert te.kv.allocator.num_free == te.kv.allocator.num_usable


@pytest.mark.parametrize("setup", list(SETUPS))
def test_engine_greedy_matches_jax_engine(model, setup):
    fault_seed = 3 if setup == "injected-crashes" else None
    je, te, jo, to = _run_both(model, SETUPS[setup], _mixed, fault_seed)
    _assert_same(je, te, jo, to)
    if setup == "preemption":
        assert sum(c.preemptions for c in to.values()) > 0
    if setup == "injected-crashes":
        assert te.injector.counts.get("crash", 0) > 0
        assert te.injector.counts == je.injector.counts


def test_engine_shared_prefix_workload_matches_jax_engine(model):
    je, te, jo, to = _run_both(model, dict(max_slots=2, num_blocks=64,
                                           max_blocks_per_seq=16), _shared)
    _assert_same(je, te, jo, to)
    assert te.stats()["prefix_hit_tokens"] > 0


def test_engine_warmup_reset_and_energy_profile(model):
    _, tcfg, _, tp = model
    eng = TE.ServeEngine(tp, tcfg, TE.EngineConfig(**BASE),
                         torch_device="cpu")
    assert eng.device is CLOUD_H100 and eng.ecfg.attn_impl == "kernel"
    eng.warmup()
    assert eng.monitor.total_j > 0 and "_warmup" not in eng.completions
    eng.reset_stats()
    assert eng.monitor.total_j == 0 and eng.steps == 0
    eng.run([TE.Request(uid="a", prompt=list(range(1, 8)), max_new=4)])
    s = eng.stats()
    assert s["tokens_generated"] == 4 and s["j_per_token"] > 0
    assert "inter_token_p99_s" in s


def test_engine_rejects_bad_inputs(model):
    _, tcfg, _, tp = model
    with pytest.raises(ValueError):
        TE.ServeEngine(tp, tcfg, TE.EngineConfig(attn_impl="pallas"),
                       torch_device="cpu")
    eng = TE.ServeEngine(tp, tcfg, TE.EngineConfig(
        max_slots=2, block_size=4, num_blocks=6, max_blocks_per_seq=4),
        torch_device="cpu")
    with pytest.raises(ValueError):
        eng.submit(TE.Request(uid="big", prompt=list(range(30)), max_new=10))
    with pytest.raises(ValueError):
        eng.submit(TE.Request(uid="empty", prompt=[1, 2], max_new=0))


def test_engine_deadline_failures_match_jax(model):
    """A zero-length TTFT deadline fails every queued request that has not
    produced a token, in both engines alike."""
    je, te, jo, to = _run_both(
        model, dict(max_slots=1, ttft_deadline_s=1e-9), _mixed)
    _assert_same(je, te, jo, to)
    assert te.stats()["deadline_failures"] > 0


def test_sampling_config_changes_nothing_for_greedy(model):
    _, tcfg, _, tp = model
    outs = []
    for seed in (0, 1):
        eng = TE.ServeEngine(tp, tcfg, TE.EngineConfig(**BASE, seed=seed),
                             torch_device="cpu")
        out = eng.run(_mixed(TE.Request, tcfg.vocab_size, n=2))
        outs.append({u: c.tokens for u, c in out.items()})
    assert outs[0] == outs[1]
    assert dataclasses.replace(TE.EngineConfig(), seed=5).seed == 5
