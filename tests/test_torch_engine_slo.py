"""The port engine's SLO brownout against the JAX engine's, on
``tests/test_torch_engine.py``'s mixed-length traces: while the TTFT SLO
burns, admission stops past half the slots, and the same requests defer
the same admissions with the same greedy ids; an SLO that never burns
changes nothing."""

import pytest

pytest.importorskip("torch")

from repro.obs import MetricsRegistry as JReg  # noqa: E402
from repro.obs import slo as JS  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.obs import MetricsRegistry as TReg  # noqa: E402
from repro_torch.obs import slo as TS  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

from test_torch_engine import BASE, MODELS, _assert_same, _mixed  # noqa: E402
from test_torch_helpers import bridged, configs  # noqa: E402
from test_torch_helpers import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def qwen2():
    arch, patch = MODELS["qwen2-g2"]
    jcfg, tcfg = configs(arch, **patch)
    jp, tp = bridged(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def _slos(S, kind):
    """An SLO set of each package: ``bad`` (a TTFT target every request
    misses, small windows so it burns after 4), ``stock`` (the launcher's
    ``serve_slos`` with a target every request misses), ``never`` (one no
    request reaches)."""
    if kind == "bad":
        return [S.SLOSpec("serve_ttft", "latency", 1e-9, objective=0.9,
                          fast_window=4, slow_window=16)]
    return S.serve_slos(ttft_p99_s=1e-9 if kind == "stock" else 1e9,
                        inter_token_p99_s=1e9)


def _run(model, kind, n, slots=4):
    jcfg, tcfg, jp, tp = model
    kw = dict(BASE, max_slots=slots, num_blocks=128, max_blocks_per_seq=24)
    mons = []
    if kind is not None:
        mons = [JS.SLOMonitor(_slos(JS, kind), registry=JReg()),
                TS.SLOMonitor(_slos(TS, kind), registry=TReg())]
    je = JE.ServeEngine(jp, jcfg, JE.EngineConfig(**kw),
                        slo=mons[0] if mons else None)
    te = TE.ServeEngine(tp, tcfg, TE.EngineConfig(**kw), torch_device="cpu",
                        slo=mons[1] if mons else None)
    admitted = []                       # (live slots before, burning)
    open_slot = te.kv.open_slot

    def spy(slot, prompt=None):
        live = sum(s is not None for s in te._slots)
        admitted.append((live, bool(mons) and mons[1].burning("serve_ttft")))
        return open_slot(slot, prompt)
    te.kv.open_slot = spy
    jo = je.run(_mixed(JE.Request, jcfg.vocab_size, n))
    to = te.run(_mixed(TE.Request, tcfg.vocab_size, n))
    return je, te, jo, to, mons, admitted


@pytest.mark.parametrize("kind,n", [("bad", 12), ("stock", 24)])
def test_burning_ttft_defers_the_same_admissions_as_jax(qwen2, kind, n):
    je, te, jo, to, (jm, tm), admitted = _run(qwen2, kind, n)
    _assert_same(je, te, jo, to)
    deferred = te.metrics.counter("serve/admission_deferred").value
    assert deferred == je.metrics.counter("serve/admission_deferred").value
    assert deferred > 0 and tm.burning("serve_ttft")
    assert tm.verdicts() == jm.verdicts()
    assert [e["event"] for e in tm.events] == \
        [e["event"] for e in jm.events]
    # after the burn began no admission found half the slots or more live
    assert any(b for _, b in admitted)
    assert all(live < te.ecfg.max_slots // 2 for live, b in admitted if b)
    assert all(len(c.tokens) > 0 and not c.failed for c in to.values())


def test_an_slo_that_never_burns_changes_nothing(qwen2):
    je, te, jo, to, (jm, tm), _ = _run(qwen2, "never", 12)
    _, plain, _, po, _, _ = _run(qwen2, None, 12)
    _assert_same(je, te, jo, to)
    assert {u: c.tokens for u, c in to.items()} == \
        {u: c.tokens for u, c in po.items()}
    assert te.steps == plain.steps
    assert te.metrics.counter("serve/admission_deferred").value == 0
    v = {x["slo"]: x for x in tm.verdicts()}
    assert v["serve_ttft"]["observations"] == 12 and v["serve_ttft"]["ok"]
    assert v["serve_inter_token"]["observations"] == \
        te.tokens_generated - 12
    assert tm.verdicts() == jm.verdicts()


def test_launcher_serves_with_slo_and_writes_a_valid_record(tmp_path,
                                                           capsys):
    from repro_torch.launch import serve
    from repro_torch.obs.validate import validate
    rec = tmp_path / "health.jsonl"
    serve.main(["--torch-device", "cpu", "--batch", "20", "--max-new", "4",
                "--slo", "ttft=0.000000001,itl=1000", "--health-out",
                str(rec)])
    out = capsys.readouterr().out
    assert "admissions deferred under burn:" in out
    assert "serve_ttft:BREACH" in out
    counts = validate(str(rec))
    assert counts["slo"] == 2 and counts["health_summary"] == 1
