"""The port's fleet-health layer against the JAX package's: the streaming
detectors, the SLO burn-rate monitor, the ``--health-out`` artifact, the
schema validator and the offline analyzer, fed the same observation
streams and artifacts.  Alerts, verdicts, events, records, tables and exit
codes must be equal (wall-clock fields excluded: every observation here
carries its own timestamp)."""

import json
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.obs import analyze as JA  # noqa: E402
from repro.obs import health as JH  # noqa: E402
from repro.obs import slo as JS  # noqa: E402
from repro.obs import validate as JV  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JReg  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro_torch.obs import analyze as TA  # noqa: E402
from repro_torch.obs import health as TH  # noqa: E402
from repro_torch.obs import slo as TS  # noqa: E402
from repro_torch.obs import validate as TV  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry as TReg  # noqa: E402
from repro_torch.obs.trace import Tracer as TTracer  # noqa: E402


def _monitors():
    """(JAX HealthMonitor, port HealthMonitor), each with its own enabled
    tracer so their timelines can be compared too."""
    jt = JTracer(enabled=True, process="p")
    tt = TTracer(enabled=True, process="p")
    return (JH.HealthMonitor(registry=JReg(), tracer=jt),
            TH.HealthMonitor(registry=TReg(), tracer=tt))


def _alerts(hm):
    return [(a.kind, a.detector, a.entity, a.value, a.threshold, a.ts_s,
             a.severity, a.detail) for a in hm.alerts]


def _instants(tracer):
    return [(e["name"], e["cat"], e.get("args", {}))
            for e in tracer.events if e.get("ph") == "i"]


def _same_state(jh, th):
    assert _alerts(jh) == _alerts(th)
    assert jh.stragglers() == th.stragglers()
    assert jh.degraded_links() == th.degraded_links()
    assert jh.summary() == th.summary()
    assert jh.summary_line() == th.summary_line()
    assert jh.counts == th.counts
    assert _instants(jh.tracer) == _instants(th.tracer)
    for name in ("health/straggler", "health/link", "health/loss",
                 "health/alerts"):
        assert jh.registry.counter(name).value == \
            th.registry.counter(name).value


def _feed(monitors, ops):
    """Apply the same observation ops to every monitor; returns the list
    of (JAX, port) return values per op."""
    outs = []
    for op, *args in ops:
        got = []
        for hm in monitors:
            fn = {"step": hm.observe_step, "link": hm.observe_link,
                  "loss": hm.observe_loss, "overdue": hm.check_overdue}[op]
            if op == "loss":
                a = fn(args[0], ts_s=args[1])
            else:
                a = fn(args[0], args[1], ts_s=args[2])
            got.append(None if a is None else a.kind)
        outs.append(tuple(got))
    return outs


def _stream(kind, seed):
    """Seeded observation streams with known injection points, the shapes
    the JAX package's health tests calibrate on."""
    rng = np.random.default_rng(seed)
    ops = []
    if kind == "straggler":             # entity 4 turns 6x slow at t=5
        for t in range(20):
            for r in range(6):
                d = 0.2 * (1 + 0.05 * rng.standard_normal())
                ops.append(("step", r, d * (6.0 if r == 4 and t >= 5
                                            else 1.0), float(t)))
    elif kind == "clears":              # slow for 8 rounds, then healthy
        for t in range(40):
            for r in range(5):
                slow = r == 2 and 3 <= t < 11
                ops.append(("step", r, (1.5 if slow else 0.2)
                            * (1 + 0.02 * rng.standard_normal()), float(t)))
    elif kind == "overdue":             # flagged before its first report
        for t in range(6):
            for r in range(4):
                ops.append(("step", r, 0.2 + 0.01 * rng.random(), float(t)))
        ops.append(("overdue", 7, 0.9, 6.0))
        ops.append(("overdue", 7, 0.9, 6.5))
    elif kind == "link":                # two flaps on link 1
        for t in range(30):
            for r in range(3):
                d = 0.1 * (1 + 0.03 * rng.standard_normal())
                if r == 1 and t in (12, 20):
                    d += 2.0
                ops.append(("link", r, d, float(t)))
    elif kind == "loss":                # a spike, then divergence
        for t in range(60):
            v = 3.0 - 0.01 * t + 0.02 * rng.standard_normal()
            if t == 25:
                v += 4.0
            if t >= 40:
                v += 0.5 * (t - 39)
            ops.append(("loss", v, float(t)))
    elif kind == "non_finite":
        for t in range(10):
            ops.append(("loss", 2.0 + 0.01 * t, float(t)))
        ops.append(("loss", float("nan"), 10.0))
    return ops


@pytest.mark.parametrize("kind", ["straggler", "clears", "overdue", "link",
                                  "loss", "non_finite"])
@pytest.mark.parametrize("seed", [0, 1])
def test_health_monitor_matches_jax_on_seeded_streams(kind, seed):
    jh, th = _monitors()
    outs = _feed((jh, th), _stream(kind, seed))
    assert all(a == b for a, b in outs)
    assert any(a is not None for a, _ in outs), "the stream must alert"
    _same_state(jh, th)
    assert jh.diverged == th.diverged


def test_health_monitor_matches_jax_on_random_streams():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st
    op = st.one_of(
        st.tuples(st.just("step"), st.integers(0, 5), st.floats(0.01, 5.0)),
        st.tuples(st.just("link"), st.integers(0, 3), st.floats(0.01, 3.0)),
        st.tuples(st.just("overdue"), st.integers(0, 7),
                  st.floats(0.01, 6.0)),
        st.tuples(st.just("loss"),
                  st.one_of(st.floats(0.1, 20.0),
                            st.sampled_from([float("nan"), float("inf")]))))

    @settings(max_examples=40, deadline=None)
    @given(st.lists(op, min_size=1, max_size=120))
    def prop(raw):
        jh, th = _monitors()
        ops = [(o[0], *o[1:], float(i)) for i, o in enumerate(raw)]
        outs = _feed((jh, th), ops)
        assert all(a == b for a, b in outs)
        _same_state(jh, th)

    prop()


def test_slo_monitor_matches_jax_on_random_streams():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st
    names = st.sampled_from(["serve_ttft", "serve_inter_token",
                             "serve_gco2e", "other"])
    values = st.one_of(st.floats(0.0, 2.0), st.just(float("inf")))

    @settings(max_examples=40, deadline=None)
    @given(st.lists(st.tuples(names, values), min_size=1, max_size=300))
    def prop(obs):
        mons = _slo_monitors(serve_slos_kw=dict(
            ttft_p99_s=0.5, inter_token_p99_s=0.2, gco2e_budget=1.0,
            horizon_s=100.0))
        for i, (name, v) in enumerate(obs):
            got = [m.observe(name, v, t=float(i)) for m in mons]
            assert got[0] == got[1]
        _same_slo(*mons)

    prop()


def _slo_monitors(specs=None, serve_slos_kw=None, train_slos_kw=None):
    pair = []
    for S, Reg, Tr in ((JS, JReg, JTracer), (TS, TReg, TTracer)):
        if serve_slos_kw is not None:
            sp = S.serve_slos(**serve_slos_kw)
        elif train_slos_kw is not None:
            sp = S.train_slos(**train_slos_kw)
        else:
            sp = [S.SLOSpec(**k) for k in specs]
        pair.append(S.SLOMonitor(sp, registry=Reg(),
                                 tracer=Tr(enabled=True, process="p")))
    return pair


def _same_slo(jm, tm):
    assert jm.verdicts() == tm.verdicts()
    assert jm.events == tm.events
    assert jm.summary_line() == tm.summary_line()
    assert jm.worst() == tm.worst()
    for name in jm.states:
        assert jm.burning(name) == tm.burning(name)
        assert jm.burn_rate(name) == tm.burn_rate(name)
    assert _instants(jm.tracer) == _instants(tm.tracer)
    for c in ("slo/breaches", "slo/recoveries"):
        assert jm.registry.counter(c).value == tm.registry.counter(c).value


@pytest.mark.parametrize("case", ["breach_recover", "not_enough_signal",
                                  "budget", "throughput", "staleness"])
def test_slo_monitor_matches_jax(case):
    if case == "breach_recover":
        jm, tm = _slo_monitors(specs=[dict(name="lat", kind="latency",
                                           target=0.25, objective=0.9,
                                           fast_window=8, slow_window=32)])
        stream = [("lat", 0.1)] * 20 + [("lat", 0.9)] * 30 \
            + [("lat", 0.1)] * 80
    elif case == "not_enough_signal":
        jm, tm = _slo_monitors(serve_slos_kw=dict(ttft_p99_s=0.01))
        stream = [("serve_ttft", 0.9)] * 15
    elif case == "budget":
        jm, tm = _slo_monitors(train_slos_kw=dict(gco2e_budget=2.0,
                                                  horizon_s=100.0))
        stream = [("train_gco2e", 0.5)] * 6
    elif case == "throughput":
        jm, tm = _slo_monitors(train_slos_kw=dict(tokens_per_s_floor=100.0))
        stream = [("train_tokens_per_s", 40.0)] * 16 \
            + [("train_tokens_per_s", 400.0)] * 40
    else:
        jm, tm = _slo_monitors(train_slos_kw=dict(staleness_bound=1.0))
        stream = [("train_staleness", float(i % 3)) for i in range(50)]
    for i, (name, v) in enumerate(stream):
        assert jm.observe(name, v, t=float(i)) == \
            tm.observe(name, v, t=float(i))
    _same_slo(jm, tm)
    if case == "breach_recover":
        assert [e["event"] for e in tm.events] == ["slo.breach",
                                                   "slo.recovered"]


def test_slo_spec_rejects_what_jax_rejects():
    for kw in (dict(name="x", kind="bogus", target=1.0),
               dict(name="x", kind="budget", target=1.0),
               dict(name="x", kind="latency", target=1.0, objective=1.0)):
        with pytest.raises(ValueError) as je:
            JS.SLOSpec(**kw)
        with pytest.raises(ValueError) as te:
            TS.SLOSpec(**kw)
        assert str(je.value) == str(te.value)
    with pytest.raises(ValueError, match="duplicate"):
        TS.SLOMonitor(TS.serve_slos() + TS.serve_slos())


# --------------------------------------------------------------------------- #
# The --health-out artifact, the validator and the analyzer
# --------------------------------------------------------------------------- #

def _artifacts(tmp_path):
    """The same run recorded by both packages: a Chrome trace with spans,
    alert and SLO instants, and a --health-out JSONL; returns
    {name: (JAX path, port path)}."""
    out = {}
    for tag, H, S, Reg, Tr in (("j", JH, JS, JReg, JTracer),
                               ("t", TH, TS, TReg, TTracer)):
        tr = Tr(enabled=True, process="test")
        hm = H.HealthMonitor(registry=Reg(), tracer=tr)
        slo = S.SLOMonitor(S.serve_slos(ttft_p99_s=0.01), registry=Reg(),
                           tracer=tr)
        for t in range(10):
            tr.complete("round", ts_s=float(t), dur_s=0.9, cat="train",
                        round=t, region=("europe", "asia")[t % 2])
            tr.complete("inner_step", ts_s=t + 0.1, dur_s=0.5,
                        cat="train", region="europe")
            tr.complete("outer_sync", ts_s=t + 0.7, dur_s=0.1 + 0.01 * t,
                        cat="train")
            for r in range(4):
                hm.observe_step(r, 1.5 if r == 1 else 0.2, ts_s=float(t))
        for t in range(32):
            slo.observe("serve_ttft", 0.9, t=float(t))
        hm.observe_loss(float("inf"), ts_s=11.0)
        trace = tmp_path / f"{tag}_trace.json"
        tr.save_chrome_trace(str(trace))
        rec = tmp_path / f"{tag}_health.jsonl"
        hm.dump_jsonl(str(rec), slo=slo, meta={"run": "test"})
        out.setdefault("trace", []).append(str(trace))
        out.setdefault("health", []).append(str(rec))
    return out


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _strip_ts(events):
    """Chrome events without the fields a tracer stamps itself (pid/tid
    numbering is per process)."""
    return [{k: v for k, v in e.items() if k not in ("pid", "tid")}
            for e in events if e.get("ph") != "M"]


def test_health_out_records_and_traces_equal_jax(tmp_path):
    a = _artifacts(tmp_path)
    assert _records(a["health"][0]) == _records(a["health"][1])
    jt, tt = (json.load(open(p))["traceEvents"] for p in a["trace"])
    assert _strip_ts(jt) == _strip_ts(tt)


def test_validate_gives_jax_verdicts_on_both_packages_artifacts(tmp_path,
                                                               capsys):
    a = _artifacts(tmp_path)
    for paths in a.values():
        for p in paths:
            assert TV.validate(p) == JV.validate(p)
    args = a["trace"] + a["health"]
    assert TV.main(args) == JV.main(args) == 0


def _malformed(tmp_path):
    """The malformed artifacts the JAX package's obs and health tests
    reject, one file each."""
    cases = {
        "x_missing_fields.json": {"traceEvents": [{"ph": "X", "pid": 1}]},
        "no_spans.json": {"traceEvents": [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name"}]},
        "alert_no_entity.json": {"traceEvents": [
            {"ph": "X", "pid": 1, "tid": 0, "name": "s", "ts": 0, "dur": 1},
            {"ph": "i", "pid": 1, "tid": 0, "name": "alert.straggler",
             "cat": "alert", "ts": 1, "args": {"detector": "straggler"}}]},
        "alert_bad_kind.json": {"traceEvents": [
            {"ph": "X", "pid": 1, "tid": 0, "name": "s", "ts": 0, "dur": 1},
            {"ph": "i", "pid": 1, "tid": 0, "name": "alert.bogus",
             "cat": "alert", "ts": 1,
             "args": {"entity": "1", "detector": "x"}}]},
        "slo_no_burn.json": {"traceEvents": [
            {"ph": "X", "pid": 1, "tid": 0, "name": "s", "ts": 0, "dur": 1},
            {"ph": "i", "pid": 1, "tid": 0, "name": "slo.breach",
             "cat": "slo", "ts": 1, "args": {"slo": "x"}}]},
        "bench_no_meta.json": {"meta": {"commit": "abc"}},
        "bench_failed.json": {"meta": {
            "commit": "abc123", "timestamp_utc": "2026-01-01T00:00:00Z",
            "jax_version": "0.0", "backend": "cpu"},
            "claims": [{"text": "t", "value": 1.1, "lo": 1.3, "hi": 2.0,
                        "ok": False}]},
    }
    paths = []
    for name, doc in cases.items():
        p = tmp_path / name
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    for name, lines in {
            "alert_missing_ts.jsonl": [{"record": "alert", "kind":
                                        "straggler", "detector": "s",
                                        "entity": "1", "value": 1.0}],
            "unknown_record.jsonl": [{"record": "mystery"}],
            "hist_no_sum.jsonl": [{"record": "metric", "name": "h",
                                   "type": "histogram", "count": 0}],
            "summary_missing.jsonl": [{"record": "health_summary",
                                       "alerts_total": 0}],
            "empty.jsonl": []}.items():
        p = tmp_path / name
        p.write_text("".join(json.dumps(x) + "\n" for x in lines))
        paths.append(str(p))
    p = tmp_path / "not_json.jsonl"
    p.write_text("{not json\n")
    paths.append(str(p))
    return paths


def test_validate_rejects_the_malformed_cases_as_jax_does(tmp_path, capsys):
    for p in _malformed(tmp_path):
        with pytest.raises(ValueError) as je:
            JV.validate(p)
        with pytest.raises(ValueError) as te:
            TV.validate(p)
        assert str(je.value) == str(te.value), p
        assert TV.main([p]) == JV.main([p]) == 1
    capsys.readouterr()
    assert TV.main([]) == JV.main([]) == 2
    assert capsys.readouterr().out.count("usage") == 2


@pytest.mark.parametrize("cmd", [["rollup"], ["rollup", "--by", "arg:region"],
                                 ["rollup", "--by", "cat"], ["top", "-k", "3"],
                                 ["critical"], ["alerts"], ["diff"]])
def test_analyze_prints_jax_tables(tmp_path, capsys, cmd):
    a = _artifacts(tmp_path)
    for art in ("trace", "health"):
        jp = a[art][0]
        argv = cmd[:1] + ([jp, a["trace"][1]] if cmd[0] == "diff"
                          else [jp]) + cmd[1:]
        assert JA.main(argv) == 0
        want = capsys.readouterr().out
        assert TA.main(argv) == 0
        assert capsys.readouterr().out == want and want.strip()


def test_analyze_functions_equal_jax(tmp_path):
    a = _artifacts(tmp_path)
    for p in a["trace"] + a["health"]:
        je, te = JA.load_events(p), TA.load_events(p)
        assert je == te
        assert JA.rollup(je, "arg:region") == TA.rollup(te, "arg:region")
        assert JA.top_spans(je, 4) == TA.top_spans(te, 4)
        assert JA.critical_path(je) == TA.critical_path(te)
        assert JA.instants(je, ("alert", "slo")) == \
            TA.instants(te, ("alert", "slo"))
    assert JA.diff_runs(*(JA.load_events(p) for p in a["trace"])) == \
        TA.diff_runs(*(TA.load_events(p) for p in a["trace"]))
    with pytest.raises(ValueError, match="unknown group key"):
        TA.rollup(TA.load_events(a["trace"][1]), by="bogus")
    assert math.isinf(TA.diff_runs([], TA.load_events(a["trace"][1]))[0]
                      ["ratio"])
