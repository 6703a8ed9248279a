"""The port's tracer on one clock with the card: span ids, the wall-clock
anchor a profiler trace shares, device phases read only where the loops
already wait (``Tracer.device_phase`` / ``resolve``), the phase clock
that folds its pairs into running totals, and the phases the trainer,
the train step and the local-SGD loop record."""

import json
import time
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from test_torch_helpers import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.obs import analyze  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import (NULL_SPAN, PhaseClock, Tracer,  # noqa: E402
                                   set_tracer)
from repro_torch.obs.validate import validate  # noqa: E402
from repro_torch.optim.compress import CompressConfig  # noqa: E402
from repro_torch.train.local_sgd import (LocalSGDConfig,  # noqa: E402
                                         train_local_sgd)
from repro_torch.train.trainer import TrainerConfig, train  # noqa: E402

CFG = get_config("opt-125m-smoke")


class FakeEvent:
    """``torch.cuda.Event`` on the host clock: ``done`` says whether the
    device has passed it; counts every construction and wait."""
    made = 0
    waits = 0
    done = True

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return FakeEvent.done

    def synchronize(self):
        FakeEvent.waits += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.made = FakeEvent.waits = 0
    FakeEvent.done = True
    return FakeEvent


@pytest.fixture
def tracer():
    tr = Tracer(enabled=True, registry=MetricsRegistry())
    old = set_tracer(tr)
    yield tr
    set_tracer(old)


def _by_id(tr):
    return {e["id"]: e for e in tr.events if "id" in e}


def _device(tr, name):
    return [e for e in tr.events if "span" in e and e["name"] == name]


def _under(tr, e, group):
    """The id of the nearest span named ``group`` that caused ``e`` (a
    host span or a device-track event), or None."""
    spans = _by_id(tr)
    i = e["span"] if "span" in e else e["parent"]
    while i is not None and spans[i]["name"] != group:
        i = spans[i]["parent"]
    return i


def test_a_disabled_tracer_makes_no_phase_and_no_cuda_event(fake_events):
    tr = Tracer(enabled=False, registry=MetricsRegistry())
    ph = tr.device_phase("adamw", "train", device=torch.device("cuda"),
                         metric="train/adamw_s")
    assert ph is NULL_SPAN
    with ph:
        pass
    tr.resolve()
    assert tr.events == [] and fake_events.made == 0
    assert tr.registry.snapshot() == {}


def test_device_phases_on_the_card_are_read_without_waiting(fake_events):
    reg = MetricsRegistry()
    tr = Tracer(enabled=True, registry=reg)
    card = torch.device("cuda")
    with tr.span("step", "train") as step:
        with tr.device_phase("fwd_bwd", "train", device=card,
                             metric="train/fwd_bwd_s"):
            time.sleep(0.002)
    fake_events.done = False            # the card is still behind
    tr.resolve()
    assert _device(tr, "fwd_bwd") == [] and fake_events.waits == 0
    fake_events.done = True             # after the loop's own wait
    tr.resolve()
    (dev,) = _device(tr, "fwd_bwd")
    host = _by_id(tr)[dev["span"]]
    assert host["name"] == "fwd_bwd" and host["parent"] == step.id
    assert dev["dur"] >= 2000 and fake_events.waits == 0
    assert dev["ts"] == host["ts"]      # no meeting point yet: the launch
    assert reg.snapshot()["train/fwd_bwd_s"]["count"] == 1
    # the resolve left an anchor: a later phase is placed through it
    with tr.device_phase("adamw", "train", device=card):
        pass
    tr.resolve()
    (dev,) = _device(tr, "adamw")
    assert dev["ts"] >= _by_id(tr)[dev["span"]]["ts"] - 1e3
    made = fake_events.made
    for _ in range(20):                 # read events are reused
        with tr.device_phase("adamw", "train", device=card):
            pass
        tr.resolve()
    assert fake_events.made - made <= 20 + 2


def test_phase_clock_folds_its_pairs_into_totals(fake_events):
    for device in ("cpu", "cuda"):
        clock, seen = PhaseClock(torch.device(device)), []
        for i in range(300):
            start = clock.mark()
            clock.stop("inner" if i % 3 else "outer", start,
                       lambda s, a: seen.append(s))
            if i % 10 == 9:
                clock.fold()
                assert not clock._pending     # memory stays flat
        totals = clock.totals()
        assert set(totals) == {"inner", "outer"}
        assert len(seen) == 300
        assert sum(totals.values()) == pytest.approx(sum(seen))
        with clock.phase("outer"):
            pass
        assert clock.totals()["outer"] >= totals["outer"]


def test_span_ids_and_the_clock_anchor_are_exported(tmp_path):
    tr = Tracer(enabled=True, process="p")
    with tr.span("round", "local_sgd") as r:
        h = tr.begin("replica", "local_sgd")
        with tr.device_phase("compress", "local_sgd", leaf=3):
            pass
        h.end()
    tr.complete("sim", ts_s=0.0, dur_s=1.0)
    tr.resolve()
    spans = _by_id(tr)
    assert spans[r.id]["parent"] is None
    assert spans[h.id]["parent"] == r.id
    comp = next(e for e in spans.values() if e["name"] == "compress")
    assert comp["parent"] == r.id       # a detached span is no one's cause
    assert len(set(spans)) == len(spans) == 3
    doc = tr.to_chrome()
    assert doc["baseTimeNanoseconds"] == tr.base_time_ns
    args = [e.get("args", {}) for e in doc["traceEvents"]]
    assert {"id": comp["id"], "parent": r.id, "leaf": 3} in args
    assert {"span": comp["id"], "leaf": 3} in args
    assert {} in args                         # `sim` carries no ids
    path = tmp_path / "t.json"
    tr.save_chrome_trace(str(path))
    assert json.loads(path.read_text())["baseTimeNanoseconds"] == \
        tr.base_time_ns
    log = tmp_path / "t.jsonl"
    tr.save_jsonl(str(log))
    head = json.loads(log.read_text().splitlines()[0])
    assert head == {"record": "meta", "process": "p",
                    "base_time_ns": tr.base_time_ns}
    assert validate(str(log))["event"] == 5
    assert validate(str(path))["X"] == 5


def test_a_pickled_tracer_keeps_its_ids_unique():
    import pickle
    tr = Tracer(enabled=True)
    with tr.span("a"):
        pass
    back = pickle.loads(pickle.dumps(tr))
    with back.span("b"):
        pass
    ids = [e["id"] for e in back.events]
    assert len(set(ids)) == 2 and back.base_time_ns == tr.base_time_ns


def test_span_bounds_enclose_a_profiler_range(tmp_path):
    """A span put on a CPU profiler trace's clock (its
    ``baseTimeNanoseconds``) encloses a ``record_function`` range opened
    inside it, to within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("data", "train"):
            time.sleep(0.003)
            with record_function("inside"):
                time.sleep(0.005)
            time.sleep(0.003)
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    (rng,) = [e for e in doc["traceEvents"] if e.get("name") == "inside"
              and e.get("ph") == "X"]
    (span,) = tr.events
    a = tr.to_clock(span["ts"], base)
    b = a + span["dur"]
    assert a - 1000 <= float(rng["ts"])
    assert float(rng["ts"]) + float(rng["dur"]) <= b + 1000
    assert b - a >= 11000                # the sleeps inside it


@pytest.mark.parametrize("prefetch", [True, False])
def test_trainer_records_each_steps_phases(tracer, prefetch):
    steps = 3
    train(CFG, TrainerConfig(steps=steps, batch=4, seq_len=16, log_every=0,
                             microbatches=2, prefetch=prefetch),
          device="cpu")
    step_ids = [e["id"] for e in tracer.events
                if e.get("name") == "step" and "id" in e]
    assert len(step_ids) == steps
    for name, n in (("fwd_bwd", 2), ("adamw", 1), ("accumulate", 3)):
        per = Counter(_under(tracer, e, "step") for e in _device(tracer, name))
        assert per == {s: n for s in step_ids}, name
    data = [e for e in tracer.events if e["name"] == "data" and "id" in e]
    assert len(data) == steps
    per = Counter(_under(tracer, e, "step") for e in data)
    want = {s: 1 for s in step_ids[:-1]} if prefetch else \
        {s: 1 for s in step_ids}
    assert {k: v for k, v in per.items() if k is not None} == want
    snap = tracer.registry.snapshot()
    assert snap["train/step_s"]["count"] == steps
    assert snap["train/fwd_bwd_s"]["count"] == 2 * steps
    assert "train/fwd_bwd_opt_s" not in snap
    assert not any(e["name"] == "fwd_bwd_opt" for e in tracer.events)
    rows = analyze.critical_path(tracer.to_chrome()["traceEvents"],
                                 parent="step")
    assert len(rows) == steps
    assert {"fwd_bwd@device", "adamw@device", "step@device"} <= \
        set(rows[0]["phases"])


def test_local_sgd_compresses_each_leaf_of_each_replica_each_round(tracer):
    R, K, rounds = 2, 2, 2
    res = train_local_sgd(
        CFG, TrainerConfig(steps=K * rounds, batch=2, seq_len=16,
                           log_every=0),
        LocalSGDConfig(replicas=R, inner_steps=K,
                       compress=CompressConfig(method="int8", block=64,
                                               error_feedback=True)),
        device="cpu")
    assert set(res.phase_s) == {"inner", "pseudograd", "outer"}
    leaves = len(tree_leaves(res.outer_state["params"]))
    comp = _device(tracer, "compress")
    assert len(comp) == leaves * R * rounds
    spans = _by_id(tracer)
    per = Counter((_under(tracer, e, "round"),
                   spans[_under(tracer, e, "replica")]["args"]["replica"])
                  for e in comp)
    assert len(per) == R * rounds and set(per.values()) == {leaves}
    assert sorted({e["args"]["leaf"] for e in comp}) == list(range(leaves))
    inner = _device(tracer, "inner_step")
    assert len(inner) == R * K * rounds
    data = [e for e in tracer.events if e["name"] == "data" and "id" in e]
    assert Counter(_under(tracer, e, "inner_step") for e in data) == \
        {e["span"]: 1 for e in inner}
    assert len(_device(tracer, "outer_sync")) == rounds
    snap = tracer.registry.snapshot()
    assert snap["local_sgd/inner_step_s"]["count"] == R * K * rounds
    assert snap["local_sgd/compress_s"]["count"] == leaves * R * rounds
