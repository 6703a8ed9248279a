"""Reading the program's own spans: the four metrics of the train step's
and the sync's phases (medians over the window's steps or rounds), the
idle gaps named by the program span open across them, and the existing
readers unmoved by a run that carries spans."""

from types import SimpleNamespace

import pytest

from portbench.tests.tiny import ROOT  # noqa: F401  (puts the repo on sys.path)
from portbench.lib import profile as P
from portbench.lib import spans as S
from portbench.lib.registry import benchmark, metric

NEW = ("fwd_bwd_ms_per_step", "optimizer_ms_per_step",
       "data_wait_ms_per_step", "compress_ms_per_round")


def _k(name, ts, dur, corr=None):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


class Events:
    """A tracer's events written by hand: host spans with ids, and the
    device-track events of the device phases among them (``dev`` us)."""

    def __init__(self):
        from repro_torch.obs.trace import Tracer
        self.tr = Tracer(enabled=True)
        self.n = 0

    def span(self, name, ts, dur, parent=None, dev=None, **args):
        self.n += 1
        self.tr.events.append({"name": name, "cat": "t", "ph": "X",
                               "ts": ts, "dur": dur, "tid": 1, "args": args,
                               "id": self.n, "parent": parent})
        if dev is not None:
            self.tr.events.append({"name": name, "cat": "t", "ph": "X",
                                   "ts": ts + 5.0, "dur": dev, "tid": 2,
                                   "args": args, "span": self.n})
        return self.n

    def window(self, lo_us, hi_us):
        t0 = self.tr._t0_ns / 1e9
        return SimpleNamespace(t0=t0 + lo_us / 1e6, t1=t0 + hi_us / 1e6)


def _trainer_run():
    """Five trainer steps 1000 us apart, two microbatches each; the
    window opens at step 1, so step 0 (its phases 10x longer) is out."""
    ev = Events()
    for s in range(5):
        t, k = 1000.0 * s, 10.0 if s == 0 else 1.0
        step = ev.span("step", t, 900, dev=950 * k, step=s)
        ev.span("fwd_bwd", t + 10, 5, step, dev=(300 + s) * k)
        ev.span("fwd_bwd", t + 20, 5, step, dev=(200 + s) * k)
        ev.span("adamw", t + 30, 40, step, dev=(100 + 10 * s) * k)
        ev.span("data", t + 80, (50 + s) * k, step)
    return SimpleNamespace(spans=ev.tr, window=ev.window(990, 4990))


def _local_sgd_run():
    """Three rounds of two replicas of two inner steps, four leaves
    compressed a replica; round 0 lies before the window."""
    ev = Events()
    for r in range(3):
        t = 10000.0 * r
        rnd = ev.span("round", t, 9000, round=r)
        for rep in range(2):
            t_rep = t + 4000 * rep
            replica = ev.span("replica", t_rep, 3000, rnd, replica=rep)
            for i in range(2):
                inner = ev.span("inner_step", t_rep + 100 * i, 90, replica,
                                dev=400)
                ev.span("data", t_rep + 100 * i + 1, 7 + r, inner)
                ev.span("fwd_bwd", t_rep + 100 * i + 10, 5, inner,
                        dev=250 + r)
                ev.span("adamw", t_rep + 100 * i + 20, 5, inner, dev=120)
            pg = ev.span("pseudograd", t_rep + 500, 200, replica)
            for leaf in range(4):
                ev.span("compress", t_rep + 510 + leaf, 1, pg,
                        dev=10 * (r + 1), leaf=leaf)
    return SimpleNamespace(spans=ev.tr, window=ev.window(9990, 30000))


def test_new_readers_take_medians_over_the_windows_steps():
    run = _trainer_run()
    got = {m: metric(m).read(run) for m in NEW}
    # steps 1-4: fwd_bwd 301+201 .. 304+204, median of 502, 504, 506, 508
    assert got["fwd_bwd_ms_per_step"] == pytest.approx(0.505)
    assert got["optimizer_ms_per_step"] == pytest.approx(0.125)
    assert got["data_wait_ms_per_step"] == pytest.approx(0.0525)
    assert got["compress_ms_per_round"] is None     # a trainer has none


def test_new_readers_on_local_sgd_rounds():
    run = _local_sgd_run()
    got = {m: metric(m).read(run) for m in NEW}
    # rounds 1-2: 2 replicas x 4 leaves x 20 or 30 us
    assert got["compress_ms_per_round"] == pytest.approx(0.2)
    assert got["fwd_bwd_ms_per_step"] == pytest.approx(0.2515)
    assert got["optimizer_ms_per_step"] == pytest.approx(0.12)
    assert got["data_wait_ms_per_step"] == pytest.approx(0.0085)


def test_new_readers_read_nothing_without_spans():
    win = SimpleNamespace(t0=0.0, t1=1.0)
    for run in (SimpleNamespace(window=win),
                SimpleNamespace(window=win, spans=object()),  # no phases
                SimpleNamespace(window=SimpleNamespace(t0=None, t1=None),
                                spans=_trainer_run().spans)):
        for m in NEW:
            assert metric(m).read(run) is None, m
    assert S._INSTALLED is None         # a test process is not run.py


def test_new_metrics_are_listed_for_the_cells_that_have_them():
    entries = {m["name"]: m for m in benchmark()["per_layer"]}
    for m in NEW:
        e = entries[m]
        assert (e["unit"], e["better"], e["source"], e["moves"]) == (
            "ms", "lower", "program_span", "tokens_per_s")
    assert entries["compress_ms_per_round"]["workloads"] == [
        "opt-1.3b.diloco-int8"]
    assert entries["optimizer_ms_per_step"]["layer"] == \
        entries["adamw_ms_per_step"]["layer"]


def test_a_gap_is_named_by_the_innermost_program_span():
    ev = Events()
    step = ev.span("step", 0.0, 500.0)
    ev.span("data", 100.0, 60.0, step)
    # the profiler's clock starts 1 ms later: step [-1000, -500], data
    # [-900, -840] on it
    base = ev.tr.base_time_ns + 1_000_000
    t = P.parse([_k("a", -1000.0, 20.0), _k("b", -950.0, 20.0),
                 _k("c", -820.0, 20.0), _k("d", -300.0, 50.0)],
                window_us=900.0)
    assert S.gap_name(t, ev.tr, base, -965.0) == "step / before b"
    assert S.gap_name(t, ev.tr, base, -875.0) == "data / before c"
    assert S.gap_name(t, ev.tr, base, -175.0) == "before the stretch's end"
    named = S.named_breakdown(t, ev.tr, base)
    plain = P.breakdown(t)
    assert named["device_ops"] == plain["device_ops"]
    assert named["idle_gaps"] == [
        ["step / before d", pytest.approx(500e-6)],
        ["before the stretch's end", pytest.approx(150e-6)],
        ["data / before c", pytest.approx(110e-6)],
        ["step / before b", pytest.approx(30e-6)]]
    assert [g[0] for g in plain["idle_gaps"]] == [
        "before d", "before the stretch's end", "before c", "before b"]
    assert S.named_breakdown(t, None, base) == plain
    assert S.named_breakdown(t, ev.tr, None) == plain
    assert S.gap_name(t, Events().tr, base, -965.0) == "before b"


def _existing_run(spans=None):
    stretch = P.parse([_k("fa_fwd_kernel<1>", 100.0, 10.0),
                       _k("quant8_quantize_kernel", 120.0, 30.0),
                       _k("gemm", 200.0, 50.0)], window_us=400.0)
    stretch.steps, stretch.rounds = 2, 1
    stacks = P.parse([
        {"ph": "X", "cat": "user_annotation", "name": P.MARK, "ts": 0.0,
         "dur": 1000.0, "tid": 1},
        {"ph": "X", "cat": "python_function", "tid": 1, "ts": 100.0,
         "dur": 100.0,
         "name": "repro_torch/optim/adamw.py(120): apply_updates"},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 150.0, "dur": 2.0, "args": {"correlation": 5}},
        _k("adam", 400.0, 30.0, 5)])
    stacks.steps = 2
    run = SimpleNamespace(
        trace=stretch, stack_trace=stacks, step_flops=1e9, tokens=1000,
        flops=1e12, power_w=500.0, setup_s=12.5, rounds=3,
        phase_s={"inner": 1.0, "pseudograd": 0.2, "outer": 0.1},
        window=SimpleNamespace(t0=1.0, t1=3.0, seconds=2.0,
                               peak_bytes=5e10),
        work={"fa2": {"calls_per_step": 4, "batch": 1, "seq": 128,
                      "heads": 4, "kv_heads": 2, "head_dim": 64},
              "quant8": {"block": 256, "elements_per_round": [4096, 512]}})
    if spans is not None:
        run.spans = spans
    return run


@pytest.mark.parametrize(
    "m", [m for m in benchmark()["end_to_end"] + benchmark()["per_layer"]
          if m["name"] not in NEW], ids=lambda m: m["name"])
def test_existing_readers_are_unmoved_by_spans(m):
    read = metric(m["name"]).read
    before = read(_existing_run())
    after = read(_existing_run(spans=_local_sgd_run().spans))
    assert before == after
    assert before is not None
