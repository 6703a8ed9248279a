"""Reading a traced stretch: its bounds, the card's busy time as the
union of device operations, the kernels a Python function launched, and
the breakdown."""

import pytest

from portbench.tests.tiny import ROOT  # noqa: F401  (puts the repo on sys.path)
from portbench.lib import profile as P


def _k(name, ts, dur, corr=None):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_a_device_only_stretch_is_the_host_window_from_its_first_op():
    t = P.parse([_k("a", 100.0, 10.0), _k("b", 105.0, 10.0),
                 _k("c", 140.0, 20.0)], window_us=100.0)
    assert (t.t0, t.t1) == (100.0, 200.0)
    assert t.busy_s == pytest.approx(35e-6)        # [100, 115) and [140, 160)
    assert t.window_s == pytest.approx(100e-6)
    assert t.gaps() == [(115.0, 140.0), (160.0, 200.0)]
    assert t.span_s == pytest.approx(60e-6)        # 100 to 160
    b = P.breakdown(t)
    assert b["device_ops"][0] == ["c", pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["before the stretch's end",
                                 pytest.approx(40e-6)]
    assert b["idle_gaps"][1][0] == "before c"


def test_a_marked_stretch_keeps_what_overlaps_it_and_names_the_host():
    ev = [{"ph": "X", "cat": "user_annotation", "name": P.MARK, "ts": 50.0,
           "dur": 100.0, "tid": 7},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 60.0,
           "dur": 30.0, "tid": 7},
          _k("early", 10.0, 20.0), _k("mm", 95.0, 10.0),
          _k("edge", 145.0, 20.0)]
    t = P.parse(ev)
    assert [d[0] for d in t.device] == ["mm", "edge"]
    assert t.busy_s == pytest.approx(15e-6)       # clipped at the end, 150
    assert t.host_at(70.0) == "aten::mm"
    assert t.host_at(120.0) == "host idle"


def test_kernels_launched_under_a_python_function():
    ev = [{"ph": "X", "cat": "user_annotation", "name": P.MARK, "ts": 0.0,
           "dur": 1000.0, "tid": 1},
          {"ph": "X", "cat": "python_function", "tid": 1, "ts": 100.0,
           "dur": 100.0,
           "name": "repro_torch/optim/adamw.py(120): apply_updates"},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "tid": 1, "ts": 150.0, "dur": 2.0, "args": {"correlation": 5}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "tid": 1, "ts": 300.0, "dur": 2.0, "args": {"correlation": 6}},
          _k("adam", 400.0, 30.0, 5), _k("gemm", 450.0, 70.0, 6)]
    t = P.parse(ev)
    secs, calls = P.seconds_under(t, r"optim/adamw\.py\(\d+\): "
                                     r"apply_updates$")
    assert calls == 1 and secs == pytest.approx(30e-6)
    assert t.kernel_seconds(r"^gemm$") == (pytest.approx(70e-6), 1)


def test_a_trace_without_its_bounds_is_refused():
    with pytest.raises(RuntimeError, match="no"):
        P.parse([_k("a", 1.0, 1.0)])
    with pytest.raises(RuntimeError, match="no device operation"):
        P.parse([], window_us=10.0)


def test_step_mfu_is_the_steps_flops_over_the_device_span():
    from types import SimpleNamespace

    from portbench.lib.peaks import BF16_FLOP_PER_S
    from portbench.lib.registry import metric
    t = P.parse([_k("a", 100.0, 10.0), _k("b", 150.0, 50.0)],
                window_us=400.0)
    t.steps = 2
    run = SimpleNamespace(trace=t, step_flops=0.25 * BF16_FLOP_PER_S * 1e-4)
    assert metric("step_mfu").read(run) == pytest.approx(50.0)
    assert metric("step_mfu").read(SimpleNamespace(trace=None)) is None
