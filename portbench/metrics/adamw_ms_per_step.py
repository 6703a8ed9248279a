"""Device milliseconds of the operations launched under
``repro_torch/optim/adamw.py::apply_updates`` (by the profiler's Python
stacks and each kernel's launch), per optimizer step of the stretch
traced with stacks.  Nothing is read when the trace holds no such
frames."""

from portbench.lib.profile import seconds_under

FUNCTION = r"optim/adamw\.py\(\d+\): apply_updates$"


def read(run):
    t = run.stack_trace
    if t is None or not t.steps:
        return None
    secs, calls = seconds_under(t, FUNCTION)
    if calls == 0 or secs <= 0:
        return None
    return 1e3 * secs / t.steps
