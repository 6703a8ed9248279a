"""Device milliseconds of a train step's forwards and backwards: the
program's ``fwd_bwd`` device phases (``train/step.py``, one a
microbatch) summed within each step (``step`` in the trainer,
``inner_step`` in local SGD), median over the window's steps
(``lib/spans.py``)."""

from portbench.lib import spans

spans.install()


def read(run):
    return spans.median_ms(run, "fwd_bwd", ("step", "inner_step"))
