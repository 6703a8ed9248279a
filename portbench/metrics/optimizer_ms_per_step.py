"""Device milliseconds the optimizer holds the stream a step: the
program's ``adamw`` device phase around ``optim/adamw.py::apply_updates``
(the global-norm clip included), median over the window's steps
(``lib/spans.py``).  It reads at least ``adamw_ms_per_step``, the sum of
the kernels launched there, and more by however long the host's
launches keep the stream waiting."""

from portbench.lib import spans

spans.install()


def read(run):
    return spans.median_ms(run, "adamw", ("step", "inner_step"))
