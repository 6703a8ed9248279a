"""Host milliseconds a step waits for its next batch: the program's
``data`` spans (generation, pinning and the copy's enqueue, in
``train/trainer.py`` and ``train/local_sgd.py``) summed within each step,
median over the window's steps (``lib/spans.py``)."""

from portbench.lib import spans

spans.install()


def read(run):
    return spans.median_ms(run, "data", ("step", "inner_step"),
                           device=False)
