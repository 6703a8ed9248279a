"""The window's model FLOPs (``lib/flops.py``) over its wall time, as a
share of the card's bf16 peak."""

from portbench.lib.peaks import BF16_FLOP_PER_S


def read(run):
    return 100.0 * run.flops / run.window.seconds / BF16_FLOP_PER_S
