"""The traced stretch's model FLOPs (its train steps, ``lib/flops.py``)
over its length on the device clock, from its first device operation's
start to its last one's end, as a share of the card's bf16 peak: the
whole steps' share, idle gaps between their operations included, which
bounds every kernel's gain.  ``mfu`` takes the same share over the
window's host clock."""

from portbench.lib.peaks import BF16_FLOP_PER_S


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.device:
        return None
    return 100.0 * run.step_flops * t.steps / t.span_s / BF16_FLOP_PER_S
