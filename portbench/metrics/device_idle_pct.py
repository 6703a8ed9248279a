"""Share of the traced stretch in which no operation runs on the card:
one minus the union of the device operations' intervals over the
stretch."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
