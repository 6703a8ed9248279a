"""The card's mean ``power.draw`` over the window times its seconds, per
token trained."""


def read(run):
    if run.power_w is None:
        return None
    return run.power_w * run.window.seconds / run.tokens
