"""Tokens trained in the window over its wall time (host clock; the window
ends in a synchronise)."""


def read(run):
    return run.tokens / run.window.seconds
