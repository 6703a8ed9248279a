"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, in GB (1e9 bytes)."""


def read(run):
    if run.window.peak_bytes is None:
        return None
    return run.window.peak_bytes / 1e9
