"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at
its start, in GiB."""


def read(run):
    if not run.on_card:
        return None
    return run.peak_window_bytes / 2**30
