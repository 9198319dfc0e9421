"""Share of the traced window with nothing running on the card (the union
of the profiler's device intervals), training cells."""


def read(run):
    if run.trace is None or run.traffic["driver"] != "train":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
