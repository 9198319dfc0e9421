"""Share of the traced window with nothing running on the card (the union
of the profiler's device intervals), prefill cells."""


def read(run):
    if run.trace is None or run.traffic["driver"] != "prefill":
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
