"""Every token of every training step completed in the window, over the
window's time (host clock; a step ends when its loss is on the host)."""


def read(run):
    if run.traffic["driver"] != "train" or not run.calls:
        return None
    return sum(c.tokens for c in run.calls) / run.window_s
