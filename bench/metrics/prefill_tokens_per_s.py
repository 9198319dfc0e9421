"""Every prompt token prefilled in the window, over the window's time
(host clock; a call ends when its first tokens are on the host)."""


def read(run):
    if run.traffic["driver"] != "prefill" or not run.calls:
        return None
    return sum(c.tokens for c in run.calls) / run.window_s
