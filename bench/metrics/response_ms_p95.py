"""95th percentile over every request completed in the window of the
time from when it was due to when its first token was on the host
(host clock; nearest rank)."""
from benchkit.stats import percentile


def read(run):
    times = [(c.done - c.due) * 1e3 for c in run.calls for _ in range(c.rows)]
    return percentile(times, 95) if times else None
