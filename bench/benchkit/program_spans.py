"""The program's own timed spans (`repro_torch.obs.spans`, recorded
while the profiler runs) over a traced window, as the metrics' readers
take them: one span name's host or card milliseconds a call.

Nothing (None) where the run is untraced or not on the card, another
driver ran it, the window made no call, or the program has no such
span: a checkout of the program from before its spans has no
`repro_torch.obs.spans` at all."""
from __future__ import annotations


def ms_per_call(run, driver: str, name: str, clock: str) -> float | None:
    """Milliseconds a call of the window's spans called ``name`` that
    began inside it: ``clock`` "host" (``time.perf_counter_ns`` at the
    span's ends, under the profiler: its cost on each launch and any wait
    for room in the launch queue included) or "device" (CUDA events on
    the current stream at its ends: the card's time from reaching its
    first operation to finishing its last)."""
    if (run.trace is None or not run.on_card or run.traffic["driver"] != driver
            or not run.calls):
        return None
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    totals = spans.summary(int(run.t0 * 1e9), int(run.t1 * 1e9)).get(name)
    if totals is None:
        return None
    seconds = totals.host_s if clock == "host" else totals.device_s
    if seconds is None:
        return None
    return 1e3 * seconds / len(run.calls)
