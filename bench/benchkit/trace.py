"""Reading the PyTorch profiler's trace of a window.

The traced window runs from the first to the last of the benchmark's
own spans (``bench.*``, `torch.profiler.record_function` around its
calls into the program). Device time is the union of the device's
intervals (kernels, copies, fills) inside it; an idle gap is a stretch
of that window with nothing running on the device, labelled by the
benchmark span and the innermost host operation open at its middle."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: device operation name -> [seconds, count]
    ops: dict = field(default_factory=dict)
    #: host label -> [idle seconds, gaps]
    gaps: dict = field(default_factory=dict)

    def kernel_seconds(self, *needles: str) -> tuple[float, int]:
        """Seconds and count of the device operations whose name holds
        any of ``needles``."""
        secs, n = 0.0, 0
        for name, (s, c) in self.ops.items():
            if any(x in name for x in needles):
                secs, n = secs + s, n + c
        return secs, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[name[:160], s] for name, (s, _) in ops],
                "idle_gaps": [[name[:160], s] for name, (s, _) in gaps]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(prof) -> Trace | None:
    """The `Trace` of a finished ``torch.profiler.profile``; None where
    the profiler kept no device operation inside the window."""
    from torch.autograd import DeviceType

    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return None
    spans, host, device = [], [], []
    annotation = lambda e: getattr(e, "is_user_annotation", lambda: False)()  # noqa: E731
    for e in events:
        name, t0 = e.name(), e.start_ns()
        t1 = t0 + e.duration_ns()
        if name.startswith(SPAN_PREFIX):
            if e.device_type() == DeviceType.CPU:
                spans.append((t0, t1, name))
            continue
        if e.device_type() == DeviceType.CUDA:
            if not annotation(e):
                device.append((t0, t1, name))
        elif not annotation(e):
            host.append((t0, t1, name))
    if not spans:
        return None
    w0, w1 = min(s[0] for s in spans), max(s[1] for s in spans)
    device = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    if not device:
        return None
    ops = defaultdict(lambda: [0.0, 0])
    for a, b, n in device:
        ops[n][0] += (b - a) * 1e-9
        ops[n][1] += 1
    busy = _union((a, b) for a, b, _ in device)
    spans.sort()
    host.sort()
    span_starts = [s[0] for s in spans]
    host_starts = [h[0] for h in host]
    gaps = defaultdict(lambda: [0.0, 0])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label = "outside spans"
        j = bisect.bisect_right(span_starts, mid) - 1
        if j >= 0 and spans[j][1] >= mid:
            label = spans[j][2]
        k = bisect.bisect_right(host_starts, mid) - 1
        for back in range(k, max(k - 64, -1), -1):
            if host[back][1] >= mid:
                label += "/" + host[back][2]
                break
        gaps[label][0] += (b - a) * 1e-9
        gaps[label][1] += 1
    busy_s = sum(b - a for a, b in busy) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_s, ops=dict(ops),
                 gaps=dict(gaps))
