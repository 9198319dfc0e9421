"""Timed spans inside the program: where a train step's or a prefill
call's time goes, on the host's clock and on the card's.

`TraceRecorder` (`repro_torch.obs.trace`) records the schedule in model
time; a span records one stretch of the program's own work:

- its name, its parent (the innermost span open on the same thread),
  and the layer ``kind`` of a prefill block's half;
- host start and end on ``time.perf_counter_ns()``;
- on the card, a pair of ``torch.cuda.Event(enable_timing=True)``
  recorded on the device's current stream at entry and at exit: the
  card's time from reaching the span's first operation to finishing
  its last, idle stretches inside it included;
- a ``torch.profiler.record_function(name)`` range, which places the
  span on the profiler's host timeline (the device timeline is aligned
  to it), inside whatever range the caller opened around it.

Spans record only while a `torch.profiler` session runs: a benchmark's
traced window, or any other profile. No switch of their own turns them
on, and the recorder is the process's one (`RECORDER`), as the
profiler's session is; the first span site a new session reaches drops
the spans of the sessions before it. Every call site keeps `obs.trace`'s
contract: it resolves its handle once per call, and `span` gives it the
shared null context `OFF` where there is none::

    rec = spans.active()  # None with no profiler running
    with spans.span(rec, "prefill.ffn", x, "dense"):
        ...

With no profiler running a site costs one flag read a call and the
entry of `OFF`: no ``record_function``, no CUDA event, no clock read.
The operations the program runs are the same with spans on and off.

Spans are kept in memory. Event times are read only after the work,
by `SpanRecorder.summary`: nothing inside the timed stretch waits for
the card.

The program's spans (`SPAN_NAMES`):

- ``train.forward`` / ``train.backward`` — `launch.steps.value_and_grad`
  around `lm.loss_fn` and around ``torch.autograd.grad`` (one of each a
  micro-batch);
- ``train.optimizer`` — `launch.steps.make_train_step` around
  `optim.adamw_update` (the clip and the update: the multi-tensor
  kernel on a card, the per-leaf code on the CPU or DTensors);
- ``prefill`` — `lm.prefill`, the whole call;
- ``prefill.mixer`` / ``prefill.ffn`` — each block's two halves in
  `lm.prefill`'s layer loop, children of ``prefill``, of the ``kind``
  of the mixer (``attn``, ``mamba``, ``rwkv``) or of the ffn
  (``dense``, ``moe``, ``rwkv_cmix``).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _autograd_profiler

#: the names the program's spans carry
SPAN_NAMES = (
    "train.forward",
    "train.backward",
    "train.optimizer",
    "prefill",
    "prefill.mixer",
    "prefill.ffn",
)

#: the context a site enters with no recorder: shared, so that entering
#: it allocates nothing
OFF = contextlib.nullcontext()


@dataclass(frozen=True, slots=True)
class Span:
    """One closed span. ``parent`` is the ``id`` of the span that was
    innermost on the same thread when it opened (None at the top);
    ``events`` the card's (start, end) event pair, None off the card."""

    id: int
    name: str
    parent: int | None
    kind: str | None
    t0_ns: int
    t1_ns: int
    events: tuple | None = None

    @property
    def host_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def device_s(self) -> float | None:
        """Seconds between the card reaching the start and the end event,
        once it has reached the end (waiting for it where it has not);
        None off the card."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end) * 1e-3


@dataclass(frozen=True)
class SpanTotals:
    """The spans of one name in a window: how many, and their host and
    card seconds (``device_s`` None where none of them ran on the card)."""

    count: int
    host_s: float
    device_s: float | None


class _Open:
    """The context of one span while it is open."""

    __slots__ = ("rec", "name", "kind", "device", "stack", "id", "parent",
                 "range", "stream", "start", "t0_ns")

    def __init__(self, rec, name, device, kind):
        self.rec, self.name, self.kind = rec, name, kind
        self.device = device if device.type == "cuda" else None

    def __enter__(self):
        self.stack = stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        stack.append(self.id)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        # rtlint: disable=clock-domain -- a span's host time, profiled runs only
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        # rtlint: disable=clock-domain -- a span's host time, profiled runs only
        t1_ns = time.perf_counter_ns()
        events = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            events = (self.start, end)
        self.stack.pop()
        self.range.__exit__(*exc)
        # a plain tuple: `SpanRecorder.spans` makes the `Span`s, after the work
        self.rec._done.append((self.id, self.name, self.parent, self.kind,
                               self.t0_ns, t1_ns, events))
        return False


class SpanRecorder:
    """Closed spans in the order they closed, and each thread's stack of
    open ones."""

    def __init__(self):
        self._local = threading.local()
        self._ids = itertools.count()
        self._done: list[tuple] = []
        #: a profiler session was running when a site last looked
        self.live = False

    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def spans(self) -> list[Span]:
        return [Span(*fields) for fields in self._done]

    def clear(self) -> None:
        self._done.clear()

    def summary(self, t0_ns: int, t1_ns: int) -> dict[str, SpanTotals]:
        """Per span name, the `SpanTotals` of the spans that began inside
        ``[t0_ns, t1_ns]`` (``time.perf_counter_ns()``), once the card has
        reached the end of each (only the first read waits)."""
        out: dict[str, tuple] = {}
        for s in self.spans():
            if not t0_ns <= s.t0_ns <= t1_ns:
                continue
            count, host, dev = out.get(s.name, (0, 0.0, None))
            d = s.device_s()
            if d is not None:
                dev = (dev or 0.0) + d
            out[s.name] = (count + 1, host + s.host_s, dev)
        return {name: SpanTotals(*v) for name, v in out.items()}


#: the process's recorder: spans follow the profiler's session, which is
#: the process's too
RECORDER = SpanRecorder()


def active() -> SpanRecorder | None:
    """`RECORDER` while a profiler session runs, else None: a call
    site's handle, resolved once per call. The first look inside a new
    session drops the spans of the sessions before it, so that the
    recorder holds no more than the profiler itself does."""
    if not _autograd_profiler._is_profiler_enabled:
        RECORDER.live = False
        return None
    if not RECORDER.live:
        RECORDER.clear()
        RECORDER.live = True
    return RECORDER


def span(rec: SpanRecorder | None, name: str, like: torch.Tensor,
         kind: str | None = None):
    """A call site's context: one span of ``name`` on ``rec`` around its
    body, or `OFF` where ``rec`` is None (no profiler running). The
    body's work runs on the device of the tensor ``like``: on a CUDA
    device the span records its events on that device's current stream,
    elsewhere none."""
    if rec is None:
        return OFF
    return _Open(rec, name, like.device, kind)


def summary(t0_ns: int, t1_ns: int) -> dict[str, SpanTotals]:
    """`RECORDER`'s `SpanRecorder.summary`."""
    return RECORDER.summary(t0_ns, t1_ns)
