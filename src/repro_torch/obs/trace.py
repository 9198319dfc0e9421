"""Cross-layer schedule tracing: one event stream for DES, runtime and
gateway.

PHAROS's conformance story compares three layers of the same schedule
(analysis >= DES >= runtime); until now the comparison happened on
end-of-run aggregates. `TraceRecorder` captures the *schedule itself*
as structured events so a disagreement can be pinpointed to the first
divergent event (`repro_torch.obs.diff.trace_diff`), rendered as a per-stage
timeline (`to_chrome_trace`, loadable in Perfetto / chrome://tracing),
or rolled up into deadline-compliance metrics
(`repro_torch.obs.metrics.MetricsRegistry.from_trace`).

Event vocabulary (``TraceEvent.kind``):

- ``release``        — a job entered the system (DES release, runtime
                       ``PharosServer.submit``, gateway submit path).
- ``dispatch``       — a stage server started (or resumed) serving a
                       job; ``attrs["resumed"]`` marks a
                       post-preemption resume.
- ``preempt_store``  — a running job was preempted at a window
                       boundary; ``attrs["xi"]`` is the store-side
                       charge serialized before the preemptor starts
                       (Eq. 5 ``e_store``; the idealized instant model
                       charges ``e_tile + e_store``).
- ``preempt_load``   — the matching resume-side charge of the same
                       preemption, ``attrs["xi"]`` = ``e_load``
                       (instant model: ``e_load``). Emitted at the
                       preemption instant — the charge is *owed* from
                       that point and paid when the job resumes.
- ``segment_end``    — a job finished a non-final segment and forwards
                       to its next stage (closes the stage span).
- ``complete``       — a job finished its last segment;
                       ``attrs["deadline"]`` carries the absolute
                       deadline so response (``t - release``) and
                       tardiness (``max(0, t - deadline)``) derive at
                       read time with no hot-path arithmetic.
- ``deadline_miss``  — an *in-flight* job is past its finite absolute
                       deadline at horizon/run end
                       (``attrs["in_flight"]``). Completed-job misses
                       are **not** separately emitted: they derive from
                       ``complete`` (``t > attrs["deadline"]``), and
                       `MetricsRegistry.from_trace` / `to_chrome_trace`
                       perform that derivation — one fewer hot-path
                       emission per late job.
- ``shed``           — a release dropped by the shedding policy.
- ``rate_limited``   — a release refused by a dry token bucket.
- ``admit``/``reject`` — tenancy admission decisions (gateway).
- ``place``          — tenant -> shard placement (sharded gateway).
- ``mode_switch``    — a committed mixed-criticality mode transition
                       (`repro_torch.traffic.modes.ModeController`);
                       ``attrs["mode"]`` is the mode entered,
                       ``attrs["survivors"]`` the re-proved guarantee
                       set, ``attrs["schedulable"]`` the Eq. 3
                       re-proof verdict that gated the commit.
- ``migrate_start``  — a live tenant migration began draining
                       (`repro_torch.traffic.migration.MigrationController`):
                       new releases stop on the donor shard (``shard``)
                       while in-flight jobs complete;
                       ``attrs["held"]`` counts the withheld releases.
- ``migrate_commit`` — the drained tenant passed the target shard's
                       Eq. 3 admit and was re-homed; ``shard`` is the
                       target, ``attrs["donor"]`` the shard it left,
                       ``attrs["held"]`` the re-stamped releases
                       injected on the target.
- ``migrate_abort``  — no target could prove the tenant's contract;
                       the tenant was restored onto its donor shard
                       (``shard``) with its held releases re-injected —
                       ``attrs["reason"]`` says why.

Identity and ordering: events carry the emitting ``layer`` ("des",
"runtime" or "gateway"), the tenant/task ``task`` name, the job's
``release`` stamp (the cross-layer join key — both model layers release
the identical trace floats), the ``stage`` index and the ``shard``
(``-1`` unsharded). ``seq`` is the recorder-global emission order;
within one ``(layer, shard)`` stream timestamps are non-decreasing and
mirror the DES heap's ``(t, kind, prio, seq)`` tie-break: at one
instant all releases are emitted before any completion (the property
tests pin this).

Zero overhead when disabled: instrumented layers resolve their trace
handle once per run — ``tr = trace if trace is not None and
trace.enabled else None`` — and guard every emission with ``if tr is
not None``. A disabled recorder is never even called, so tracing off
means literally zero events and no per-event work (the JAX package's
``benchmarks/obs_bench.py`` asserts this of the same contract).

The module is dependency-free (stdlib only): every layer can accept a
recorder without import cycles, and the DES keeps treating it as an
opaque duck-typed handle.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

#: every event kind a recorder may carry, in no particular order
EVENT_KINDS = (
    "release",
    "dispatch",
    "preempt_store",
    "preempt_load",
    "segment_end",
    "complete",
    "deadline_miss",
    "shed",
    "rate_limited",
    "admit",
    "reject",
    "place",
    "mode_switch",
    "migrate_start",
    "migrate_commit",
    "migrate_abort",
)

#: layer tags of the three instrumented layers
LAYERS = ("des", "runtime", "gateway")

#: the scalar-payload key per event kind for compact `TraceRecorder.sink`
#: rows — a bare float in the row's payload slot means this attribute
_VAL_KEY = {
    "complete": "deadline",
    "preempt_store": "xi",
    "preempt_load": "xi",
}


@dataclass(frozen=True, slots=True)
class TraceEvent:
    """One structured schedule event (see module docstring)."""

    seq: int
    t: float
    layer: str
    kind: str
    task: str = ""
    stage: int = -1
    shard: int = -1
    #: the job's release stamp — the cross-layer join key; None for
    #: events that are not job-scoped (admit/reject/place)
    release: float | None = None
    attrs: dict | None = None

    def get(self, key: str, default=None):
        """Attribute lookup that tolerates a missing attrs dict."""
        if self.attrs is None:
            return default
        return self.attrs.get(key, default)


class TraceRecorder:
    """Append-only event sink shared by all instrumented layers.

    ``enabled`` is resolved *once* by each instrumented run (the layers
    cache ``trace if trace.enabled else None``), so toggling it
    mid-run has no effect on a run already started — construct one
    recorder per traced run.

    ``annotate(**kv)`` sets sticky attributes merged into every
    subsequent event's ``attrs`` — e.g. the wall-clock conformance
    bench tags each retry attempt with ``annotate(attempt=n)`` so
    host-throttle retries stay visible in the trace instead of
    overwriting each other.

    The hot path appends plain tuples (a `TraceEvent` per emission
    would triple the DES's per-decision cost and blow the <5% budget the
    JAX package's ``benchmarks/obs_bench.py`` enforces); `events`
    materializes the
    `TraceEvent` view lazily on first read.
    """

    __slots__ = ("enabled", "_buf", "_events", "_sticky", "_hot_tag")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        # mixed row forms, emission order: 8-tuples from `emit` (full
        # TraceEvent field order sans seq) and 5/6-tuples from a
        # `sink` handle (compact hot form, expanded lazily by `events`)
        self._buf: list[tuple] = []
        self._events: list[TraceEvent] = []  # lazy materialized view
        self._sticky: dict = {}
        self._hot_tag: tuple[str, int] | None = None  # sink (layer, shard)

    def emit(
        self,
        kind: str,
        t: float,
        layer: str,
        task: str = "",
        stage: int = -1,
        shard: int = -1,
        release: float | None = None,
        attrs: dict | None = None,
    ) -> None:
        if not self.enabled:
            return
        sticky = self._sticky
        if sticky:
            attrs = {**sticky, **attrs} if attrs else dict(sticky)
        # seq is implicit: the row's buffer index (events materializes it)
        self._buf.append(
            (t, layer, kind, task, stage, shard, release, attrs)
        )

    def sink(self, layer: str = "des", shard: int = -1):
        """Lowest-overhead emission handle for hot loops (the DES).

        Returns ``None`` when disabled; otherwise a callable taking one
        compact row ``(t, kind, task, stage, release[, payload])``: the
        constant ``layer``/``shard`` are curried here and re-attached
        when `events` materializes, and the optional sixth element is
        either an attrs dict or — for the kinds in ``_VAL_KEY`` — the
        bare scalar attribute (``complete`` -> ``deadline``,
        ``preempt_*`` -> ``xi``), so the hot path never builds a dict.
        With no sticky annotations armed the handle *is* the buffer's
        bound ``append``: a hot loop pays one call and one small tuple
        per event. Like ``enabled``, the sticky set is resolved at
        ``sink()`` time: annotations made after a run resolved its sink
        do not retroactively apply to that run (consistent with the
        resolve-once contract in the module docstring).

        One recorder supports one sink tag: a second ``sink()`` with a
        different ``(layer, shard)`` raises — hand each hot layer its
        own recorder (the conformance harness already does).
        """
        if not self.enabled:
            return None
        tag = (layer, shard)
        if self._hot_tag is None:
            self._hot_tag = tag
        elif self._hot_tag != tag:
            raise ValueError(
                f"recorder already has sink tag {self._hot_tag}, "
                f"cannot also serve {tag}"
            )
        if not self._sticky:
            return self._buf.append
        sticky = dict(self._sticky)
        buf_append = self._buf.append

        def append(row):
            if len(row) == 6:
                v = row[5]
                attrs = (
                    {**sticky, **v}
                    if isinstance(v, dict)
                    else {**sticky, _VAL_KEY[row[1]]: v}
                )
            else:
                attrs = dict(sticky)
            buf_append(row[:5] + (attrs,))

        return append

    def annotate(self, **kv) -> None:
        """Merge sticky attributes into every future event."""
        self._sticky.update(kv)

    def clear_annotations(self) -> None:
        self._sticky.clear()

    # -- read side -----------------------------------------------------
    @property
    def events(self) -> list[TraceEvent]:
        """The emitted events as `TraceEvent` objects, emission order."""
        ev, buf = self._events, self._buf
        if len(ev) != len(buf):
            layer, shard = self._hot_tag or ("des", -1)
            for i in range(len(ev), len(buf)):
                row = buf[i]
                if len(row) == 8:  # full `emit` row
                    ev.append(TraceEvent(i, *row))
                    continue
                attrs = None
                if len(row) == 6:
                    v = row[5]
                    attrs = (
                        v
                        if isinstance(v, dict)
                        else {_VAL_KEY[row[1]]: v}
                    )
                ev.append(
                    TraceEvent(
                        i, row[0], layer, row[1], row[2], row[3],
                        shard, row[4], attrs,
                    )
                )
        return ev

    def stream(
        self,
        *,
        layer: str | None = None,
        kind: str | None = None,
        task: str | None = None,
        shard: int | None = None,
    ) -> list[TraceEvent]:
        """Events filtered by layer/kind/task/shard, emission order."""
        return [
            e
            for e in self.events
            if (layer is None or e.layer == layer)
            and (kind is None or e.kind == kind)
            and (task is None or e.task == task)
            and (shard is None or e.shard == shard)
        ]

    def counts(self) -> dict[str, int]:
        """Event count per kind (only kinds that occurred)."""
        out: dict[str, int] = {}
        for row in self._buf:
            kind = row[2] if len(row) == 8 else row[1]
            out[kind] = out.get(kind, 0) + 1
        return out


# ---------------------------------------------------------------------------
# Chrome trace event (Perfetto-loadable) export
# ---------------------------------------------------------------------------
def _track(e: TraceEvent) -> tuple:
    """(pid-ish, tid-ish) grouping of one event's timeline row."""
    return (e.layer, e.shard, e.stage)


def to_chrome_trace(
    events, *, time_scale: float = 1e6
) -> dict:
    """Render a trace as Chrome trace-event JSON (the ``traceEvents``
    dict form chrome://tracing and Perfetto load directly).

    Layout: one process per ``(layer, shard)``, one thread per stage.
    Stage occupancy becomes complete ("X") duration events — a span
    opens at ``dispatch`` and closes at the next ``preempt_store``,
    ``segment_end``, ``complete`` or ``dispatch`` on the same stage —
    so preemption windows are visible as span boundaries with the xi
    charges attached. Releases, sheds, misses and the other
    stage-less events render as instant ("i") marks.

    ``time_scale`` converts model seconds to the format's microsecond
    timestamps (default: 1 model second -> 1 trace second).
    """
    events = list(getattr(events, "events", events))
    out: list[dict] = []
    pids: dict[tuple, int] = {}

    def pid_of(layer: str, shard: int) -> int:
        key = (layer, shard)
        if key not in pids:
            pids[key] = len(pids) + 1
            name = layer if shard < 0 else f"{layer}/shard{shard}"
            out.append(
                {
                    "ph": "M",
                    "pid": pids[key],
                    "name": "process_name",
                    "args": {"name": name},
                }
            )
        return pids[key]

    # open span per (layer, shard, stage): [start_t, task, release, attrs]
    open_span: dict[tuple, list] = {}
    last_t = 0.0

    def close_span(track: tuple, t: float) -> None:
        span = open_span.pop(track, None)
        if span is None:
            return
        t0, task, release, attrs = span
        layer, shard, stage = track
        out.append(
            {
                "ph": "X",
                "pid": pid_of(layer, shard),
                "tid": stage,
                "ts": t0 * time_scale,
                "dur": max(0.0, (t - t0)) * time_scale,
                "name": task,
                "cat": "occupancy",
                "args": {"release": release, **(attrs or {})},
            }
        )

    for e in sorted(events, key=lambda e: (e.t, e.seq)):
        last_t = max(last_t, e.t)
        track = _track(e)
        if e.kind == "dispatch":
            close_span(track, e.t)
            open_span[track] = [e.t, e.task, e.release, e.attrs]
            continue
        if e.kind in ("preempt_store", "segment_end", "complete"):
            close_span(track, e.t)
        out.append(
            {
                "ph": "i",
                "pid": pid_of(e.layer, e.shard),
                "tid": e.stage if e.stage >= 0 else 0,
                "ts": e.t * time_scale,
                "name": f"{e.kind}:{e.task}" if e.task else e.kind,
                "cat": e.kind,
                "s": "t",
                "args": {"release": e.release, **(e.attrs or {})},
            }
        )
        if e.kind == "complete":
            # completed-job misses are derived, not emitted (module
            # docstring) — synthesize the instant so timelines still
            # flag them
            dl = e.get("deadline")
            if dl is not None and e.t > dl:
                out.append(
                    {
                        "ph": "i",
                        "pid": pid_of(e.layer, e.shard),
                        "tid": e.stage if e.stage >= 0 else 0,
                        "ts": e.t * time_scale,
                        "name": f"deadline_miss:{e.task}",
                        "cat": "deadline_miss",
                        "s": "t",
                        "args": {
                            "release": e.release,
                            "tardiness": e.t - dl,
                        },
                    }
                )
    for track in sorted(open_span):
        close_span(track, last_t)  # still-running at trace end
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events, path, *, time_scale: float = 1e6) -> dict:
    """`to_chrome_trace` straight to a JSON file; returns the document."""
    doc = to_chrome_trace(events, time_scale=time_scale)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
