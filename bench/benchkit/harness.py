"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

`execute` takes the device to run on; only `bench/run.py` decides that a
card is there (and fails where none is). The tests call `execute` with
``device="cpu"`` at smoke sizes, through the kernels' plain versions."""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from benchkit import guard, trace as trace_mod
from benchkit.spec import Spec


@dataclass
class Call:
    """One call into the program: when it was due, when its result was
    on the host, and the rows and sequence length it carried."""
    due: float
    done: float
    rows: int
    seq: int

    @property
    def tokens(self) -> int:
        return self.rows * self.seq


@dataclass
class Run:
    """What a run recorded, as the metrics' readers see it: ``family``
    is the configuration's family adapter (`benchkit.spec`), ``sizes``
    its sizes."""
    cell: dict
    sizes: object
    traffic: dict
    device: str
    family: object = None
    setup_s: float = math.nan
    calls: list = field(default_factory=list)
    t0: float = math.nan
    t1: float = math.nan
    peak_window_bytes: int = 0
    trace: trace_mod.Trace | None = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def on_card(self) -> bool:
        return self.device.startswith("cuda")


class Loop:
    """The closed loop's clock: each call is due when the previous one's
    result reached the host (the first at the window's start). The
    window closes at the first completion after ``seconds``, or after
    ``max_calls`` calls."""

    def __init__(self, run: Run, seconds: float, max_calls: int | None):
        self.run, self.seconds, self.max_calls = run, seconds, max_calls
        self.t0 = self.last = time.perf_counter()
        run.t0 = self.t0

    def more(self) -> bool:
        n = len(self.run.calls)
        if self.max_calls is not None and n >= self.max_calls:
            return False
        return n == 0 or self.last - self.t0 < self.seconds

    def due(self) -> float:
        return self.last

    def done(self, due: float, rows: int, seq: int) -> None:
        self.last = time.perf_counter()
        self.run.calls.append(Call(due, self.last, rows, seq))
        self.run.t1 = self.last


def span(name: str):
    """A benchmark span (``bench.<name>``) on the profiler's timeline."""
    return torch.profiler.record_function(f"bench.{name}")


@dataclass
class Ctx:
    """What a driver is handed: the cell's pieces and the run's options."""
    spec: Spec
    cell: dict
    config: dict
    family: object
    sizes: object
    traffic: dict
    limits: dict
    reference: object
    seed: int
    device: str

    @property
    def arch(self):
        return self.family.arch_config(self.sizes)


def context(spec: Spec, workload: str, seed: int, device: str) -> Ctx:
    cell = spec.cell(workload)
    _, config = spec.config(cell["config"])
    family = spec.module("families", config["reference"])
    return Ctx(spec=spec, cell=cell, config=config, family=family,
               sizes=family.sizes(cell["config"], config),
               traffic=spec.data("traffic", cell["traffic"]),
               limits=spec.data("limits", workload),
               reference=spec.module("reference", config["reference"]),
               seed=seed, device=device)


def driver_of(ctx: Ctx):
    return ctx.spec.module("drivers", ctx.traffic["driver"]).Driver(ctx)


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def power_limit_w() -> float | None:
    """The card's power limit by ``nvidia-smi``; None where it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class CollectorPauses:
    """The Python collector's passes while it is in ``gc.callbacks``: how
    many of each generation, and their seconds on the host clock."""

    def __init__(self):
        self.count, self.seconds, self._start = [0, 0, 0], [0.0, 0.0, 0.0], 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
            return
        g = info["generation"]
        self.count[g] += 1
        self.seconds[g] += time.perf_counter() - self._start

    def __str__(self) -> str:
        return (f"collector {sum(self.count)} passes, {1e3 * sum(self.seconds):.1f} ms; "
                f"{self.count[2]} full, {1e3 * self.seconds[2]:.1f} ms")


def verdict(checks) -> bool:
    """``correct``: every number within its limit (a NaN is not)."""
    return bool(checks) and all(v <= lim for _, v, lim in checks)


def call_times(run: Run, worst: int = 3) -> str:
    """The window's calls on the host clock, due to done: the median and
    the longest few, each with its index, so that a stall can be placed."""
    took = [(c.done - c.due) * 1e3 for c in run.calls]
    if not took:
        return "no calls"
    order = sorted(range(len(took)), key=took.__getitem__, reverse=True)[:worst]
    longest = ", ".join(f"#{i} {took[i]:.1f}" for i in order)
    return f"calls median {statistics.median(took):.1f} ms, longest {longest} ms"


def _profiler(device: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            root, device: str, t_process: float | None = None) -> dict:
    """Run ``workload`` once; returns ``{"line": <the result object>,
    "checks": [(name, value, limit)], "notes": [str], "banned": [the
    JAX modules loaded], "run": <the Run>}``. A NaN fails its limit."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = Spec(Path(root))
    ctx = context(spec, workload, seed, device)
    on_card = device.startswith("cuda")
    run = Run(cell=ctx.cell, sizes=ctx.sizes, traffic=ctx.traffic, device=device,
              family=ctx.family)
    drv = driver_of(ctx)
    drv.setup()
    # what set-up made (modules, weights, the program's objects) lives to
    # the end of the run: frozen, the collector's full passes in the
    # window no longer walk it; the window's own garbage is still collected
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_process

    prof = _profiler(device) if trace else contextlib.nullcontext()
    max_calls = ctx.traffic.get("trace_calls") if trace else None
    pauses = CollectorPauses()
    gc.callbacks.append(pauses)
    try:
        with prof:
            loop = Loop(run, seconds, max_calls)
            drv.window(loop)
    finally:
        gc.callbacks.remove(pauses)
        gc.unfreeze()
    if on_card:
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
    if trace:
        run.trace = trace_mod.read(prof)
        del prof

    notes = []
    values = {}
    for m in spec.metrics(workload, traced=trace):
        v = spec.module("metrics", m["name"]).read(run)
        if v is None:
            notes.append(f"{m['name']}: not measured")
            continue
        values[m["name"]] = {"value": v, "unit": m["unit"]}

    attempted = sum(c.rows for c in run.calls) if drv.counts_rows else len(run.calls)
    drv.release()
    free_device()
    t_check = time.perf_counter()
    checks = drv.check()
    notes.append(f"set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s "
                 f"({len(run.calls)} calls), check {time.perf_counter() - t_check:.3f} s")
    notes.append(call_times(run))
    notes.append(str(pauses))
    if on_card:
        notes.append(f"allocator retries {torch.cuda.memory_stats().get('num_alloc_retries', 0)}")
    correct = verdict(checks)

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": ctx.cell.get("chips", 1),
           "memory_peak_bytes": max(setup_peak, run.peak_window_bytes) if on_card else 0}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    if on_card:
        dev["power_limit_w"] = power_limit_w()
    line = {"correct": correct, "attempted": attempted, "failed": 0,
            "metrics": values, "device": dev}
    if trace and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    found = guard.banned_modules()
    return {"line": line, "checks": checks, "notes": notes, "banned": found,
            "run": run}
