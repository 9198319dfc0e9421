#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the repository root, with one CUDA card visible::

    python3 chip_smoke.py

Phases, each printing what it finds; any failure exits non-zero:

1. build   — compile every CUDA source of the port with nvcc, all at once.
2. kernel  — the preemptible-matmul window kernel against its plain
             PyTorch version on the card, at the serving path's shapes
             (M = 128 and the steady_city (K, N) chain, both window
             geometries; M = 1024 as examples/serve_edf.py), fp32 and
             bf16, plus one preempt/resume identity. Prints per shape the
             kernel's time (CUDA events), the plain version's, one
             ``torch.addmm`` over the same window (a yardstick the port
             never calls) and the bound from bytes and operations. Times
             are the card's own (CUDA-graph replay between CUDA events),
             and for the kernel also per launch from Python.
3. serve   — steady_city at full width (``max_dim=None``) under FIFO and
             EDF, both geometries, on a virtual clock driven by the exec
             cost model: the report must equal the port's own CPU run of
             the same tasks and inputs field for field, the finished
             jobs' chained outputs must agree, and the kernel's launch
             count must equal the windows executed plus the warm-up.
4. wall    — a short wall-clock run on the card under the PyTorch
             profiler (the card's busy time by kernel, and so its idle
             share), then ``CostModel.calibrate`` with CUDA events.
5. report  — a ``kernels`` JSON line, the card's name and power limit,
             and the result line.

Exits with code 2 and prints no result when no CUDA card is visible.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch.conformance import CostModel  # noqa: E402
from repro_torch.core.dse.space import DesignPoint  # noqa: E402
from repro_torch.core.perfmodel.exec_model import AccDesign  # noqa: E402
from repro_torch.core.perfmodel.hardware import paper_platform  # noqa: E402
from repro_torch.core.workloads import PAPER_WORKLOADS, make_taskset  # noqa: E402
from repro_torch.kernels.preemptible_matmul import (  # noqa: E402
    grid_geometry,
    matmul_resumable,
    pick_window,
)
from repro_torch.kernels.preemptible_matmul.kernel import (  # noqa: E402
    matmul_window_call,
)
from repro_torch.kernels.preemptible_matmul.ref import (  # noqa: E402
    matmul_partial_ref,
    matmul_ref,
    matmul_window_plain,
)
from repro_torch.pipeline import PharosServer, design_to_segments  # noqa: E402
from repro_torch.pipeline.serve import window_plan  # noqa: E402
from repro_torch.traffic.clock import VirtualClock, WallClock  # noqa: E402

BLOCK = (128, 128, 128)
WINDOW_TILES = 4  # PharosServer's default, the "pallas" geometry's request

#: steady_city (src/repro/traffic/scenarios.py), the paper's
#: smart-transportation baseline, on the design the JAX package's DSE
#: picks for it: ``build(get_scenario("steady_city"), paper_platform())``
#: in repro.traffic.scenarios. The DSE is not ported yet, so the design
#: is held here; tests/test_torch_serve.py checks it against that build.
STEADY_CITY_TENANTS = (("pointnet", 1.0), ("mlp_mixer", 0.8))  # (workload, ratio)
STEADY_CITY_ACCS = ((1, (256, 128, 128)), (1, (512, 128, 256)), (14, (128, 128, 128)))
STEADY_CITY_SPLITS = ((4, 1), (1, 1), (3, 6))  # [stage][task] layer counts
STEADY_CITY_MAX_UTIL = 0.9205637872700669

#: published H100 SXM peaks (NVIDIA data sheet, dense), at 700 W
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
#: kernel vs plain version on the same inputs: fp32 differs only in
#: summation order; bf16 inputs are upcast identically by both sides
MAX_REL_ERR = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: chained outputs of a full-width job, card vs CPU: 8 fp32 layers of
#: K up to 3072 summed in different orders (per layer ~1e-6 relative)
CHAIN_REL_TOL = 1e-4


def steady_city(*, device, max_dim=None, period_scale=1.0, seed=0):
    """``(design, workloads, taskset, serve_tasks)`` of steady_city;
    the same ``seed`` gives the same weights on every device."""
    names = tuple(n for n, _ in STEADY_CITY_TENANTS)
    taskset = make_taskset(
        names, tuple(r for _, r in STEADY_CITY_TENANTS), paper_platform()
    )
    workloads = [PAPER_WORKLOADS[n] for n in names]
    design = DesignPoint(
        accs=tuple(AccDesign(chips=c, block=b) for c, b in STEADY_CITY_ACCS),
        splits=STEADY_CITY_SPLITS,
        max_util=STEADY_CITY_MAX_UTIL,
    )
    tasks = design_to_segments(
        design, workloads, taskset,
        generator=torch.Generator().manual_seed(seed),
        rows=128, max_dim=max_dim, period_scale=period_scale, device=device,
    )
    return design, workloads, taskset, tasks


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call of ``fn`` issued from Python, over
    ``reps`` back-to-back calls after one warm call (CUDA events;
    operands stay hot in L2). For small windows this is the rate the
    host can launch at, not the card's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call of ``fn`` on the card alone: ``reps``
    calls captured in one CUDA graph, replayed between CUDA events, so
    no host launch time is in the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def window_bound(M, K, N, start, window, dtype):
    """Least time (ms) the card needs for one window, and what bounds it:
    the touched rows of A, columns of B and tiles of C (read once and
    written once) over memory bandwidth, against the window's flops over
    the input type's peak."""
    n_n = N // BLOCK[2]
    tiles = [divmod(f, n_n) for f in range(start, start + window)]
    rows = len({i for i, _ in tiles})
    cols = len({j for _, j in tiles})
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = (
        rows * BLOCK[0] * K * es
        + K * cols * BLOCK[2] * es
        + 2 * window * BLOCK[0] * BLOCK[2] * 4
    )
    flops = 2.0 * window * BLOCK[0] * BLOCK[2] * K
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_case(M, K, N, window, dtype, seed, start=None):
    """Kernel vs plain version for one window on the card; returns a row."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    b = (torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)).to(dtype)
    c0 = torch.randn((M, N), generator=gen, device="cuda")
    _, n_n, k_steps, total = grid_geometry(M, N, K, BLOCK)
    start = total - window if start is None else start
    kw = dict(block=BLOCK, window=window, n_tiles_n=n_n, k_steps=k_steps)
    c_kernel = matmul_window_call(start, a, b, c0.clone(), **kw)
    c_plain = matmul_window_plain(a, b, c0.clone(), start, window, BLOCK)
    torch.cuda.synchronize()
    diff = (c_kernel - c_plain).abs().max().item()
    rel = diff / c_plain.abs().max().item()
    check(
        rel <= MAX_REL_ERR[dtype],
        f"kernel vs plain at M={M} K={K} N={N} window={window} {dtype}: "
        f"rel err {rel:.3g} > {MAX_REL_ERR[dtype]}",
    )
    c = c0.clone()
    launch_ms = cuda_ms(lambda: matmul_window_call(start, a, b, c, **kw))
    ms = device_ms(lambda: matmul_window_call(start, a, b, c, **kw))
    plain_ms = device_ms(lambda: matmul_window_plain(a, b, c, start, window, BLOCK))
    i0, j0 = divmod(start, n_n)
    library_ms = None
    if j0 + window <= n_n:  # the window is one strip of one tile row
        rows = slice(i0 * BLOCK[0], (i0 + 1) * BLOCK[0])
        cols = slice(j0 * BLOCK[2], (j0 + window) * BLOCK[2])
        a_r, b_c, c_t = a[rows], b[:, cols], c[rows, cols]
        if dtype == torch.float32:
            library_ms = device_ms(lambda: torch.addmm(c_t, a_r, b_c))
    bound_ms, bound_by = window_bound(M, K, N, start, window, dtype)
    return {
        "M": M, "K": K, "N": N, "window": window, "start": start,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": diff, "max_rel_err": rel,
        "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        print(f"[build] {name} -> {os.path.relpath(path, ROOT)}")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


def phase_kernel() -> tuple[list[dict], dict]:
    """All main-path shapes, both geometries; returns the rows and the
    row the ``kernels`` line reports (the largest M=128 fp32 window)."""
    _, _, _, tasks = steady_city(device="meta")
    layers = [tuple(w.shape) for t in tasks for w in t.weights]
    cases = []
    for K, N in sorted(set(layers)):
        for backend in ("jnp", "pallas"):
            window, n_win = window_plan(
                128, N, K, block=BLOCK, backend=backend, window_tiles=WINDOW_TILES
            )
            # launches per served job: one steady_city job of each task
            per_job = n_win * layers.count((K, N))
            cases.append((128, K, N, window, backend, per_job))
    for K, N in ((512, 1024), (1024, 1024), (1024, 512)):  # serve_edf.py
        _, _, _, total = grid_geometry(1024, N, K, BLOCK)
        cases.append((1024, K, N, pick_window(total, 2), "pallas", None))
    rows = []
    print("[kernel] M K N window geometry launches/job dtype | ms launch_ms "
          "plain_ms addmm_ms bound_ms bound_by | max_rel_err  (ms: card "
          "time from CUDA-graph replay; launch_ms: back-to-back from Python)")
    for seed, (M, K, N, window, backend, per_job) in enumerate(cases):
        dtypes = [torch.float32]
        if M == 128 and backend == "jnp" and K >= 1024:
            dtypes.append(torch.bfloat16)
        for dtype in dtypes:
            row = kernel_case(M, K, N, window, dtype, seed)
            row.update(geometry=backend, launches_per_job=per_job)
            rows.append(row)
            lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
            print(
                f"[kernel] {M} {K} {N} {window} {backend} {per_job or '-'} "
                f"{row['dtype']} | {row['ms']:.5f} {row['launch_ms']:.5f} "
                f"{row['plain_ms']:.5f} "
                f"{lib} {row['bound_ms']:.5f} {row['bound_by']} | "
                f"{row['max_rel_err']:.3g}"
            )
    # preempt / resume identity on the card (paper §3.4)
    gen = torch.Generator(device="cuda").manual_seed(99)
    a = torch.randn((1024, 512), generator=gen, device="cuda")
    b = torch.randn((512, 1024), generator=gen, device="cuda") / math.sqrt(512)
    c1, prog = matmul_resumable(a, b, block=BLOCK, window_tiles=2, max_windows=3)
    check(not prog.done and prog.next_tile == 6, "preempted after 3 windows")
    part = matmul_partial_ref(a, b, 6, BLOCK)
    check(
        ((c1 - part).abs().max() / part.abs().max()).item() <= 1e-5,
        "preempted partial product equals the oracle",
    )
    matmul_resumable(b, a, block=BLOCK, window_tiles=4)  # an unrelated job
    c2, prog2 = matmul_resumable(
        a, b, block=BLOCK, window_tiles=2, start_tile=prog.next_tile, c_acc=c1
    )
    full = matmul_ref(a, b)
    rel = ((c2 - full).abs().max() / full.abs().max()).item()
    check(prog2.done and rel <= 1e-5, f"resumed product rel err {rel:.3g}")
    print(f"[kernel] preempt/resume identity: rel err {rel:.3g}")
    main = [r for r in rows if r["M"] == 128 and r["dtype"] == "float32"]
    headline = max(main, key=lambda r: r["K"] * r["N"] * r["window"])
    return rows, headline


def _serve(tasks, inputs, device, policy, backend, cost_model, horizon):
    """One virtual-clock run; returns the report and each task's first
    finished chained output."""
    clk = VirtualClock()
    srv = PharosServer(
        tasks, len(STEADY_CITY_ACCS), policy=policy, backend=backend,
        window_tiles=WINDOW_TILES, inputs=inputs, device=device,
        clock=clk.now, sleep=clk.sleep, cost_model=cost_model,
    )
    outputs = {}
    finish = srv._finish_layer_or_forward

    def capture(job, now):
        if job.layer == len(srv.tasks[job.task_id].weights) - 1:
            outputs.setdefault(job.task_id, job.c_acc.detach().cpu().clone())
        finish(job, now)

    srv._finish_layer_or_forward = capture
    report = srv.run(horizon)
    return report, outputs


def phase_serve() -> int:
    """steady_city at full width; returns the kernel launches it made."""
    design, workloads, _, gpu_tasks = steady_city(device="cuda")
    _, _, _, cpu_tasks = steady_city(device="cpu")
    gen = torch.Generator().manual_seed(1)
    inputs = [torch.randn((t.input_rows, t.weights[0].shape[0]), generator=gen)
              for t in cpu_tasks]
    widths = sorted({d for t in gpu_tasks for w in t.weights for d in w.shape})
    mb = sum(w.numel() * 4 for t in gpu_tasks for w in t.weights) / 1e6
    print(f"[serve] steady_city full width: widths {widths}, {mb:.1f} MB of "
          f"fp32 weights, {sum(len(t.weights) for t in gpu_tasks)} layers")
    # chained reference in float64 on the CPU
    want = []
    for t, x in zip(cpu_tasks, inputs):
        y = x.double()
        for w in t.weights:
            y = y @ w.double()
        want.append(y)
    horizon = 20 * max(t.period for t in gpu_tasks)
    warm = sum(len(t.weights) for t in gpu_tasks)
    matmul_window_call.launches = 0  # the main path starts here
    total = 0
    for backend in ("jnp", "pallas"):
        cm = CostModel.from_exec_model(
            design, workloads, gpu_tasks, backend=backend,
            window_tiles=WINDOW_TILES,
        )
        for policy in ("fifo", "edf"):
            before = matmul_window_call.launches
            t0 = time.perf_counter()
            rep, out = _serve(gpu_tasks, inputs, "cuda", policy, backend, cm, horizon)
            torch.cuda.synchronize()
            t_gpu = time.perf_counter() - t0
            launched = matmul_window_call.launches - before
            total += launched
            t0 = time.perf_counter()
            rep_cpu, out_cpu = _serve(cpu_tasks, inputs, "cpu", policy, backend, cm, horizon)
            t_cpu = time.perf_counter() - t0
            check(
                dataclasses.asdict(rep) == dataclasses.asdict(rep_cpu),
                f"{policy}/{backend}: card report equals the CPU report",
            )
            check(
                launched == rep.windows_executed + warm,
                f"{policy}/{backend}: {launched} launches vs "
                f"{rep.windows_executed} windows + {warm} warm-up",
            )
            check(rep.jobs_completed > 0 and len(out) == len(gpu_tasks),
                  f"{policy}/{backend}: every task finished a job")
            errs = []
            for i in range(len(gpu_tasks)):
                y = out[i]
                check(bool(torch.isfinite(y).all()), "finite outputs")
                scale = want[i].abs().max().item()
                errs.append(max(
                    (y - out_cpu[i]).abs().max().item() / scale,
                    (y.double() - want[i]).abs().max().item() / scale,
                ))
            check(max(errs) <= CHAIN_REL_TOL,
                  f"{policy}/{backend}: chained outputs rel err {max(errs):.3g}")
            print(
                f"[serve] {policy}/{backend}: released {rep.jobs_released} "
                f"completed {rep.jobs_completed} windows {rep.windows_executed} "
                f"preemptions {rep.preemptions} misses "
                f"{sum(rep.deadline_misses.values())} | launches {launched} | "
                f"report == cpu report | chained rel err {max(errs):.3g} | "
                f"host s: card {t_gpu:.3f} cpu {t_cpu:.3f}"
            )
    check(matmul_window_call.launches == total, "launch count adds up")
    return total


def phase_wall() -> None:
    period_scale = 100.0  # analytic periods of ~0.1 ms -> ~5-11 ms
    _, _, _, tasks = steady_city(device="cuda", period_scale=period_scale)
    clk = WallClock()
    srv = PharosServer(tasks, len(STEADY_CITY_ACCS), policy="edf",
                       device="cuda", clock=clk.now, sleep=clk.sleep)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rep = srv.run(0.3)
        wall = time.perf_counter() - t0
    check(rep.jobs_completed > 0, "wall-clock run completed jobs")
    # card-side time by kernel (warm-up included): what the card did in
    # the run, and so how long it sat idle
    on_card = {
        e.key: (e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    }
    busy_us = sum(t for t, _ in on_card.values())
    if busy_us > 0:
        print(f"[wall] card busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms "
              f"wall ({busy_us / 1e4 / wall:.2f}%), {rep.windows_executed} "
              f"windows + {sum(len(t.weights) for t in tasks)} warm-up")
        for key, (t_us, n) in sorted(on_card.items(), key=lambda kv: -kv[1][0]):
            print(f"[wall]   {t_us / 1e3:.3f} ms in {n} x {key[:70]}")
    else:
        print("[wall] card busy time: not measured (profiler saw no card time)")
    for t in tasks:
        p = rep.response_percentiles(t.name)
        print(
            f"[wall] edf {t.name}: period {t.period * 1e3:.3f} ms, "
            f"completed {len(rep.response_times[t.name])}, misses "
            f"{rep.deadline_misses[t.name]}, response p50 {p['p50'] * 1e3:.3f} "
            f"ms p99 {p['p99'] * 1e3:.3f} ms"
        )
    cm = CostModel.calibrate(srv, reps=5)
    check(cm.device == torch.cuda.get_device_name(0), "calibration names its card")
    for t, costs, wins in zip(tasks, cm.layer_costs, cm.layer_windows):
        per_window = ", ".join(
            f"{c / w * 1e6:.1f}" for c, w in zip(costs, wins)
        )
        print(f"[wall] calibrated on {cm.device}: {t.name} per-window WCET us "
              f"[{per_window}]")
    # the measured model drives a virtual-clock run of the same tasks
    vclk = VirtualClock()
    rep_v = PharosServer(tasks, len(STEADY_CITY_ACCS), policy="edf",
                         device="cuda", clock=vclk.now, sleep=vclk.sleep,
                         cost_model=cm).run(0.05)
    check(rep_v.jobs_completed > 0, "calibrated model drives serving")
    print(f"[wall] calibrated virtual run: completed {rep_v.jobs_completed} "
          f"misses {sum(rep_v.deadline_misses.values())}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    phase_build()
    rows, head = phase_kernel()
    launches = phase_serve()
    phase_wall()
    kernel = {
        "name": "preemptible_matmul_window",
        "route": "cuda",
        "source": "src/repro_torch/csrc/preemptible_matmul.cu",
        "replaces": "src/repro/kernels/preemptible_matmul/kernel.py:36",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "float32"),
        "ms": head["ms"],
        "launch_ms": head["launch_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("M", "K", "N", "window", "dtype")},
    }
    print(json.dumps({"kernels": [kernel]}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
