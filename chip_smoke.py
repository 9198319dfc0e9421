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
             bf16, plus one preempt/resume identity; and at the largest
             K and the largest N of the StableLM-1.6B decode chain the
             gateway serves, in four-tile windows. Prints per shape the
             kernel's time (CUDA events), the plain version's, one
             ``torch.addmm`` over the same window (a yardstick the port
             never calls) and the bound from bytes and operations. Times
             are the card's own (CUDA-graph replay between CUDA events),
             and for the kernel also per launch from Python.
3. serve   — steady_city, on the design the port's DSE picks, at full
             width (``max_dim=None``) under FIFO and
             EDF, both geometries, on a virtual clock driven by the exec
             cost model: the report must equal the port's own CPU run of
             the same tasks and inputs field for field, the finished
             jobs' chained outputs must agree, and the kernel's launch
             count must equal the windows executed plus the warm-up.
4. wall    — a short wall-clock run on the card under the PyTorch
             profiler (the card's busy time by kernel, and so its idle
             share), then ``CostModel.calibrate``, which times each
             window on the host clock through the sync after it, as the
             serving loop pays; beside each calibrated WCET the same
             window's CUDA-event time around its launch, and the card's
             own time (CUDA-graph replay) as its share of the WCET.
5. gateway — the port's DSE picks the designs of steady_city (checked
             against the JAX package's pick), rush_hour, overload_2x,
             av_stack and copilot_decode, printing each search's own
             time. Then rush_hour, overload_2x (reject-newest shedding,
             which must shed) and av_stack (the mixed-criticality mode
             switch, which must switch) at full width, then
             copilot_decode's StableLM-1.6B decode chain (121 layers,
             8.09 GB fp32, 1300 four-tile windows per job) beside its
             DeiT safety tenant for 4 decode periods, each through a
             `TrafficGateway` on a virtual clock driven by the exec cost
             model: the card's report must equal the port's CPU run of
             the same bundle field for field, the window kernel's
             launches must equal the windows executed plus the warm-up,
             and every finished job's chained output of every tenant is
             held against a float64 chain on the card. StableLM's chain
             bound must also fail the same chain through 1xTF32
             products. Last, a short wall-clock run of rush_hour under
             the profiler (busy share, windows per second, host time per
             window, per-tenant releases, sheds, misses and p99).
6. sharded — the port's `provision` runs its DSE for sharded_city (4
             periodic tenants: PointNet, MLP-Mixer, ResMLP, DeiT-T) and
             places them over 2 shards, each shard's admission proving its
             contract; the provisioned `ShardedGateway` serves 40 periods
             of the slowest tenant on one shared virtual clock. Then the
             same tenants on an elastic fleet (every shard built over all
             four) with one live migration, which must commit to the
             other shard; then the `Autoscaler` over two copies of
             multi_tenant_rush (8 tenants, 1 to 4 shards) through a
             quarter of them, all, and one per peak shard: the fleet must
             grow and then shrink. Every shard's server is a
             `PharosServer` on the card at full width, driven by the exec
             cost model; each run's report, trace (every event kind) and
             trace metrics must equal the port's CPU run of the same
             bundle, its window launches the windows plus each server's
             warm-up, and every completed job's chained output of every
             shard is held against float64.
7. conformance — the conformance harness (analysis >= DES >= runtime):
             `run_conformance` over steady_city, rush_hour, sensor_fusion
             and copilot_decode (StableLM-1.6B's 121-layer decode chain)
             under FIFO and EDF at full width on the card, on the designs
             `build` picks, every case ok, one window launch per window
             executed, and the first three scenarios' cases equal to the
             port's CPU run field for field; the sharded, shedding,
             mode-switch, migration and DSE legs at the reference's own
             settings and the harness's surrogate width (512); then
             `run_wallclock_case` on steady_city and rush_hour at full
             width and the reference's test settings (8 periods, 2
             calibration reps, margin 8, one host-noise retry), and
             steady_city in calibrated-admission mode (two retries),
             under the profiler: per task the measured median and max
             response beside the DES prediction and the bound. Prints a
             ``conformance`` JSON line before the ``kernels`` line.
8. lmkern  — the flash-attention, WKV-6 and selective-scan kernels
             against their plain versions at the LM path's shapes
             (Mistral-NeMo attention at S = 2048, a ragged S = 1000 and
             head width 64; RWKV-6's WKV at S = 2048 and a ragged S;
             Jamba's scan at S = 2048, a ragged S = 1000, from a
             non-zero h0 and with A drawn per element), each with its
             card time, the plain version's,
             ``scaled_dot_product_attention`` for flash (a yardstick the
             port never calls), bound and error; for WKV-6 and the scan
             also the bytes each must move over its card time, and its
             share of the bound.
9. lm      — Mistral-NeMo-12B and RWKV-6-7B at full width and depth, then
             Jamba-v0.1-52B at full width and 16 of its 32 layers (all 32
             hold 102.9 GB in bf16, more than the card's 80 GB), then the
             stub frontends: MusicGen-medium at full width and depth and
             InternVL2-76B at full width and 8 of its 80 layers (all 80
             hold 141 GB), fed bf16 embeddings drawn from the seed, one
             after the other, with random bf16 weights from a CUDA
             generator: prefill of a 2 x 2048 prompt and 16 greedy decode
             steps through ``repro_torch.launch.steps``, with the
             kernels' launch counts (one flash per attention layer, one
             WKV per time-mix layer and one scan per mamba layer per
             prefill, none in decode), decode against a longer prefill
             (for Jamba also an int8-KV decode step against the bf16
             one), a 2-layer full-width model
             against the port's own CPU run of the same weights and
             tokens (or embeddings), and the times
             under the PyTorch profiler with the card's busy share.
10. train  — the flash forward's log-sum-exp at Mistral-NeMo's shape
             (against the plain version's; the output the same bits with
             and without it; the forward's time both ways); the
             flash-attention backward kernel, fed that log-sum-exp,
             against its plain version at StableLM-1.6B's training shape
             (B 8, S 2048, 32 heads of 64, bf16), Mistral-NeMo's GQA shape
             (B 2, S 2048, 32/8 heads of 128, bf16) and a ragged fp32
             shape, each gradient within ``BACKWARD_TOL`` and two launches
             bit-identical, with its card time, the plain version's,
             SDPA's backward alone (a yardstick the port never calls), its
             bound and its split floor (P and dS as bf16 hi + lo: 10
             products per pair), and the flash forward at StableLM's
             training shape with its bound; the WKV-6 and selective-scan
             backward kernels against their plain versions at the
             training shapes (B 8 x 2048: RWKV-6's 64 heads of 64,
             Jamba's d_inner 8192) and at B 2 x 2048, within 1e-4 of the
             max and two launches bit-identical, with card time, plain
             time and bound; one train step of StableLM-1.6B and one of
             RWKV-6-7B at full width and 2 layers against the port's own
             CPU run (loss, grad norm, every gradient leaf, every
             parameter after the AdamW update); then the main path, ``train_loop`` on StableLM-1.6B
             at full width and depth (24 layers, bf16 parameters, fp32
             AdamW moments) for 8 steps at global batch 8 x seq 2048,
             with the objects the earlier phases left alive frozen out of
             the garbage collector first:
             finite losses and grad norms, two flash forward launches
             per layer per step (one more under remat) and one backward,
             no other LM kernel; ms per step, tokens/s, card peak memory,
             the last step under the profiler (busy share, top kernels,
             each backward pass's card time per step);
             a checkpoint resume on the card (smoke Minitron-4B at head
             width 64, 20 steps + resume to 30 against 30 straight); last,
             ``train_loop`` on RWKV-6-7B at full width and 8 of its 32
             layers and on Jamba-v0.1-52B at full width and its first
             layer (mamba, dense SwiGLU), 8 steps of 8 x 2048 each
             (``RECURRENT_TRAIN`` says why those depths), with the same
             readings and two forward and one backward launch of WKV-6 or
             the scan per recurrent layer per step.
11. pipeline — the pipeline executor (GPipe, one stage per rank over
             ``torch.distributed``): StableLM-1.6B at full width and
             depth on 4 spawned stage ranks of 6 layers, all on this
             card, talking over gloo (NCCL takes one card per rank), each
             hop staged through pinned host memory; every rank builds
             the model from the seed and keeps its layers, rank 0 injects
             8 microbatches of 2 x 2048 bf16 embeddings drawn from the
             seed. The output must equal rank 0's sequential
             ``reference_backbone`` bit for bit, and each rank must launch
             the flash kernel once per microbatch per attention layer it
             holds (48 each, 192 in all, the sequential run's count).
             Prints each rank's milliseconds, peak memory, launches,
             hops and bytes per hop, and the sequential run's time.
12. spmd   — the SPMD policy. The dry run (``repro_torch.launch.dryrun``,
             in a subprocess: torch's fake process group of 256 ranks)
             traces StableLM-1.6B x train_4k and Granite-MoE-3B x
             prefill_32k on the 16x16 mesh, printing each record:
             per-device GB, FLOPs, collective bytes by kind, the roofline
             terms at the H100's peaks and the dominant one. Then
             Granite-MoE-3B (32 layers, 40 experts in 48 banks, top 8)
             through ``launch.steps.lowerable`` on a 1 x 1 mesh (a one-
             rank nccl group), its parameters distributed at the
             reference's shardings: at capacity factor E / top_k the
             last-token logits of a B 2 x 2048 prefill must match the
             NO_POLICY (dropless) prefill within CARD_CPU_REL_L2; at its
             own factor, one warm-up and three timed prefills (ms, one
             flash launch per layer, no MoE host read, the share of
             (token, expert) slots dropped). Then the train step at 8
             layers, B 8 x 2048: the first step's loss at E / top_k
             against the NO_POLICY step within SPMD_LOSS_RTOL, then a
             warm-up and four timed steps (ms, tokens/s, peak memory,
             flash launches, the model FLOP rate from
             ``roofline.analytic_cost`` and its share of 989 TFLOP/s).
13. report — a ``conformance`` and a ``kernels`` JSON line (seven
             hand-written kernels; flash attention's launches are the
             LM phase's Mistral-NeMo run, the pipeline's and the spmd
             phase's), the card's name and power limit, and the result
             line.

Exits with code 2 and prints no result when no CUDA card is visible.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch.configs import load_config, smoke_config  # noqa: E402
from repro_torch.conformance import (  # noqa: E402
    DEFAULT_SCENARIOS,
    POLICIES,
    ConformanceConfig,
    CostModel,
    run_case,
    run_conformance,
    run_dse_case,
    run_migration_case,
    run_mode_switch_case,
    run_sharded_case,
    run_shedding_case,
    run_wallclock_case,
)
from repro_torch.core.dse import DSEConfig, explore, provision  # noqa: E402
from repro_torch.core.perfmodel.hardware import paper_platform  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    attention_backward_flops,
    attention_flops,
    flash_attention_backward_call,
    flash_attention_call,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    BACKWARD_TOL,
    KERNEL_TOL as FLASH_TOL,
    attention_backward_plain,
    attention_plain,
    tol_ratio,
)
from repro_torch.kernels.mamba_scan.kernel import BWD_FLOPS as SCAN_BWD_FLOPS  # noqa: E402
from repro_torch.kernels.mamba_scan.kernel import (  # noqa: E402
    mamba_scan_backward_call,
    mamba_scan_call,
    scan_backward_flops,
    scan_flops,
)
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    mamba_scan_backward_plain,
    mamba_scan_plain,
)
from repro_torch.kernels.preemptible_matmul import (  # noqa: E402
    grid_geometry,
    matmul_resumable,
    matmul_window,
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
from repro_torch.kernels.rwkv6_scan.kernel import BWD_FLOPS as WKV_BWD_FLOPS  # noqa: E402
from repro_torch.kernels.rwkv6_scan.kernel import (  # noqa: E402
    rwkv6_scan_backward_call,
    rwkv6_scan_call,
    wkv_backward_flops,
    wkv_flops,
)
from repro_torch.kernels.rwkv6_scan.ref import (  # noqa: E402
    rwkv6_scan_backward_plain,
    rwkv6_scan_plain,
)
from repro_torch.data import DataConfig, SyntheticTokenDataset  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.dryrun import summary as dryrun_summary  # noqa: E402
from repro_torch.launch.mesh import make_dev_mesh  # noqa: E402
from repro_torch.launch.shapes import ShapeCase  # noqa: E402
from repro_torch.launch.sharding import distribute_tree  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    auto_micro_batches,
    lowerable,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    value_and_grad,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.module import param_bytes, param_count  # noqa: E402
from repro_torch.obs import EVENT_KINDS, MetricsRegistry, TraceRecorder, trace_diff  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.pipeline import PharosServer, design_to_segments  # noqa: E402
from repro_torch.pipeline.executor import BackboneCase, backbone_job, launch  # noqa: E402
from repro_torch.pipeline.serve import window_plan  # noqa: E402
from repro_torch.traffic import (  # noqa: E402
    CRITICALITY_HI,
    AdmissionController,
    Autoscaler,
    MigrationController,
    MigrationPlan,
    ModeController,
    RampPhase,
    ShardedGateway,
    TrafficGateway,
    build,
    get_scenario,
    materialize,
    replicate,
    resolve_problem,
)
from repro_torch.traffic.clock import VirtualClock, WallClock  # noqa: E402
from repro_torch.traffic.shedding import get_policy  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

BLOCK = (128, 128, 128)
WINDOW_TILES = 4  # PharosServer's default, the "pallas" geometry's request

#: steady_city's design (accelerators as (chips, block), [stage][task]
#: layer splits, max_util) as the JAX package's DSE picks it. Earlier
#: versions of this script served it from these constants; the port's
#: own DSE now picks the design, and the gateway phase checks that it
#: is this one.
STEADY_CITY_REFERENCE_DESIGN = (
    ((1, (256, 128, 128)), (1, (512, 128, 256)), (14, (128, 128, 128))),
    ((4, 1), (1, 1), (3, 6)),
    0.9205637872700669,
)

#: published H100 SXM peaks (NVIDIA data sheet, dense), at 700 W: the
#: roofline's, so that one set of peaks serves the bounds and the dry run
PEAK_BYTES_S = roofline.HBM_BW
PEAK_FLOPS = {torch.float32: roofline.PEAK_FLOPS_F32,
              torch.bfloat16: roofline.PEAK_FLOPS}
#: the TF32 tensor-core peak: the window kernel's fp32 path runs three
#: TF32 products per fp32 one (3xTF32) there
PEAK_TF32_FLOPS = 495e12
#: the bf16 flash kernel feeds P as two bf16 terms (P_hi + P_lo), so its
#: P V product runs twice: 1.5x the products of one pass
FLASH_SPLIT_PRODUCTS = 1.5
#: kernel vs plain version on the same inputs: the kernel's fp32 path
#: (3xTF32) is fp32-exact to 1e-5 and differs in summation order; bf16
#: products are exact in fp32 on both sides
MAX_REL_ERR = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: chained outputs of a full-width job, card vs CPU: 8 fp32 layers of
#: K up to 3072 summed in different orders (per layer ~1e-6 relative).
#: It also bounds StableLM-1.6B's decode chain against float64: 121 fp32
#: layers of K up to 11264. On an H100 80GB HBM3 at 700 W the 3xTF32
#: windows read 6.9e-6 of the max there; the same chain through one
#: TF32 product per fp32 one (a window that dropped the two correction
#: products) reads 3.4e-3. The bound sits between them, so a
#: lower-precision window fails it; the gateway phase checks that the
#: TF32 yardstick's reading exceeds it.
CHAIN_REL_TOL = 1e-4


def build_search() -> dict:
    """The DSE search `repro_torch.traffic.scenarios.build` runs: beam,
    at build's own defaults for ``max_m`` and ``beam_width``."""
    params = inspect.signature(build).parameters
    return dict(method="beam", max_m=params["max_m"].default,
                beam_width=params["beam_width"].default)


def search_design(name: str):
    """``(built scenario, explore result)``: the port's DSE runs the
    search `traffic.scenarios.build` runs, and `build` materializes the
    design it picks into the scenario's contracts and seeded traffic."""
    scenario, platform = get_scenario(name), paper_platform()
    workloads, taskset = resolve_problem(scenario, platform)
    res = explore(workloads, taskset, platform, **build_search())
    check(res.best is not None, f"{name}: the DSE found a feasible design")
    return build(scenario, platform, design=res.best), res


def design_summary(design) -> tuple:
    """A design as (accelerators as (chips, block), splits, max_util)."""
    return (tuple((a.chips, tuple(a.block)) for a in design.accs),
            design.splits, design.max_util)


def steady_city(*, device, max_dim=None, period_scale=1.0, seed=0):
    """``(design, workloads, taskset, serve_tasks)`` of steady_city (the
    paper's smart-transportation baseline, PointNet + MLP-Mixer) on the
    design the port's DSE picks for it; the same ``seed`` gives the same
    weights on every device."""
    built, _ = search_design("steady_city")
    tasks = design_to_segments(
        built.design, list(built.workloads), built.taskset,
        generator=torch.Generator().manual_seed(seed),
        rows=128, max_dim=max_dim, period_scale=period_scale, device=device,
    )
    return built.design, list(built.workloads), built.taskset, tasks


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
    """Least time (ms) the card needs for one window, what bounds it, and
    (fp32 only, else None) the operations term at the fp32 FMA peak: the
    touched rows of A, columns of B and tiles of C (read once and written
    once) over memory bandwidth, against the window's operations over the
    peak of the units that run them. fp32 inputs run as three TF32
    products at the TF32 tensor-core peak (the window kernel's 3xTF32);
    bf16 inputs as one product at the bf16 peak."""
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
    if dtype == torch.float32:
        t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
        fma_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    else:
        t_ops, fma_ms = flops / PEAK_FLOPS[dtype] * 1e3, None
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            fma_ms)


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
    bound_ms, bound_by, fma_ms = window_bound(M, K, N, start, window, dtype)
    return {
        "M": M, "K": K, "N": N, "window": window, "start": start,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": diff, "max_rel_err": rel,
        "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "fp32_fma_bound_ms": fma_ms,
    }


def _demangle(symbol: str) -> str:
    """A kernel's C++ name, where the toolchain's c++filt is at hand."""
    if shutil.which("c++filt") is None:
        return symbol
    out = subprocess.run(["c++filt", symbol], capture_output=True, text=True)
    return out.stdout.strip() or symbol


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        print(f"[build] {name} -> {os.path.relpath(path, ROOT)}")
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                print(f"[build]   {_demangle(line.split(chr(39))[1])[:110]}")
            elif "registers" in line or "spill" in line:
                print(f"[build]     {line.strip()}")


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
    # the gateway's StableLM-1.6B decode chain: its largest K and its
    # largest N, in the gateway's four-tile windows
    for K, N, n_layers in STABLELM_WINDOWS:
        window, n_win = window_plan(128, N, K, block=BLOCK, backend=GATEWAY_BACKEND,
                                    window_tiles=WINDOW_TILES)
        cases.append((128, K, N, window, "stablelm", n_win * n_layers))
    rows = []
    print("[kernel] M K N window geometry launches/job dtype | ms launch_ms "
          "plain_ms addmm_ms bound_ms bound_by fp32_fma_bound_ms | max_rel_err  "
          "(ms: card time from CUDA-graph replay; launch_ms: back-to-back from "
          "Python; bound: fp32 as 3xTF32 at the TF32 tensor-core peak, "
          f"{PEAK_TF32_FLOPS / 1e12:g} TFLOP/s; fp32_fma_bound_ms: the same "
          f"flops at the fp32 FMA peak, {PEAK_FLOPS[torch.float32] / 1e12:g} "
          "TFLOP/s)")
    for seed, (M, K, N, window, geometry, per_job) in enumerate(cases):
        backend = GATEWAY_BACKEND if geometry == "stablelm" else geometry
        dtypes = [torch.float32]
        if M == 128 and backend == "jnp" and K >= 1024:
            dtypes.append(torch.bfloat16)
        for dtype in dtypes:
            row = kernel_case(M, K, N, window, dtype, seed)
            row.update(geometry=backend, launches_per_job=per_job,
                       chain="stablelm" if geometry == "stablelm" else "steady_city")
            rows.append(row)
            lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.5f}"
            fma = ("-" if row["fp32_fma_bound_ms"] is None
                   else f"{row['fp32_fma_bound_ms']:.5f}")
            print(
                f"[kernel] {M} {K} {N} {window} {geometry} {per_job or '-'} "
                f"{row['dtype']} | {row['ms']:.5f} {row['launch_ms']:.5f} "
                f"{row['plain_ms']:.5f} "
                f"{lib} {row['bound_ms']:.5f} {row['bound_by']} {fma} | "
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
    main = [r for r in rows if r["M"] == 128 and r["dtype"] == "float32"
            and r["chain"] == "steady_city"]
    headline = max(main, key=lambda r: r["K"] * r["N"] * r["window"])
    return rows, headline


def capture_outputs(srv, on_output) -> None:
    """Call ``on_output(task_id, c_acc)`` with each job's chained output
    as the job finishes its last layer (before the server forwards or
    completes it)."""
    finish = srv._finish_layer_or_forward

    def capture(job, now):
        if job.layer == len(srv.tasks[job.task_id].weights) - 1:
            on_output(job.task_id, job.c_acc)
        finish(job, now)

    srv._finish_layer_or_forward = capture


def _serve(tasks, n_stages, inputs, device, policy, backend, cost_model, horizon):
    """One virtual-clock run; returns the report and each task's first
    finished chained output."""
    clk = VirtualClock()
    srv = PharosServer(
        tasks, n_stages, policy=policy, backend=backend,
        window_tiles=WINDOW_TILES, inputs=inputs, device=device,
        clock=clk.now, sleep=clk.sleep, cost_model=cost_model,
    )
    outputs = {}
    capture_outputs(srv, lambda i, y: outputs.setdefault(i, y.detach().cpu().clone()))
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
    reset_counts()  # the main path starts here
    total = 0
    for backend in ("jnp", "pallas"):
        cm = CostModel.from_exec_model(
            design, workloads, gpu_tasks, backend=backend,
            window_tiles=WINDOW_TILES,
        )
        for policy in ("fifo", "edf"):
            before = matmul_window_call.launches
            t0 = time.perf_counter()
            rep, out = _serve(gpu_tasks, design.n_stages, inputs, "cuda", policy,
                              backend, cm, horizon)
            torch.cuda.synchronize()
            t_gpu = time.perf_counter() - t0
            launched = matmul_window_call.launches - before
            total += launched
            t0 = time.perf_counter()
            rep_cpu, out_cpu = _serve(cpu_tasks, design.n_stages, inputs, "cpu",
                                      policy, backend, cm, horizon)
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
    check(flash_attention_call.launches == rwkv6_scan_call.launches
          == mamba_scan_call.launches == 0,
          "the serving path launches no LM kernel")
    return total


def phase_wall() -> None:
    period_scale = 100.0  # analytic periods of ~0.1 ms -> ~5-11 ms
    design, _, _, tasks = steady_city(device="cuda", period_scale=period_scale)
    clk = WallClock()
    srv = PharosServer(tasks, design.n_stages, policy="edf",
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
    split = calibration_split(srv, cm, reps=5)
    print(f"[wall] calibrated on {cm.device}, per window, us: WCET (host clock "
          "through the sync) / CUDA events around the launch / the card alone "
          "(graph replay) = its share of the WCET")
    for t, rows in zip(tasks, split):
        print(f"[wall]   {t.name}: " + ", ".join(
            f"{r['wcet_us']:.1f}/{r['event_us']:.1f}/{r['card_us']:.1f}"
            f"={r['card_share']:.1%}" for r in rows))
    # the measured model drives a virtual-clock run of the same tasks
    vclk = VirtualClock()
    rep_v = PharosServer(tasks, design.n_stages, policy="edf",
                         device="cuda", clock=vclk.now, sleep=vclk.sleep,
                         cost_model=cm).run(0.05)
    check(rep_v.jobs_completed > 0, "calibrated model drives serving")
    print(f"[wall] calibrated virtual run: completed {rep_v.jobs_completed} "
          f"misses {sum(rep_v.deadline_misses.values())}")


def calibration_split(srv, cm, reps) -> list[list[dict]]:
    """Per task and layer of ``srv``, the window `CostModel.calibrate`
    timed (the same chain of shapes) three ways, in µs: the calibrated
    WCET (``cm``, host clock from before the launch to after the sync);
    CUDA events around one launch (least of ``reps``; the start event
    runs before the wrapper's host work); and the card alone
    (`device_ms`, CUDA-graph replay), with its share of the WCET."""
    out = []
    for i, (x, t) in enumerate(zip(srv.inputs, srv.tasks)):
        rows = []
        for j, w in enumerate(t.weights):
            M, (K, N) = x.shape[0], w.shape
            window, _ = window_plan(M, N, K, block=srv.block, backend=srv.backend,
                                    window_tiles=srv.window_tiles)
            c = torch.zeros((M, N), dtype=torch.float32, device=x.device)
            run = functools.partial(matmul_window, x, w, c, 0, block=srv.block,
                                    window_tiles=window)
            run()
            event_s = []
            for _ in range(reps):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                event_s.append(start.elapsed_time(end) / 1e3)
            wcet = cm.window_cost(i, j)
            card = device_ms(run) / 1e3
            rows.append({"wcet_us": wcet * 1e6, "event_us": min(event_s) * 1e6,
                         "card_us": card * 1e6, "card_share": card / wcet})
            x = c
        out.append(rows)
    return out


# ---------------------------------------------------------------------------
# The traffic gateway: the port's DSE picks each scenario's design; the
# gateway admits tenants, sheds or switches mode under overload, and
# releases their traffic into PharosServer
# ---------------------------------------------------------------------------
#: scenarios whose designs the port's DSE picks on the card
GATEWAY_DESIGNS = ("steady_city", "rush_hour", "overload_2x", "av_stack",
                   "copilot_decode")
#: served at full width on a virtual clock: (scenario, horizon in periods
#: of its slowest tenant's contract)
GATEWAY_RUNS = (("rush_hour", 60.0), ("overload_2x", 60.0), ("av_stack", 40.0))
#: copilot_decode's horizon, in periods of its StableLM-1.6B decode
#: tenant's contract
COPILOT_PERIODS = 4.0
#: the gateway's window geometry: four-tile windows ("pallas"), so one
#: StableLM-1.6B decode job (5200 output tiles) is 1300 windows
GATEWAY_BACKEND = "pallas"
#: the wall-clock gateway run: rush_hour with its periods x100, 0.3 s
GATEWAY_WALL_SCALE, GATEWAY_WALL_S = 100.0, 0.3
#: the StableLM-1.6B decode chain's window shapes timed in phase 2, as
#: (K, N, layers of that shape): the largest K (the 24 MLP down
#: projections) and the largest N (the LM head)
STABLELM_WINDOWS = ((11264, 2048, 24), (2048, 100352, 1))


def gateway_bundle(built, *, device, max_dim=None, seed=0, period_scale=1.0,
                   backend=GATEWAY_BACKEND):
    """``(serve tasks, contracts, traffic, cost model)`` of a built
    scenario: its GEMM chains on ``device`` (weights from ``seed``) and
    the exec model's per-window WCETs in the window geometry
    ``backend``."""
    tasks, requests, arrivals = built.serve_bundle(
        period_scale=period_scale, seed=seed, max_dim=max_dim, device=device)
    cm = CostModel.from_exec_model(
        built.design, list(built.workloads), tasks, backend=backend,
        window_tiles=WINDOW_TILES, period_scale=period_scale)
    return tasks, requests, arrivals, cm


def serve_gateway(built, tasks, requests, arrivals, *, device, horizon,
                  cost_model=None, clock=None, inputs=None, on_output=None,
                  trace=None, on_server=None, backend=GATEWAY_BACKEND):
    """One `TrafficGateway` run of ``built``'s tenants in front of a
    `PharosServer` on ``device``, in the window geometry ``backend``: on
    a `VirtualClock` driven by ``cost_model``, or on ``clock`` (a
    `WallClock`). Tenants pass admission against the design's segment
    table; the one overload authority is the mixed-criticality
    `ModeController` where a tenant is HI, else reject-newest shedding
    (examples/serve_gateway.py).
    ``on_output(task_id, y)`` sees every finished job's chained output;
    ``on_server(server)`` is called before the run. Returns the
    `GatewayReport` and the server."""
    policy = built.scenario.policy
    clk = clock if clock is not None else VirtualClock()
    srv = PharosServer(
        tasks, built.design.n_stages, policy=policy, backend=backend,
        window_tiles=WINDOW_TILES, inputs=inputs, device=device,
        clock=clk.now, sleep=clk.sleep, cost_model=cost_model, trace=trace,
    )
    admission = AdmissionController(list(built.table.overhead),
                                    preemptive=policy == "edf")
    mixed = any(r.criticality == CRITICALITY_HI for r in requests)
    gateway = TrafficGateway(
        srv, admission, list(requests), list(arrivals),
        shedding=None if mixed else get_policy("reject_newest"),
        modes=ModeController(admission, list(requests)) if mixed else None,
        clock=clk, trace=trace,
    )
    if on_output is not None:
        capture_outputs(srv, on_output)
    if on_server is not None:
        on_server(srv)
    return gateway.run(horizon), srv


def chain64(task, x):
    """``task``'s chain over ``x`` in float64 where its weights lie
    (`torch.matmul`, a yardstick off the main path)."""
    y = x.to(task.weights[0].device, torch.float64)
    for w in task.weights:
        y = y @ w.double()
    return y


def chain_tf32(task, x):
    """``task``'s chain over ``x`` in fp32 with TF32 products allowed
    (one TF32 product per fp32 one; a yardstick off the main path)."""
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = x.to("cuda", torch.float32)
        for w in task.weights:
            y = y @ w
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed
    return y


class ChainCheck:
    """``on_output`` for `serve_gateway`: each finished job's chained
    output against its task's float64 chain, as max |error| over max
    |float64|; ``errors[i]`` lists task ``i``'s jobs in finishing order."""

    def __init__(self, want):
        self.want = want
        self.scale = [w.abs().max().item() for w in want]
        self.errors = [[] for _ in want]

    def __call__(self, i, y):
        check(bool(torch.isfinite(y).all()), "finite chained outputs")
        err = (y.double() - self.want[i]).abs().max().item() / self.scale[i]
        self.errors[i].append(err)


def gateway_run(built, horizon_periods, seed) -> dict:
    """One scenario at full width on a virtual clock: the card's report
    against the port's CPU run of the same bundle, launches against
    windows, every finished job's output against float64."""
    name = built.scenario.name
    tasks, requests, arrivals, cm = gateway_bundle(built, device="cuda", seed=seed)
    cpu_tasks = [dataclasses.replace(t, weights=tuple(w.cpu() for w in t.weights))
                 for t in tasks]
    gen = torch.Generator().manual_seed(seed + 1)
    inputs = [torch.randn((t.input_rows, t.weights[0].shape[0]), generator=gen)
              for t in tasks]
    chains = ChainCheck([chain64(t, x) for t, x in zip(tasks, inputs)])
    horizon = horizon_periods * max(r.period for r in requests)
    layers = sum(len(t.weights) for t in tasks)
    kw = dict(horizon=horizon, cost_model=cm, inputs=inputs)
    before = matmul_window_call.launches
    t0 = time.perf_counter()
    rep, _ = serve_gateway(built, tasks, requests, arrivals, device="cuda",
                           on_output=chains, **kw)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launched = matmul_window_call.launches - before
    t0 = time.perf_counter()
    rep_cpu, _ = serve_gateway(built, cpu_tasks, requests, arrivals,
                               device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    sr = rep.server_report
    check(dataclasses.asdict(rep) == dataclasses.asdict(rep_cpu),
          f"{name}: the card's gateway report equals the CPU run's")
    check(launched == sr.windows_executed + layers,
          f"{name}: {launched} launches vs {sr.windows_executed} windows + "
          f"{layers} warm-up")
    check(sr.jobs_completed > 0, f"{name}: jobs completed")
    for i, t in enumerate(tasks):
        done = len(sr.response_times[t.name])
        check(len(chains.errors[i]) == done,
              f"{name}/{t.name}: {len(chains.errors[i])} outputs checked, "
              f"{done} jobs completed")
    err = max(e for errs in chains.errors for e in errs)
    windows_per_job = [sum(w) for w in cm.layer_windows]
    print(f"[gateway] {name} ({built.scenario.policy}, "
          f"{'mode switch' if any(r.criticality == CRITICALITY_HI for r in requests) else 'reject_newest'}"
          f", horizon {horizon * 1e3:.3f} ms virtual): windows per job "
          f"{windows_per_job}, {sum(w.numel() for t in tasks for w in t.weights) * 4 / 1e9:.3f} GB fp32 | "
          f"released {rep.total_released()} shed {rep.total_shed()} completed "
          f"{sr.jobs_completed} windows {sr.windows_executed} preemptions "
          f"{sr.preemptions} misses {sum(sr.deadline_misses.values())} mode "
          f"switches {len(rep.mode_switches)} | launches {launched} | report == "
          f"cpu report | chained rel err {err:.3g} | host s: card {t_card:.3f} "
          f"cpu {t_cpu:.3f}")
    for i, t in enumerate(rep.tenants):
        errs = chains.errors[i]
        print(f"[gateway]   {t.name}: admitted {t.admitted} scheduled "
              f"{t.scheduled} released {t.released} degraded {t.degraded} shed "
              f"{t.shed} completed {len(errs)} (outputs checked {len(errs)}, "
              f"max rel err {max(errs, default=0.0):.3g}) misses "
              f"{sr.deadline_misses[t.name]}")
    return {"report": rep, "launches": launched, "err": err,
            "errors": chains.errors, "tasks": tasks, "inputs": inputs,
            "card_s": t_card, "cpu_s": t_cpu}


def gateway_wall(built) -> dict:
    """rush_hour on the wall clock, its periods x GATEWAY_WALL_SCALE, for
    GATEWAY_WALL_S under the profiler: printed findings, not checks (a
    wall-clock miss count depends on the host)."""
    tasks, requests, arrivals, _ = gateway_bundle(
        built, device="cuda", period_scale=GATEWAY_WALL_SCALE)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    before = matmul_window_call.launches
    stepping = [0.0]  # host seconds in server steps that ran a window

    def time_steps(srv):
        step = srv.step

        def timed():
            t0 = time.perf_counter()
            ran = step()
            if ran:
                stepping[0] += time.perf_counter() - t0
            return ran

        srv.step = timed

    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rep, _ = serve_gateway(built, tasks, requests, arrivals, device="cuda",
                               horizon=GATEWAY_WALL_S, clock=WallClock(),
                               on_server=time_steps)
        wall = time.perf_counter() - t0
    launched = matmul_window_call.launches - before
    sr = rep.server_report
    check(sr.jobs_completed > 0, "wall-clock gateway run completed jobs")
    check(launched == sr.windows_executed + sum(len(t.weights) for t in tasks),
          "wall-clock gateway: one launch per window plus the warm-up")
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    windows = sr.windows_executed
    busy = (f"card busy {busy_us / 1e3:.3f} ms ({busy_us / 1e4 / wall:.2f}%)"
            if busy_us > 0 else "card busy time not measured (profiler saw none)")
    print(f"[gateway] wall {built.scenario.name}, periods x{GATEWAY_WALL_SCALE:g}, "
          f"{wall * 1e3:.3f} ms wall under the profiler: {busy}, {windows} "
          f"windows ({windows / wall:.1f} per s); host time in the server "
          f"steps that ran windows {stepping[0] * 1e3:.3f} ms, "
          f"{stepping[0] / max(windows, 1) * 1e6:.1f} us per window (launch "
          f"and the sync after it included)")
    for t in rep.tenants:
        p = sr.response_percentiles(t.name)
        print(f"[gateway] wall   {t.name}: released {t.released} shed {t.shed} "
              f"completed {len(sr.response_times[t.name])} missed "
              f"{sr.deadline_misses[t.name]} response p99 {p['p99'] * 1e3:.3f} ms "
              f"(period {requests[rep.tenants.index(t)].period * 1e3:.3f} ms)")
    return {"launches": launched, "windows": windows, "wall_s": wall,
            "busy_us": busy_us, "step_s": stepping[0]}


def phase_gateway() -> dict:
    """The port's DSE picks the gateway scenarios' designs; rush_hour,
    overload_2x and av_stack, then copilot_decode's StableLM-1.6B decode
    tenant, are served at full width through the gateway; then a short
    wall-clock run of rush_hour. Returns the window launches and the
    builds."""
    from repro_torch.core.perfmodel import exec_model

    built = {}
    for name in GATEWAY_DESIGNS:
        # the exec model memoizes layer latencies for the process: clear
        # it so each printed search time is an uncached search
        exec_model._latency_cached.cache_clear()
        built[name], res = search_design(name)
        accs, splits, mu = design_summary(built[name].design)
        print(f"[gateway] design {name}: {len(accs)} stages, accelerators "
              f"(chips, block) {list(accs)}, splits {list(splits)}, max_util "
              f"{mu!r}; DSE beam search {res.stats.wall_time_s * 1e3:.1f} ms "
              f"({res.stats.create_acc_calls} candidates)")
    check(design_summary(built["steady_city"].design) == STEADY_CITY_REFERENCE_DESIGN,
          "steady_city: the port's DSE picks the reference's design")

    reset_counts()  # the gateway path starts here
    runs = {}
    for seed, (name, periods) in enumerate(GATEWAY_RUNS):
        runs[name] = gateway_run(built[name], periods, seed=200 + seed)
    check(runs["overload_2x"]["report"].total_shed() > 0, "overload_2x sheds")
    check(len(runs["av_stack"]["report"].mode_switches) >= 1,
          "av_stack switches mode")

    torch.cuda.reset_peak_memory_stats()
    copilot = built["copilot_decode"]
    lm = next(i for i, spec in enumerate(copilot.scenario.tenants)
              if spec.workload.startswith("config:stablelm_1_6b"))
    check(copilot.requests[lm].period == max(r.period for r in copilot.requests),
          "the decode tenant is copilot_decode's slowest")
    run = gateway_run(copilot, COPILOT_PERIODS, seed=300)
    runs["copilot_decode"] = run
    lm_name = copilot.requests[lm].name
    done = len(run["report"].server_report.response_times[lm_name])
    check(done >= 1, f"copilot_decode: {lm_name} finished a job")
    lm_err = max(run["errors"][lm])
    tf32 = chain_tf32(run["tasks"][lm], run["inputs"][lm])
    want = chain64(run["tasks"][lm], run["inputs"][lm])
    tf32_err = (tf32.double() - want).abs().max().item() / want.abs().max().item()
    check(lm_err <= CHAIN_REL_TOL < tf32_err,
          f"{lm_name}: chained rel err {lm_err:.3g} <= {CHAIN_REL_TOL} "
          f"< the 1xTF32 yardstick's {tf32_err:.3g}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[gateway] copilot_decode {lm_name}: {len(run['tasks'][lm].weights)} "
          f"layers, {done} jobs finished, chained rel err vs float64 {lm_err:.3g} "
          f"(bound {CHAIN_REL_TOL}); the same chain through 1xTF32 "
          f"products {tf32_err:.3g}; card peak memory {peak:.2f} GB")
    del run["tasks"], run["inputs"], tf32, want
    torch.cuda.empty_cache()

    wall = gateway_wall(built["rush_hour"])
    launched = counts()
    check(launched["preemptible_matmul_window"]
          == sum(r["launches"] for r in runs.values()) + wall["launches"],
          "gateway launches add up: every window through the kernel")
    check(launched["flash_attention"] == launched["rwkv6_scan"]
          == launched["mamba_scan"] == 0, "the gateway launches no LM kernel")
    return {"launches": launched["preemptible_matmul_window"],
            "lm_err": lm_err, "tf32_err": tf32_err, "peak_gb": peak,
            "built": built}


# ---------------------------------------------------------------------------
# The sharded gateway: the port's provision bridge over its DSE, K
# replicas of one pipeline on a shared virtual clock, a live tenant
# migration and the autoscaler, every shard's server on the card
# ---------------------------------------------------------------------------
#: provisioned and served over 2 shards (4 periodic tenants: PointNet,
#: MLP-Mixer, ResMLP, DeiT-T)
SHARDED_SCENARIO, SHARDED_SHARDS, SHARDED_PLACEMENT = "sharded_city", 2, "least_loaded"
#: horizon of the provisioned and the migration runs, in periods of the
#: slowest tenant's contract; the migration starts at this share of it
SHARDED_PERIODS, MIGRATE_AT = 40.0, 0.3
#: the autoscaler's population (2 copies of each tenant), fleet bounds
#: and plateau length in periods of the slowest tenant
AUTOSCALE_SCENARIO, AUTOSCALE_COPIES = "multi_tenant_rush", 2
AUTOSCALE_SHARDS, AUTOSCALE_PERIODS = (1, 4), 6.0
#: the scout ramp's width: the autoscaler plans from the contracts alone
#: (`Autoscaler._plan_epoch`), so where the peak fleet places each tenant
#: does not depend on the width or the device it serves on
SCOUT_MAX_DIM = 128


@contextlib.contextmanager
def built_fleets(on_fleet):
    """Call ``on_fleet(sharded)`` on every `ShardedGateway` constructed
    inside the block, in construction order, before it runs: the
    autoscaler builds one fleet per epoch and keeps none, so this is
    where its shards' servers can be reached."""
    init = ShardedGateway.__init__

    def hooked(self, *args, **kwargs):
        init(self, *args, **kwargs)
        on_fleet(self)

    ShardedGateway.__init__ = hooked
    try:
        yield
    finally:
        ShardedGateway.__init__ = init


class FleetCheck:
    """``on_fleet`` for `built_fleets`: every shard's server gets a
    `ChainCheck` of its own tasks and inputs (float64 chains where its
    weights lie) on its output hook. ``servers`` lists ``(fleet, shard,
    server, chains)`` in construction order."""

    def __init__(self, check_outputs: bool = True):
        self.check_outputs = check_outputs
        self.fleets = []
        self.servers = []

    def __call__(self, sharded):
        f = len(self.fleets)
        self.fleets.append(sharded)
        for k, gw in enumerate(sharded.gateways):
            if gw is None:
                continue
            srv, chains = gw.server, None
            if self.check_outputs:
                chains = ChainCheck([chain64(t, x) for t, x in zip(srv.tasks, srv.inputs)])
                capture_outputs(srv, chains)
            self.servers.append((f, k, srv, chains))

    def tally(self, reports) -> dict:
        """Windows, warm-up launches (one per layer of each server),
        preemptions and completed jobs over every shard of every fleet;
        ``reports[f]`` is fleet ``f``'s `ShardedReport`. With outputs
        checked, also the worst chained error, after checking that each
        server's outputs checked equal its completed jobs, task by
        task."""
        out = {"windows": 0, "warmup": 0, "preemptions": 0, "completed": 0,
               "outputs": 0, "err": 0.0}
        for f, k, srv, chains in self.servers:
            sr = reports[f].reports[k].server_report
            out["windows"] += sr.windows_executed
            out["warmup"] += sum(len(t.weights) for t in srv.tasks)
            out["preemptions"] += sr.preemptions
            out["completed"] += sr.jobs_completed
            if chains is None:
                continue
            for i, t in enumerate(srv.tasks):
                done = len(sr.response_times.get(t.name, []))
                check(len(chains.errors[i]) == done,
                      f"fleet {f} shard {k} {t.name}: {len(chains.errors[i])} "
                      f"outputs checked, {done} jobs completed")
                out["outputs"] += done
            out["err"] = max([out["err"]] + [e for errs in chains.errors for e in errs])
        return out


def fleet_run(make, device, check_outputs=True) -> dict:
    """``make(device, trace)`` builds and runs one sharded workload on
    ``device`` and returns ``(report, reports, extra)``: its report, each
    fleet's `ShardedReport` in construction order, and a dict of other
    results to compare. Returns those with the port's trace, the
    `FleetCheck`, the window-kernel launches and the host seconds."""
    trace, fc = TraceRecorder(), FleetCheck(check_outputs)
    before = matmul_window_call.launches
    t0 = time.perf_counter()
    with built_fleets(fc):
        report, reports, extra = make(device, trace)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(len(reports) == len(fc.fleets), "one report per fleet built")
    return {"report": report, "reports": reports, "extra": extra, "trace": trace,
            "fleets": fc,
            "launches": matmul_window_call.launches - before, "seconds": secs}


def provision_sharded():
    """The port's `provision` of sharded_city over 2 shards: its DSE runs
    the search `traffic.scenarios.build` runs, and every shard's
    admission controller must admit its contract."""
    plan = provision(SHARDED_SCENARIO, cfg=DSEConfig(**build_search()),
                     shards=SHARDED_SHARDS, placement=SHARDED_PLACEMENT)
    ctls = plan.admission_controllers()  # raises where a contract does not fit
    check(all(c.verify() for c in ctls) and
          sum(len(c.names()) for c in ctls) == len(plan.built.requests),
          f"{SHARDED_SCENARIO}: every shard admits its contract")
    return plan


def horizon_of(built, periods) -> float:
    return periods * max(r.period for r in built.requests)


def provisioned_run(plan, *, max_dim=None, periods=SHARDED_PERIODS):
    """``make`` for `fleet_run`: the provisioned fleet on the shared clock."""
    def make(device, trace):
        gw = plan.sharded_gateway(device=device, max_dim=max_dim, trace=trace)
        rep = gw.run(horizon_of(plan.built, periods))
        check(gw.verify(), "every shard's Eq. 3 verdict holds on re-analysis")
        return rep, [rep], {}
    return make


def migration_run(built, *, max_dim=None, periods=SHARDED_PERIODS):
    """``make`` for `fleet_run`: the elastic fleet (each shard built over
    every tenant) migrating the first tenant at MIGRATE_AT of the
    horizon; ``extra`` holds the controller's records and final
    assignment."""
    def make(device, trace):
        horizon = horizon_of(built, periods)
        gw = ShardedGateway.from_built(
            built, shards=SHARDED_SHARDS, placement=SHARDED_PLACEMENT, elastic=True,
            device=device, max_dim=max_dim, trace=trace)
        mc = MigrationController(
            [MigrationPlan(tenant=built.requests[0].name, at=MIGRATE_AT * horizon)],
            trace=trace)
        rep = gw.run(horizon, controller=mc)
        return rep, [rep], {"records": mc.records, "final": mc.final_assignment(),
                            "in_progress": mc.in_progress()}
    return make


def autoscale_phases(population, *, periods=AUTOSCALE_PERIODS):
    """The ramp of ``tests/test_migration.py``'s grow-and-shrink case: a
    quarter of the tenants, then all, then one tenant per shard of the
    peak fleet, which a scout run of the first two plateaus places (on
    the CPU at SCOUT_MAX_DIM)."""
    dur = horizon_of(population, periods)
    n = len(population.requests)
    few, full = tuple(range(max(1, n // 4))), tuple(range(n))
    lo, hi = AUTOSCALE_SHARDS
    scout = Autoscaler(population, min_shards=lo, max_shards=hi, device="cpu",
                       max_dim=SCOUT_MAX_DIM).run_ramp(
        [RampPhase(duration=dur, active=few), RampPhase(duration=dur, active=full)])
    peak = scout.epochs[1].assignment
    down = tuple(sorted(min(i for i, s in peak.items() if s == k)
                        for k in set(peak.values())))
    return [RampPhase(duration=dur, active=few), RampPhase(duration=dur, active=full),
            RampPhase(duration=dur, active=down)]


def autoscale_run(population, phases, *, max_dim=None):
    """``make`` for `fleet_run`: the autoscaler's ramp, one fleet per
    epoch."""
    def make(device, trace):
        lo, hi = AUTOSCALE_SHARDS
        rep = Autoscaler(population, min_shards=lo, max_shards=hi, device=device,
                         max_dim=max_dim, trace=trace).run_ramp(phases)
        return rep, [e.report for e in rep.epochs], {}
    return make


def sharded_case(label, make, *, device="cuda") -> dict:
    """One sharded workload on ``device`` against the port's CPU run of
    the same bundle: equal reports, identical traces over the whole
    vocabulary and equal metrics from them; window-kernel launches
    equal to the windows plus each server's warm-up; every completed
    job's chained output within CHAIN_REL_TOL of float64, one output
    checked per completed job of every tenant."""
    card = fleet_run(make, device)
    cpu = fleet_run(make, "cpu", check_outputs=False)
    check(dataclasses.asdict(card["report"]) == dataclasses.asdict(cpu["report"])
          and card["extra"] == cpu["extra"],
          f"{label}: the card's report equals the CPU run's")
    tr, cpu_tr = card["trace"], cpu["trace"]
    d = trace_diff(cpu_tr, tr, kinds=EVENT_KINDS, names=("cpu", device))
    check(d.identical and d.compared == len(tr.events) == len(cpu_tr.events) > 0,
          f"{label}: the card's trace equals the CPU run's ({d.summary()})")
    check(MetricsRegistry.from_trace(tr).snapshot()
          == MetricsRegistry.from_trace(cpu_tr).snapshot(),
          f"{label}: the card's trace metrics equal the CPU run's")
    tally = card["fleets"].tally(card["reports"])
    check(card["launches"] == tally["windows"] + tally["warmup"],
          f"{label}: {card['launches']} launches vs {tally['windows']} windows + "
          f"{tally['warmup']} warm-up")
    check(tally["completed"] > 0 and tally["outputs"] == tally["completed"],
          f"{label}: {tally['outputs']} outputs checked, {tally['completed']} "
          "jobs completed")
    check(tally["err"] <= CHAIN_REL_TOL,
          f"{label}: chained rel err {tally['err']:.3g} > {CHAIN_REL_TOL}")
    misses = {}
    for rep in card["reports"]:
        for gr in rep.reports:
            if gr is not None:
                for name, n in gr.server_report.deadline_misses.items():
                    misses[name] = misses.get(name, 0) + n
    print(f"[sharded] {label}: host s card {card['seconds']:.3f} cpu "
          f"{cpu['seconds']:.3f} | launches {card['launches']} windows "
          f"{tally['windows']} warm-up {tally['warmup']} preemptions "
          f"{tally['preemptions']} | report == cpu report, trace == cpu trace "
          f"({d.compared} events), metrics == cpu metrics | outputs checked "
          f"{tally['outputs']} of {tally['completed']} completed, chained rel err "
          f"{tally['err']:.3g}")
    print(f"[sharded]   events by kind {dict(sorted(tr.counts().items()))}")
    print(f"[sharded]   misses by tenant {dict(sorted(misses.items()))}")
    return {**card, "cpu_seconds": cpu["seconds"], "tally": tally, "misses": misses}


def phase_sharded() -> int:
    """sharded_city provisioned by the port's DSE over 2 shards; the same
    tenants on an elastic fleet with one live migration; the autoscaler
    over two copies of multi_tenant_rush growing and shrinking the
    fleet. Each at full width on the card against the port's CPU run.
    Returns the window launches."""
    reset_counts()  # the sharded path starts here
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9  # by earlier phases
    t0 = time.perf_counter()
    plan = provision_sharded()
    t_plan = time.perf_counter() - t0
    built = plan.built
    gb = sum(w.numel() for t in built.serve_bundle(period_scale=1.0, device="meta")[0]
             for w in t.weights) * 4 / 1e9
    print(f"[sharded] {SHARDED_SCENARIO}: provision over {plan.n_shards} shards "
          f"({plan.placement}) in {t_plan:.3f} s, design max_util "
          f"{plan.design.max_util!r}, assignment {plan.plan.assignment}, shard "
          f"utilizations {plan.shard_utilizations()}; {len(built.requests)} tenants, "
          f"{gb:.3f} GB fp32 at full width")
    runs = {"provisioned": sharded_case("provisioned", provisioned_run(plan))}

    run = sharded_case("migration", migration_run(built))
    extra, kinds = run["extra"], run["trace"].counts()
    (rec,) = extra["records"]
    check(rec.committed and rec.target not in (None, rec.donor),
          f"migration: {rec.tenant} committed to another shard ({rec.reason})")
    check(kinds.get("migrate_start") == kinds.get("migrate_commit") == 1,
          "migration: one migrate_start and one migrate_commit event")
    print(f"[sharded]   migration of {rec.tenant}: shard {rec.donor} -> "
          f"{rec.target}, started {rec.started_at * 1e3:.3f} ms, committed "
          f"{rec.committed_at * 1e3:.3f} ms, {rec.held} releases held; final "
          f"assignment {extra['final']}")
    runs["migration"] = run

    population = replicate(search_design(AUTOSCALE_SCENARIO)[0], AUTOSCALE_COPIES)
    phases = autoscale_phases(population)
    run = sharded_case("autoscale", autoscale_run(population, phases))
    rep, kinds = run["report"], run["trace"].counts()
    shards = rep.shard_counts()
    check(shards[1] > shards[0] and shards[2] < shards[1],
          f"autoscale: the fleet grows at the peak and shrinks after ({shards})")
    check(rep.epochs[1].grew > 0 and rep.epochs[2].shrank > 0 and rep.epochs[2].rehomed,
          "autoscale: grow and shrink epochs, re-homing on the shrink")
    check(kinds.get("migrate_start", 0) >= len(rep.epochs[2].rehomed) > 0
          and kinds.get("migrate_commit") == kinds.get("migrate_start"),
          "autoscale: a migrate_start and migrate_commit per re-homed tenant")
    print(f"[sharded]   autoscale {len(population.requests)} tenants "
          f"({AUTOSCALE_COPIES} x {AUTOSCALE_SCENARIO}): active per epoch "
          f"{[len(p.active) for p in phases]}, shards per epoch {shards}, grew "
          f"{[e.grew for e in rep.epochs]}, shrank {[e.shrank for e in rep.epochs]}, "
          f"re-homed {list(rep.epochs[2].rehomed)}, admit rate {rep.admit_rate()!r}")
    runs["autoscale"] = run

    peak = torch.cuda.max_memory_allocated() / 1e9
    launched = counts()
    check(launched["preemptible_matmul_window"]
          == sum(r["launches"] for r in runs.values()),
          "sharded launches add up: every window through the kernel")
    check(launched["flash_attention"] == launched["rwkv6_scan"]
          == launched["mamba_scan"] == 0, "the sharded path launches no LM kernel")
    print(f"[sharded] phase: {time.perf_counter() - t0:.3f} s, window launches "
          f"{launched['preemptible_matmul_window']}, card peak memory {peak:.3f} GB "
          f"({held:.3f} GB of it held by earlier phases when it began)")
    return launched["preemptible_matmul_window"]


# ---------------------------------------------------------------------------
# The conformance harness: analysis >= DES >= runtime, every runtime leg's
# windows through the kernel on the card
# ---------------------------------------------------------------------------
#: the other legs at the reference's own settings (tests/test_conformance.py,
#: tests/test_modes.py, benchmarks/conformance_bench.py's quick run) and
#: the harness's default surrogate width: (leg, scenario, policy, horizon
#: in periods, keyword arguments)
CONFORMANCE_LEGS = (
    (run_sharded_case, "sharded_city", "edf", 24.0,
     dict(shards=2, placement="least_loaded")),
    (run_shedding_case, "overload_2x", "edf", 24.0,
     dict(shed_policy="reject_newest")),
    (run_mode_switch_case, "av_stack", "edf", 24.0, dict(action="degrade")),
    (run_migration_case, "sharded_city", "edf", 20.0, dict(shards=2)),
    (run_dse_case, "steady_city", "edf", 16.0, dict(shards=2, check_top=2)),
)
#: the sweep's scenarios whose cases are also run on the CPU and compared
#: field for field (copilot_decode's 8.09 GB chain is not)
CONFORMANCE_CPU = ("steady_city", "rush_hour", "sensor_fusion")
#: the wall-clock leg at the reference's own test settings, full width,
#: and its host-noise retries (tests/test_conformance.py): one, and two in
#: calibrated-admission mode
WALL_CFG = dict(max_dim=None, wall_horizon_periods=8.0, wall_reps=2,
                wall_margin=8.0)
WALL_CASES = (("steady_city", False, 1), ("rush_hour", False, 1),
              ("steady_city", True, 2))


class LaunchTally:
    """Inside the block, every `PharosServer` built, the layers each
    warm-up runs (one window each) and each calibration's probes (one
    untimed and ``reps`` timed windows per layer): their card windows
    are what the window kernel must have launched."""

    def __init__(self):
        self.servers, self.warmup, self.probes = [], 0, 0

    def card_windows(self) -> int:
        return sum(s.report.windows_executed for s in self.servers
                   if s.device.type == "cuda") + self.warmup + self.probes

    @contextlib.contextmanager
    def counting(self):
        init, warmup = PharosServer.__init__, PharosServer.warmup
        calibrate = CostModel.__dict__["calibrate"]

        def hooked_init(srv, *args, **kwargs):
            init(srv, *args, **kwargs)
            self.servers.append(srv)

        def hooked_warmup(srv):
            warmup(srv)
            if srv.device.type == "cuda":
                self.warmup += sum(len(t.weights) for t in srv.tasks)

        def hooked_calibrate(cls, srv, *, reps=3, **kwargs):
            if srv.device.type == "cuda":
                self.probes += (reps + 1) * sum(len(t.weights) for t in srv.tasks)
            return calibrate.__func__(cls, srv, reps=reps, **kwargs)

        PharosServer.__init__, PharosServer.warmup = hooked_init, hooked_warmup
        CostModel.calibrate = classmethod(hooked_calibrate)
        try:
            yield self
        finally:
            PharosServer.__init__, PharosServer.warmup = init, warmup
            CostModel.calibrate = calibrate


def model_fields(result) -> dict:
    """``dataclasses.asdict(result)`` with every nested ``wall_seconds``
    (the host time a case took, not a model number) set to zero."""
    def strip(x):
        if isinstance(x, dict):
            return {k: 0.0 if k == "wall_seconds" else strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x
    return strip(dataclasses.asdict(result))


def conformance_sweep(builds) -> dict:
    """`run_conformance` over the four contract-honouring scenarios under
    FIFO and EDF at full width on the card, against the port's CPU run of
    the same cases for CONFORMANCE_CPU."""
    cfg = ConformanceConfig(max_dim=None)
    tally = LaunchTally()
    before = matmul_window_call.launches
    t0 = time.perf_counter()
    with tally.counting():
        report = run_conformance(DEFAULT_SCENARIOS, POLICIES, device="cuda",
                                 cfg=cfg, prebuilt=builds)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    launched = matmul_window_call.launches - before
    windows = tally.card_windows()
    del tally  # its servers hold the sweep's weights on the card
    torch.cuda.empty_cache()
    print("[conformance] sweep, full width on the card:")
    for line in report.summary().splitlines():
        print(f"[conformance]   {line}")
    check(report.ok, f"sweep: {[str(v) for v in report.violations]}")
    check(len(report.cases) == len(DEFAULT_SCENARIOS) * len(POLICIES),
          "sweep: every scenario under every policy")
    check(launched == windows > 0,
          f"sweep: {launched} launches vs {windows} windows executed")
    t0 = time.perf_counter()
    for case in report.cases:
        if case.scenario in CONFORMANCE_CPU:
            cpu = run_case(builds[case.scenario], case.policy, device="cpu", cfg=cfg)
            check(model_fields(case) == model_fields(cpu),
                  f"{case.scenario}/{case.policy}: the card's case equals the CPU run's")
    t_cpu = time.perf_counter() - t0
    print(f"[conformance] sweep: {len(report.cases)} cases ok, launches {launched} "
          f"= windows executed (run_case serves without warm-up); "
          f"{len(CONFORMANCE_CPU) * len(POLICIES)} cases == their CPU run | host s: "
          f"card {t_card:.3f}, cpu {t_cpu:.3f}")
    return {"cases": [
        {"scenario": c.scenario, "policy": c.policy, "ok": c.ok,
         "analysis_schedulable": c.analysis_schedulable,
         "des_schedulable": c.des_schedulable, "server_bounded": c.server_bounded,
         "tasks": [dataclasses.asdict(t) for t in c.tasks],
         "card_s": c.wall_seconds} for c in report.cases],
        "launches": launched, "card_s": t_card, "cpu_s": t_cpu}


def conformance_legs(builds) -> dict:
    """The sharded, shedding, mode-switch, migration and DSE legs on the
    card at CONFORMANCE_LEGS' settings; each must be ok."""
    out = {}
    for leg, name, policy, periods, kwargs in CONFORMANCE_LEGS:
        cfg = ConformanceConfig(horizon_periods=periods)
        if leg is run_dse_case:
            subject = name  # the leg runs its own DSE
        else:
            if name not in builds:
                builds[name] = search_design(name)[0]
            subject = builds[name]
        tally = LaunchTally()
        before = matmul_window_call.launches
        t0 = time.perf_counter()
        with tally.counting():
            res = leg(subject, policy, device="cuda", cfg=cfg, **kwargs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = matmul_window_call.launches - before
        check(res.ok, f"{leg.__name__} {name}: {[str(v) for v in res.violations]}")
        check(launched == tally.card_windows() > 0,
              f"{leg.__name__}: {launched} launches vs {tally.card_windows()} "
              "windows + warm-up")
        print(f"[conformance] {leg.__name__} {name}/{policy} {kwargs} horizon "
              f"{periods:g} periods, max_dim {cfg.max_dim}: ok | servers "
              f"{len(tally.servers)}, launches {launched} (warm-up "
              f"{tally.warmup}) | host s {secs:.3f}")
        out[leg.__name__] = {"scenario": name, "ok": res.ok, "launches": launched,
                             "seconds": secs}
    return out


def wall_attempt(built, calibrated_admission) -> dict:
    """One `run_wallclock_case` of ``built`` under EDF at WALL_CFG on the
    card, under the profiler: the case, the card's busy share of the
    leg's wall time (calibration, builds and the run), and the launches
    against the tally."""
    cfg = ConformanceConfig(calibrated_admission=calibrated_admission, **WALL_CFG)
    tally = LaunchTally()
    before = matmul_window_call.launches
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof, tally.counting():
        t0 = time.perf_counter()
        case = run_wallclock_case(built, "edf", device="cuda", cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = matmul_window_call.launches - before
    check(launched == tally.card_windows(),
          f"wall {built.scenario.name}: {launched} launches vs "
          f"{tally.card_windows()} windows + warm-up + calibration probes")
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return {"case": case, "wall_s": wall, "busy_us": busy_us, "launches": launched,
            "probes": tally.probes}


def conformance_wall(builds) -> list:
    """`run_wallclock_case` on steady_city and rush_hour, then steady_city
    in calibrated-admission mode, each within its WALL_CASES retries."""
    out = []
    for name, calibrated, retries in WALL_CASES:
        attempts = [wall_attempt(builds[name], calibrated)]
        while not attempts[-1]["case"].ok and len(attempts) <= retries:
            attempts.append(wall_attempt(builds[name], calibrated))
        for n, a in enumerate(attempts):
            case = a["case"]
            busy = (f"card busy {a['busy_us'] / 1e3:.3f} ms of {a['wall_s'] * 1e3:.3f} "
                    f"ms ({a['busy_us'] / 1e4 / a['wall_s']:.2f}%)" if a["busy_us"] > 0
                    else "card busy time not measured (profiler saw none)")
            print(f"[conformance] wall {name} edf, admission {case.admission_mode}, "
                  f"attempt {n + 1}: ok {case.ok}, period_scale "
                  f"{case.period_scale!r}, horizon {case.horizon_s * 1e3:.3f} ms, "
                  f"margin {case.margin:g} | {busy}; launches {a['launches']} "
                  f"({a['probes']} calibration probes)")
            for t in case.tasks:
                print(f"[conformance]   {t.task}: median {t.measured_median * 1e3:.4f} "
                      f"ms, max {t.measured_max * 1e3:.4f} ms, jobs {t.jobs}, DES "
                      f"{t.predicted_des_max * 1e3:.4f} ms, bound "
                      f"{t.predicted_bound * 1e3:.4f} ms, median/bound "
                      f"{t.measured_median / t.predicted_bound:.4f}, in flight "
                      f"{t.in_flight}")
            for v in case.violations:
                print(f"[conformance]   violation: {v}")
        case = attempts[-1]["case"]
        check(case.ok, f"wall {name} ({case.admission_mode}) after {len(attempts)} "
              f"attempt(s): {[str(v) for v in case.violations]}")
        out.append({
            "scenario": name, "admission_mode": case.admission_mode,
            "attempts": len(attempts), "ok": case.ok,
            "launches": sum(a["launches"] for a in attempts),
            "period_scale": case.period_scale, "horizon_s": case.horizon_s,
            "margin": case.margin,
            "busy_share": attempts[-1]["busy_us"] / 1e6 / attempts[-1]["wall_s"],
            "tasks": [dataclasses.asdict(t) for t in case.tasks]})
    return out


def phase_conformance(builds) -> dict:
    """The conformance harness on the card: the full-width sweep, the
    other legs, the wall-clock leg. ``builds`` maps scenario names to the
    port's builds (the gateway phase's); it gains the ones built here.
    Returns the phase's results and its window launches."""
    reset_counts()  # the conformance path starts here
    t0 = time.perf_counter()
    for name in DEFAULT_SCENARIOS:
        if name not in builds:
            builds[name] = search_design(name)[0]
    sweep = conformance_sweep(builds)
    legs = conformance_legs(builds)
    wall = conformance_wall(builds)
    launched = counts()
    check(launched["preemptible_matmul_window"] == sweep["launches"]
          + sum(r["launches"] for r in legs.values())
          + sum(w["launches"] for w in wall),
          "conformance launches add up: every window through the kernel")
    check(launched["flash_attention"] == launched["rwkv6_scan"]
          == launched["mamba_scan"] == 0, "the conformance path launches no LM kernel")
    secs = time.perf_counter() - t0
    print(f"[conformance] phase: {secs:.3f} s, window launches "
          f"{launched['preemptible_matmul_window']}")
    return {"sweep": sweep, "legs": legs, "wall": wall, "seconds": secs,
            "launches": launched["preemptible_matmul_window"]}


# ---------------------------------------------------------------------------
# LM serving path: flash attention, WKV-6, the selective scan,
# Mistral-NeMo-12B, RWKV-6-7B, Jamba-v0.1-52B
# ---------------------------------------------------------------------------
#: served one after the other: (config, layers served (None = all),
#: whether its int8-KV decode step is held against the bf16 one). The
#: stub frontends (MusicGen-medium, InternVL2-76B) take embeddings drawn
#: from the seed in place of tokens, at every prefill and decode step
LM_MODELS = (("mistral_nemo_12b", None, False), ("rwkv6_7b", None, False),
             ("jamba_v0_1_52b", 16, True), ("musicgen_medium", None, False),
             ("internvl2_76b", 8, False))
LM_BATCH, LM_PROMPT, LM_NEW_TOKENS = 2, 2048, 16
LM_CACHE_LEN = LM_PROMPT + LM_NEW_TOKENS
#: card against the port's own CPU run: a 2-layer model at full width
LM_CPU_LAYERS, LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_DECODE = 2, 1, 256, 2
#: flash kernel vs its plain version: element by element, within
#: FLASH_TOL (flash_attention/ref.py: one bf16 ulp of each value, plus a
#: floor of 1e-3 of the output's rms for values that cancel to near 0)
#: WKV-6 kernel (exact step-by-step recurrence) vs the plain chunked form,
#: whose k / prod(w) rescale loses a few digits: the reference's own
#: tolerance between its chunked kernel and its stepwise oracle
WKV_MAX_REL_ERR = 1e-4
#: decode at step S against a prefill over S+1 tokens, bf16 at full depth:
#: the reference's own teacher-forcing bounds (tests/test_models.py,
#: test_prefill_decode_matches_forward): relative L2 < 0.05, top-1 on at
#: least half the rows. The decode path rounds attention probabilities
#: to bf16 where the flash kernel keeps them fp32, and RWKV's token-shift
#: states pass through the cache in bf16.
CONSIST_REL_L2, CONSIST_TOP1 = 0.05, 0.5
#: card against CPU (same bf16 weights and tokens, 2 layers): bf16
#: products round at other places in cuBLAS and the CPU's kernels, as in
#: tests/test_torch_lm.py's bf16 cases (relative L2 3e-2)
CARD_CPU_REL_L2 = 3e-2
#: selective-scan kernel (exact step-by-step recurrence) vs the plain
#: chunked scan: the reference's own tolerance between its kernel and
#: its oracle
SCAN_MAX_REL_ERR = 1e-4
#: int8-KV decode step vs the bf16 one from the same prefill: the
#: reference's bounds (tests/test_models.py,
#: test_int8_kv_decode_close_to_bf16): relative L2 < 0.05.
KVQ_REL_L2 = 0.05


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    matmul_window_call.launches = 0
    flash_attention_call.launches = 0
    flash_attention_backward_call.launches = 0
    rwkv6_scan_call.launches = 0
    rwkv6_scan_backward_call.launches = 0
    mamba_scan_call.launches = 0
    mamba_scan_backward_call.launches = 0


def counts() -> dict:
    return {
        "preemptible_matmul_window": matmul_window_call.launches,
        "flash_attention": flash_attention_call.launches,
        "rwkv6_scan": rwkv6_scan_call.launches,
        "mamba_scan": mamba_scan_call.launches,
        "rwkv6_scan_backward": rwkv6_scan_backward_call.launches,
        "mamba_scan_backward": mamba_scan_backward_call.launches,
    }


def flash_bound(B, S, H, Hkv, hd, es, products=1.0):
    """Least time (ms) for causal attention, and what bounds it: q, o and
    k, v read or written once over memory bandwidth, against 4 * hd flops
    per (query, key <= query) pair at the bf16 tensor-core peak. With
    ``products`` = FLASH_SPLIT_PRODUCTS it is the bf16 kernel's own floor
    (P V twice, for P_hi and P_lo), not the function's bound."""
    nbytes = 2 * B * S * (H + Hkv) * hd * es
    flops = products * attention_flops(B, S, H, hd)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def wkv_bytes(B, S, H, hd):
    """Bytes WKV-6 must move: r, k, v, w read and y written once, plus u
    and S_final."""
    return 4 * (5 * B * S * H * hd + H * hd + B * H * hd * hd)


def wkv_bound(B, S, H, hd):
    """Least time (ms) for WKV-6, and what bounds it: `wkv_bytes` over
    memory bandwidth, against the fp32 flops the function needs at the
    fp32 FMA peak. Per step and head: the state update w * S + k v^T is 3
    flops per state element and r^T S is 2; the bonus r^T diag(u) k v^T
    is (sum_i r_i u_i k_i) v, 3 flops per row to reduce and 2 per column
    to add."""
    flops = wkv_flops(B, S, H, hd)
    t_bytes = wkv_bytes(B, S, H, hd) / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


#: SM clock assumed for the SFU bound: the H100 SXM's highest boost clock
SM_CLOCK_HZ = 1.98e9
#: exponentials per clock per SM (the special function units)
SFU_PER_CLOCK_SM = 16
N_SMS = 132


def scan_bytes(B, S, di, ns):
    """Bytes the selective scan must move: dt, x read and y written once,
    plus B, C, A, h0 and h_final."""
    return 4 * (3 * B * S * di + 2 * B * S * ns + di * ns + 2 * B * di * ns)


def scan_bound(B, S, di, ns):
    """Least time (ms) for the selective scan, and what bounds it:
    `scan_bytes` over memory bandwidth, against the larger of its
    B*S*di*ns exponentials at the SFU rate (16 per clock per SM at
    SM_CLOCK_HZ) and its fp32 flops at the FMA peak (per state element
    and step: dt*A, a*h + (dt*x)*B as a multiply and an FMA, y += h*C;
    6 flops)."""
    elems = float(B * S * di * ns)
    t_bytes = scan_bytes(B, S, di, ns) / PEAK_BYTES_S * 1e3
    t_exp = elems / (SFU_PER_CLOCK_SM * N_SMS * SM_CLOCK_HZ) * 1e3
    t_fma = scan_flops(B, S, di, ns) / PEAK_FLOPS[torch.float32] * 1e3
    t_ops = max(t_exp, t_fma)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_inputs(B, S, di, ns, seed, h0, a="init"):
    """As Jamba's mixer feeds the scan: dt = softplus(normal - 4.6) (the
    init's dt_bias), B, C, x normal; h0 zero, or normal when ``h0``. A is
    the init's -(1..ns) on every row (``a="init"``, from A_log), or drawn
    per element as trained weights would be, -exp(normal(0.5, 1.5)), so
    that no two rows share a decay (``"random"``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=gen, device="cuda") - 4.6)
    Bm = torch.randn((B, S, ns), generator=gen, device="cuda")
    Cm = torch.randn((B, S, ns), generator=gen, device="cuda")
    x = torch.randn((B, S, di), generator=gen, device="cuda")
    if a == "init":
        A = -torch.arange(1, ns + 1, dtype=torch.float32, device="cuda").expand(di, ns)
    else:
        A = -torch.exp(0.5 + 1.5 * torch.randn((di, ns), generator=gen, device="cuda"))
    h = (torch.randn((B, di, ns), generator=gen, device="cuda") if h0
         else torch.zeros((B, di, ns), device="cuda"))
    return dt, Bm, Cm, x, A.contiguous(), h


def scan_case(B, S, di, ns, chunk, seed, h0=False, a="init"):
    ops = scan_inputs(B, S, di, ns, seed, h0, a)
    y, h = mamba_scan_call(*ops, chunk=chunk)
    y_want, h_want = mamba_scan_plain(*ops, chunk=chunk)
    torch.cuda.synchronize()
    diff = max((y - y_want).abs().max().item(), (h - h_want).abs().max().item())
    rel = max(
        (y - y_want).abs().max().item() / y_want.abs().max().item(),
        (h - h_want).abs().max().item() / h_want.abs().max().item(),
    )
    check(rel <= SCAN_MAX_REL_ERR,
          f"scan kernel vs plain at B={B} S={S} di={di} h0={h0} A={a}: "
          f"rel err {rel:.3g}")
    ms = device_ms(lambda: mamba_scan_call(*ops, chunk=chunk), reps=10)
    plain_ms = device_ms(lambda: mamba_scan_plain(*ops, chunk=chunk), reps=3)
    bound_ms, bound_by = scan_bound(B, S, di, ns)
    return {
        "B": B, "S": S, "di": di, "ns": ns, "h0": h0, "A": a, "dtype": "float32",
        "max_abs_err": diff, "max_rel_err": rel, "ms": ms,
        "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes_per_s": scan_bytes(B, S, di, ns) / (ms * 1e-3),
        "bound_share": bound_ms / ms,
    }


def flash_case(B, S, H, Hkv, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
    got = flash_attention_call(q, k, v)
    want = attention_plain(q, k, v)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    ratio = tol_ratio(got, want)
    check(ratio <= 1.0,
          f"flash kernel vs plain at B={B} S={S} H={H}/{Hkv} hd={hd}: "
          f"error {ratio:.3g} x the limit (rtol, floor) {FLASH_TOL[dtype]}")
    ms = device_ms(lambda: flash_attention_call(q, k, v), reps=10)
    plain_ms = device_ms(lambda: attention_plain(q, k, v), reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, heads, S, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), reps=10
    )
    bound_ms, bound_by = flash_bound(B, S, H, Hkv, hd, q.element_size())
    split_ms, _ = flash_bound(B, S, H, Hkv, hd, q.element_size(),
                              FLASH_SPLIT_PRODUCTS)
    return {
        "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": diff, "tol_ratio": ratio, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "split_floor_ms": split_ms,
    }


def wkv_inputs(B, S, H, hd, seed):
    """r, k, v normal (k x 0.3), decays from logits clamped to the
    model's range, u normal x 0.1 — as the model feeds the scan."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    k = torch.randn((B, S, H, hd), generator=gen, device="cuda") * 0.3
    v = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    logit = torch.randn((B, S, H, hd), generator=gen, device="cuda").clamp(-8, -1)
    w = torch.exp(-torch.exp(logit))
    u = torch.randn((H, hd), generator=gen, device="cuda") * 0.1
    return r, k, v, w, u


def wkv_case(B, S, H, hd, seed):
    r, k, v, w, u = wkv_inputs(B, S, H, hd, seed)
    y, s_fin = rwkv6_scan_call(r, k, v, w, u)
    y_want, s_want = rwkv6_scan_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    diff = max((y - y_want).abs().max().item(), (s_fin - s_want).abs().max().item())
    rel = max(
        (y - y_want).abs().max().item() / y_want.abs().max().item(),
        (s_fin - s_want).abs().max().item() / s_want.abs().max().item(),
    )
    check(rel <= WKV_MAX_REL_ERR,
          f"WKV-6 kernel vs plain at B={B} S={S} H={H}: rel err {rel:.3g}")
    ms = device_ms(lambda: rwkv6_scan_call(r, k, v, w, u), reps=10)
    plain_ms = device_ms(lambda: rwkv6_scan_plain(r, k, v, w, u), reps=3)
    bound_ms, bound_by = wkv_bound(B, S, H, hd)
    return {
        "B": B, "S": S, "H": H, "hd": hd, "dtype": "float32",
        "max_abs_err": diff, "max_rel_err": rel, "ms": ms,
        "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes_per_s": wkv_bytes(B, S, H, hd) / (ms * 1e-3),
        "bound_share": bound_ms / ms,
    }


def phase_lm_kernels() -> tuple[dict, dict, dict]:
    """The LM kernels against their plain versions at the path's shapes;
    returns the rows the ``kernels`` line reports (the main shapes)."""
    nemo, rwkv = load_config("mistral_nemo_12b"), load_config("rwkv6_7b")
    H, Hkv, hd = nemo.n_heads, nemo.n_kv_heads, nemo.head_dim
    print("[lmkern] flash B S H/Hkv hd dtype | ms plain_ms sdpa_ms bound_ms "
          "bound_by split_floor_ms | max_abs_err err/limit  (card time, "
          "CUDA-graph replay; split_floor_ms: the bound with P V run twice, "
          f"{FLASH_SPLIT_PRODUCTS:g}x the products, for P_hi + P_lo; limit per "
          "element rtol|want| + floor rms(want), bf16 (rtol, floor) "
          f"{FLASH_TOL[torch.bfloat16]})")
    flash_rows = []
    for seed, (S, h, hkv, d) in enumerate(
        ((LM_PROMPT, H, Hkv, hd), (1000, H, Hkv, hd), (LM_PROMPT, H, Hkv, 64))
    ):
        row = flash_case(LM_BATCH, S, h, hkv, d, torch.bfloat16, seed)
        flash_rows.append(row)
        print(f"[lmkern] flash {LM_BATCH} {S} {h}/{hkv} {d} bf16 | "
              f"{row['ms']:.5f} {row['plain_ms']:.5f} {row['library_ms']:.5f} "
              f"{row['bound_ms']:.5f} {row['bound_by']} "
              f"{row['split_floor_ms']:.5f} | "
              f"{row['max_abs_err']:.3g} {row['tol_ratio']:.3g}")
    Hr, hdr = rwkv.n_rwkv_heads, rwkv.rwkv_head_size
    print("[lmkern] wkv6 B S H hd | ms plain_ms bound_ms bound_by TB/s "
          "bound/ms | max_rel_err  (TB/s: the bytes the function must move "
          "over the card time)")
    wkv_rows = []
    for seed, (B, S) in enumerate(((LM_BATCH, LM_PROMPT), (1, 1000))):
        row = wkv_case(B, S, Hr, hdr, 10 + seed)
        wkv_rows.append(row)
        print(f"[lmkern] wkv6 {B} {S} {Hr} {hdr} | {row['ms']:.5f} "
              f"{row['plain_ms']:.5f} {row['bound_ms']:.5f} {row['bound_by']} "
              f"{row['bytes_per_s'] / 1e12:.3f} {row['bound_share']:.3f} | "
              f"{row['max_rel_err']:.3g}")
    jamba = load_config("jamba_v0_1_52b")
    di, ns, chunk = jamba.d_inner, jamba.mamba_d_state, jamba.mamba_chunk
    print(f"[lmkern] scan B S di ns h0 A | ms plain_ms bound_ms bound_by TB/s "
          f"bound/ms | max_rel_err  (plain: chunk {chunk}; bound: SFU at "
          f"{SM_CLOCK_HZ / 1e9:g} GHz, memory at {PEAK_BYTES_S / 1e12:g} TB/s; "
          "TB/s: the bytes the function must move over the card time; A: the "
          "init's -(1..16) per row, or drawn per element)")
    scan_rows = []
    for seed, (S, h0, a) in enumerate(((LM_PROMPT, False, "init"),
                                       (1000, False, "init"),
                                       (LM_PROMPT, True, "init"),
                                       (LM_PROMPT, True, "random"))):
        row = scan_case(LM_BATCH, S, di, ns, chunk, 20 + seed, h0, a)
        scan_rows.append(row)
        print(f"[lmkern] scan {LM_BATCH} {S} {di} {ns} {h0} {a} | {row['ms']:.5f} "
              f"{row['plain_ms']:.5f} {row['bound_ms']:.5f} {row['bound_by']} "
              f"{row['bytes_per_s'] / 1e12:.3f} {row['bound_share']:.3f} | "
              f"{row['max_rel_err']:.3g}")
    return flash_rows[0], wkv_rows[0], scan_rows[0]


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _top1(a, b) -> float:
    return (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def lm_inputs(cfg, gen, B, S):
    """A prompt and a decode stream of S steps on the card: tokens drawn
    from ``gen``, or, for a stub frontend, bf16 embeddings (B, S,
    frontend_dim) drawn from it. Returns (key, sequence)."""
    if cfg.frontend == "none":
        return "tokens", torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                       device="cuda")
    return "embeds", torch.randn((B, S, cfg.frontend_dim), generator=gen,
                                 device="cuda").bfloat16()


def _step_inputs(key, nxt, stream, i):
    """Decode step i's inputs: the last greedy token, or the stub
    frontend's embedding at step i of ``stream``."""
    return {"tokens": nxt} if key == "tokens" else {"embeds": stream[:, i]}


def serve_lm(cfg, params, prompt, cache_len, new_tokens, stream=None):
    """Prefill ``prompt`` ({"tokens"} or {"embeds"}), then ``new_tokens``
    greedy decode steps (a stub frontend's steps take ``stream``'s
    embeddings). Returns (prefill logits, decode logits per step,
    generated tokens, prefill s, decode s, kernel launches and MoE
    group-size reads at the end of the prefill), host times around
    synchronised work."""
    prefill_step = make_prefill_step(cfg, cache_len)
    serve_step = make_serve_step(cfg)
    (key, seq), = prompt.items()
    B, S = seq.shape[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = dict(counts(), moe_host_reads=L.moe_dropless.host_reads)
    steps, out = [], []
    nxt = logits.argmax(-1)
    t0 = time.perf_counter()
    for i in range(new_tokens):
        out.append(nxt)
        pos = torch.full((B,), S + i, dtype=torch.long, device=seq.device)
        step_logits, cache = serve_step(params, cache,
                                        _step_inputs(key, nxt, stream, i), pos)
        steps.append(step_logits)
        nxt = step_logits.argmax(-1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return logits, steps, torch.stack(out, 1), t_prefill, t_decode, after_prefill


def card_vs_cpu(name, cfg, seed) -> dict:
    """A 2-layer model at full width: the card's prefill and decode
    logits against the port's CPU run of the same weights and tokens."""
    small = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = lm.init_params(gen, small, torch.bfloat16, "cuda")
    key, seq = lm_inputs(cfg, gen, LM_CPU_BATCH, LM_CPU_PROMPT + LM_CPU_DECODE)
    cache_len = LM_CPU_PROMPT + LM_CPU_DECODE
    results, host_s = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        p = params if device == "cuda" else _to(params, "cpu")
        sq = seq.to(device)
        logits, cache = lm.prefill(p, small, {key: sq[:, :LM_CPU_PROMPT]}, cache_len)
        outs = [logits]
        for i in range(LM_CPU_DECODE):
            pos = torch.full((LM_CPU_BATCH,), LM_CPU_PROMPT + i, dtype=torch.long,
                             device=device)
            logits, cache = lm.decode_step(
                p, small, cache, {key: sq[:, LM_CPU_PROMPT + i]}, pos)
            outs.append(logits)
        results[device] = torch.stack(outs).float().cpu()
        host_s[device] = time.perf_counter() - t0
        del p, cache
    del params
    torch.cuda.empty_cache()
    card, cpu = results["cuda"], results["cpu"]
    check(bool(torch.isfinite(card).all()), f"{name}: finite card logits")
    rel = _rel_l2(card, cpu)
    top1 = _top1(card, cpu)
    check(rel <= CARD_CPU_REL_L2,
          f"{name}: 2-layer card vs CPU logits rel L2 {rel:.3g} > {CARD_CPU_REL_L2}")
    print(f"[lm] {name}: card vs CPU, {LM_CPU_LAYERS} layers at full width, "
          f"B={LM_CPU_BATCH} S={LM_CPU_PROMPT} + {LM_CPU_DECODE} decode: logits "
          f"rel L2 {rel:.3g} (<= {CARD_CPU_REL_L2}), top-1 agree {top1:.2f}; host s "
          f"card {host_s['cuda']:.3f}, CPU {host_s['cpu']:.3f}")
    return {"rel_l2": rel, "top1": top1, "host_s": host_s}


#: the port's own kernels by the name the profiler gives them
#: the backward's three passes, in launch order
BWD_PASSES = ("delta_kernel", "dkdv_kernel", "dq_kernel")
#: the WKV-6 and selective-scan backward kernels, in launch order
WKV_BWD_PASSES = ("wkv6_bwd_sweep_kernel", "wkv6_bwd_reverse_kernel",
                  "wkv6_bwd_du_kernel")
SCAN_BWD_PASSES = ("scan_bwd_stash_kernel", "scan_bwd_reverse_kernel",
                   "scan_bwd_dbc_kernel", "scan_bwd_dA_kernel")
PORT_KERNELS = ("window_kernel", "fa_kernel", "wkv6_kernel", "scan_kernel",
                *BWD_PASSES, *WKV_BWD_PASSES, *SCAN_BWD_PASSES)


def _on_card(prof) -> tuple[float, int, list, dict]:
    """Card time (us) in a profiler window, the number of kernels and
    copies the card ran, the top ones by card time, and the card time and
    count of each of the port's kernels that ran."""
    rows = [
        (e.self_device_time_total, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    own = {}
    for t, n, key in rows:
        for name in PORT_KERNELS:
            if name in key:
                us, cnt = own.get(name, (0.0, 0))
                own[name] = (us + t, cnt + n)
    return (sum(t for t, _, _ in rows), sum(n for _, n, _ in rows),
            sorted(rows, reverse=True)[:5], own)


def profile_lm(cfg, params, prompt, stream) -> dict:
    """The prefill and the decode steps again, each under its own PyTorch
    profiler window: the card's time in each and its top kernels. The
    profiler slows the host, not the card, so the card's share of each
    phase is taken against that phase's time measured without it."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    (key, seq), = prompt.items()
    B, S = seq.shape[:2]
    with profile(activities=acts) as prof:
        logits, cache = make_prefill_step(cfg, LM_CACHE_LEN)(params, prompt)
        torch.cuda.synchronize()
    prefill_us, prefill_n, prefill_top, prefill_own = _on_card(prof)
    serve_step = make_serve_step(cfg)
    nxt = logits.argmax(-1)
    with profile(activities=acts) as prof:
        for i in range(LM_NEW_TOKENS):
            pos = torch.full((B,), S + i, dtype=torch.long, device=seq.device)
            step_logits, cache = serve_step(params, cache,
                                            _step_inputs(key, nxt, stream, i), pos)
            nxt = step_logits.argmax(-1)
        torch.cuda.synchronize()
    decode_us, decode_n, decode_top, decode_own = _on_card(prof)
    return {"prefill_us": prefill_us, "prefill_n": prefill_n,
            "prefill_top": prefill_top, "prefill_own": prefill_own,
            "decode_us": decode_us, "decode_n": decode_n,
            "decode_top": decode_top, "decode_own": decode_own}


def kv_quant_step(cfg, params, tokens, nxt) -> dict:
    """One decode step with ``kv_quant=True`` from the prefill cache with
    its attention layers quantized by `layers.quantize_kv`, against the
    bf16 decode step from the same prefill."""
    B, S = tokens.shape
    _, cache = make_prefill_step(cfg, S + 1)(params, {"tokens": tokens})
    q8 = []  # mamba states are not written in place: shared as they are
    for (mixer, _), c in zip(cfg.layer_plan(), cache):
        if mixer == "attn":
            (k, ks), (v, vs) = L.quantize_kv(c["k"]), L.quantize_kv(c["v"])
            c = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
        q8.append(c)
    pos = torch.full((B,), S, dtype=torch.long, device=tokens.device)
    want, _ = make_serve_step(cfg)(params, cache, {"tokens": nxt}, pos)
    got, q8 = make_serve_step(cfg, kv_quant=True)(params, q8, {"tokens": nxt}, pos)
    rel, top1 = _rel_l2(got, want), _top1(got, want)
    attn = [c for (m, _), c in zip(cfg.layer_plan(), q8) if m == "attn"]
    check(all(c["k"].dtype == c["v"].dtype == torch.int8 for c in attn),
          f"{cfg.name}: the int8 cache stays int8")
    check(all(bool((c["k"][:, :, S] != 0).any()) for c in attn),
          f"{cfg.name}: the new token landed in the int8 cache")
    print(f"[lm] {cfg.name}: int8-KV decode step vs bf16, from the same prefill "
          f"({len(attn)} attention layers quantized): logits rel L2 {rel:.3g} "
          f"(< {KVQ_REL_L2}), top-1 agree {top1:.2f}; cache int8, new token written")
    check(rel < KVQ_REL_L2, f"{cfg.name}: int8-KV decode vs bf16 rel L2 {rel:.3g}")
    return {"rel_l2": rel, "top1": top1}


def phase_lm(name: str, seed: int, n_layers=None, kv_quant=False) -> dict:
    """Serve one model at full width, and at full depth unless
    ``n_layers`` cuts it; with ``kv_quant`` also hold its int8-KV decode
    step against the bf16 one. Returns its numbers and the main path's
    launch counts."""
    cfg = load_config(name)
    full = cfg.param_counts()["total"]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        print(f"[lm] {name}: depth cut to {n_layers} of {load_config(name).n_layers} "
              f"layers at full width ({full / 1e9:.2f} B parameters, "
              f"{2 * full / 1e9:.1f} GB bf16 in all, more than the card holds; "
              f"served: {cfg.param_counts()['total'] / 1e9:.2f} B)")
    plan = cfg.layer_plan()
    n_attn = sum(m == "attn" for m, _ in plan)
    n_rwkv = sum(m == "rwkv" for m, _ in plan)
    n_mamba = sum(m == "mamba" for m, _ in plan)
    n_moe = sum(f == "moe" for _, f in plan)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = lm.init_params(gen, cfg, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    print(f"[lm] {name}: {cfg.n_layers} layers ({n_attn} attention, {n_mamba} "
          f"mamba, {n_rwkv} RWKV; {n_moe} MoE ffns), d_model {cfg.d_model}, "
          f"{param_count(params) / 1e9:.3f} B parameters, "
          f"{param_bytes(params) / 1e9:.2f} GB bf16, built in "
          f"{time.perf_counter() - t0:.1f} s")
    key, seq = lm_inputs(cfg, gen, LM_BATCH, LM_PROMPT + LM_NEW_TOKENS)
    prompt, stream = {key: seq[:, :LM_PROMPT]}, seq[:, LM_PROMPT:]
    if key == "embeds":
        print(f"[lm] {name}: {cfg.frontend} frontend: prompt and decode steps are "
              f"bf16 embeddings of width {cfg.frontend_dim} drawn from the seed, "
              "lifted by frontend_proj")
    # warm-up (cuBLAS handles, kernel libraries), not counted
    serve_lm(cfg, params, {key: seq[:, :64]}, 64 + 2, 2, seq[:, :2])

    reset_counts()  # the main path starts here
    L.moe_dropless.host_reads = 0
    logits, steps, out, t_prefill, t_decode, at_prefill = serve_lm(
        cfg, params, prompt, LM_CACHE_LEN, LM_NEW_TOKENS, stream)
    launched = counts()
    moe_reads_per_step = (
        (L.moe_dropless.host_reads - at_prefill["moe_host_reads"]) / LM_NEW_TOKENS)
    for kernel, want in (("flash_attention", n_attn), ("rwkv6_scan", n_rwkv),
                         ("mamba_scan", n_mamba)):
        check(at_prefill[kernel] == want,
              f"{name}: {at_prefill[kernel]} {kernel} launches in prefill, want {want}")
        check(launched[kernel] == at_prefill[kernel],
              f"{name}: {launched[kernel] - at_prefill[kernel]} {kernel} launches "
              "in decode, want none")
    check(launched["preemptible_matmul_window"] == 0, f"{name}: no window launches")
    check(bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(s).all()) for s in steps), f"{name}: finite logits")
    check(tuple(out.shape) == (LM_BATCH, LM_NEW_TOKENS)
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab,
          f"{name}: generated tokens in the vocabulary")
    print(f"[lm] {name}: main path launches {launched} (prefill: one flash per "
          f"attention layer, one WKV-6 per time-mix layer, one scan per mamba "
          f"layer; decode: none)")
    if n_moe:
        print(f"[lm] {name}: MoE group sizes read back to the host "
              f"{at_prefill['moe_host_reads']} times in the prefill and "
              f"{moe_reads_per_step:g} times per decode step (once per MoE layer)")

    # decode at step S against a prefill over the S+1 tokens (embeddings)
    longer = (torch.cat([prompt[key], out[:, :1]], dim=1) if key == "tokens"
              else seq[:, :LM_PROMPT + 1])
    want, _ = make_prefill_step(cfg, LM_PROMPT + 1)(params, {key: longer})
    rel = _rel_l2(steps[0], want)
    top1 = _top1(steps[0], want)
    check(rel <= CONSIST_REL_L2 and top1 >= CONSIST_TOP1,
          f"{name}: decode vs longer prefill rel L2 {rel:.3g}, top-1 {top1:.2f}")
    print(f"[lm] {name}: decode at step {LM_PROMPT} vs prefill over "
          f"{LM_PROMPT + 1}: rel L2 {rel:.3g} (<= {CONSIST_REL_L2}), top-1 "
          f"agree {top1:.2f} (>= {CONSIST_TOP1})")
    extra = ({"kv_quant": kv_quant_step(cfg, params, prompt["tokens"], out[:, 0])}
             if kv_quant else {})
    prof = profile_lm(cfg, params, prompt, stream)
    del params, logits, steps
    torch.cuda.empty_cache()
    ms_token = t_decode / LM_NEW_TOKENS * 1e3
    print(f"[lm] {name}: prefill {t_prefill * 1e3:.3f} ms "
          f"({LM_BATCH * LM_PROMPT / t_prefill:.1f} prompt tokens/s), decode "
          f"{ms_token:.3f} ms per step ({LM_BATCH / (t_decode / LM_NEW_TOKENS):.1f} "
          f"tokens/s at batch {LM_BATCH})")
    busy = {}
    for phase, wall_ms, n in (("prefill", t_prefill * 1e3, 1),
                              ("decode", ms_token, LM_NEW_TOKENS)):
        card_ms = prof[f"{phase}_us"] / 1e3 / n
        if card_ms == 0:
            print(f"[lm] {name}: {phase} card time not measured "
                  "(profiler saw no card time)")
            busy[phase] = None
            continue
        busy[phase] = card_ms / wall_ms
        print(f"[lm] {name}: {phase} card busy {card_ms:.3f} ms of "
              f"{wall_ms:.3f} ms{' per step' if n > 1 else ''} "
              f"({busy[phase] * 100:.2f}%) in {prof[f'{phase}_n'] / n:g} "
              f"kernels and copies; top:")
        for t_us, cnt, key in prof[f"{phase}_top"]:
            print(f"[lm]   {t_us / 1e3 / n:.3f} ms in {cnt / n:g} x {key[:70]}")
        for kernel, (t_us, cnt) in prof[f"{phase}_own"].items():
            print(f"[lm]   port kernel {kernel}: {t_us / 1e3 / n:.3f} ms in "
                  f"{cnt / n:g} ({t_us / prof[f'{phase}_us'] * 100:.2f}% of the "
                  "card time)")
    cpu = card_vs_cpu(name, cfg, seed + 1)
    return {
        "launches": launched, "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_step": ms_token, "busy_share": busy,
        "consistency_rel_l2": rel, "card_vs_cpu": cpu,
        "moe_host_reads_per_step": moe_reads_per_step, **extra,
    }


# ---------------------------------------------------------------------------
# training: the flash-attention backward, StableLM-1.6B train steps
# ---------------------------------------------------------------------------
#: the main path: `train_loop` on StableLM-1.6B at full width and depth
TRAIN_MODEL = "stablelm_1_6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR, TRAIN_SEED = 8, 2048, 8, 3e-4, 0
#: one train step at full width and 2 layers, card against the port's own
#: CPU run: loss, grad norm, every gradient leaf and every parameter after
#: the AdamW update within the 2-layer serving bound (CARD_CPU_REL_L2;
#: bf16 products round at other places in cuBLAS and the CPU's kernels)
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 1, 256
#: the forward's log-sum-exp (base 2, fp32) against the plain version's:
#: both from fp32 scores of the same bf16 inputs, summed in other orders
#: (values ~10, so a few fp32 ulps)
FLASH_LSE_TOL = 1e-4
#: resume on the card: the JAX package's own case (tests/test_system.py,
#: test_training_checkpoint_resume_identical) on smoke Minitron-4B with
#: its head width set to 64, the kernels' narrowest; its tolerance
RESUME_RTOL = 1e-4


#: the bf16 backward kernel's products per (query, key <= query) pair:
#: s, dP, dV and dK as hi + lo (P and dS as two bf16 terms each) in the
#: dK/dV pass; s, dP and dQ as hi + lo in the dQ pass
BWD_SPLIT_PRODUCTS = 10


def bwd_bound(B, S, H, Hkv, hd, es, products=5):
    """Least time (ms) for the causal attention backward, and what bounds
    it: q, k, v, o, dO read and dq, dk, dv written once over memory
    bandwidth, against ``products`` products of 2 * hd flops per (query,
    key <= query) pair at the bf16 tensor-core peak: five (s, dP, dV, dQ,
    dK) for the bound, `BWD_SPLIT_PRODUCTS` for the split floor."""
    nbytes = 4 * B * S * (H + Hkv) * hd * es
    flops = products / 5 * attention_backward_flops(B, S, H, hd)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bwd_case(B, S, H, Hkv, hd, dtype, seed):
    """The backward kernel, fed the forward kernel's output and
    log-sum-exp, against `attention_backward_plain` (a normalised softmax,
    no log-sum-exp): each gradient within BACKWARD_TOL, a second launch
    bit-identical; its card time, the plain version's, SDPA's backward
    alone, the bound and the split floor."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    o, lse = flash_attention_call(q, k, v, return_lse=True)
    got = flash_attention_backward_call(q, k, v, o, do, lse)
    again = flash_attention_backward_call(q, k, v, o, do, lse)
    want = attention_backward_plain(q, k, v, o, do)
    torch.cuda.synchronize()
    what = f"flash backward at B={B} S={S} H={H}/{Hkv} hd={hd} {dtype}"
    ratios = [tol_ratio(g, w, BACKWARD_TOL) for g, w in zip(got, want)]
    diff = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    for name, r in zip(("dq", "dk", "dv"), ratios):
        check(r <= 1.0, f"{what}: {name} error {r:.3g} x the limit "
              f"(rtol, floor) {BACKWARD_TOL[dtype]}")
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"{what}: two launches differ")
    del got, again, want
    ms = device_ms(lambda: flash_attention_backward_call(q, k, v, o, do, lse), reps=3)
    plain_ms = device_ms(lambda: attention_backward_plain(q, k, v, o, do), reps=1)
    # SDPA's backward alone: its forward runs once, outside the timing
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=H != Hkv)
    dot = do.transpose(1, 2)
    library_ms = cuda_ms(
        lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True),
        reps=5)
    del out, qt, kt, vt
    torch.cuda.empty_cache()
    bound_ms, bound_by = bwd_bound(B, S, H, Hkv, hd, q.element_size())
    split_ms, _ = bwd_bound(B, S, H, Hkv, hd, q.element_size(), BWD_SPLIT_PRODUCTS)
    return {
        "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
        "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": diff, "tol_ratio": max(ratios), "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "split_floor_ms": split_ms,
    }


def forward_lse_case(B, S, H, Hkv, hd, seed) -> dict:
    """The bf16 forward kernel with and without its log-sum-exp: ``o``
    the same bits both ways, lse against the plain version's within
    `FLASH_LSE_TOL`, and the forward's card time both ways."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    o = flash_attention_call(q, k, v)
    o_lse, lse = flash_attention_call(q, k, v, return_lse=True)
    _, want = attention_plain(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    what = f"flash forward lse at B={B} S={S} H={H}/{Hkv} hd={hd}"
    check(torch.equal(o, o_lse), f"{what}: o differs with and without lse")
    err = (lse - want).abs().max().item()
    check(err <= FLASH_LSE_TOL, f"{what}: lse max abs err {err:.3g} > {FLASH_LSE_TOL}")
    ms = device_ms(lambda: flash_attention_call(q, k, v), reps=10)
    lse_ms = device_ms(lambda: flash_attention_call(q, k, v, return_lse=True), reps=10)
    return {"ms": ms, "lse_ms": lse_ms, "lse_err": err}


#: the WKV-6 and selective-scan backward kernels against their plain
#: versions (the plain WKV-6 backward a step-by-step recurrence, the
#: plain scan backward chunked scans of the same decays in another
#: order): 1e-4 of the max, the forwards' bound
WKV_BWD_MAX_REL_ERR = SCAN_BWD_MAX_REL_ERR = 1e-4
#: the plain scan backward's chunk on the card (its (Bb, chunk, di, ns)
#: temporaries are 268 MB each at the training shape)
SCAN_BWD_PLAIN_CHUNK = 64
#: training the recurrent mixers: (config, layers kept at full width),
#: each at global batch TRAIN_BATCH. RWKV-6-7B's 32 layers would hold ~170 GB at the ~22
#: bytes a parameter StableLM's update peaks at, 8 layers ~55 GB; one
#: Jamba layer pair would hold ~82 GB (layer 1 is MoE, ~2.8 B parameters
#: alone), so Jamba trains its first layer (mamba mixer, dense SwiGLU)
RECURRENT_TRAIN = (("rwkv6_7b", 8), ("jamba_v0_1_52b", 1))


def wkv_bwd_bound(B, S, H, hd):
    """Least time (ms) for the WKV-6 backward, and what bounds it: r, k,
    v, w, dy read and dr, dk, dv, dw written once (plus u and du) over
    memory bandwidth, against WKV_BWD_FLOPS per state element and step
    at the fp32 FMA peak."""
    nbytes = 4 * (9 * B * S * H * hd + 2 * H * hd)
    flops = wkv_backward_flops(B, S, H, hd)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_bwd_bound(B, S, di, ns):
    """Least time (ms) for the selective-scan backward, and what bounds
    it: dt, x, dy read and ddt, dx written once, B, C read and dB, dC
    written, A, h0 read and dA, dh0 written, over memory bandwidth;
    against the larger of one exponential per state element and step
    (a_t, which both the states and the adjoint need) at the SFU rate
    and SCAN_BWD_FLOPS per element and step at the fp32 FMA peak."""
    elems = float(B * S * di * ns)
    nbytes = 4 * (5 * B * S * di + 4 * B * S * ns + 2 * di * ns + 2 * B * di * ns)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_exp = elems / (SFU_PER_CLOCK_SM * N_SMS * SM_CLOCK_HZ) * 1e3
    t_fma = scan_backward_flops(B, S, di, ns) / PEAK_FLOPS[torch.float32] * 1e3
    t_ops = max(t_exp, t_fma)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bwd_row(what, got, again, want, tol, call, plain, bound):
    """Each gradient against the plain version's within ``tol`` of its
    max, two launches bit-identical; the card time of the kernel and of
    the plain version (CUDA-graph replay) beside the bound."""
    rels, diff = [], 0.0
    for g, w in zip(got, want):
        m = w.abs().max().item()
        err = (g - w).abs().max().item()
        diff = max(diff, err)
        rels.append(err / m if m else err)
    check(max(rels) <= tol, f"{what}: rel errs {[f'{r:.3g}' for r in rels]} > {tol}")
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"{what}: two launches differ")
    ms = device_ms(call, reps=3)
    plain_ms = device_ms(plain, reps=1)
    bound_ms, bound_by = bound
    return {"max_abs_err": diff, "max_rel_err": max(rels), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms}


def wkv_bwd_case(B, S, H, hd, seed) -> dict:
    """The WKV-6 backward kernels against `rwkv6_scan_backward_plain`, as
    the model's training feeds them (no cotangent on S_final)."""
    r, k, v, w, u = wkv_inputs(B, S, H, hd, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    got = rwkv6_scan_backward_call(r, k, v, w, u, dy)
    again = rwkv6_scan_backward_call(r, k, v, w, u, dy)
    want = rwkv6_scan_backward_plain(r, k, v, w, u, dy)
    torch.cuda.synchronize()
    row = _bwd_row(f"WKV-6 backward at B={B} S={S} H={H}", got, again, want,
                   WKV_BWD_MAX_REL_ERR,
                   lambda: rwkv6_scan_backward_call(r, k, v, w, u, dy),
                   lambda: rwkv6_scan_backward_plain(r, k, v, w, u, dy),
                   wkv_bwd_bound(B, S, H, hd))
    del got, again, want
    torch.cuda.empty_cache()
    return {"B": B, "S": S, "H": H, "hd": hd, "dtype": "float32", **row}


def scan_bwd_case(B, S, di, ns, seed) -> dict:
    """The selective-scan backward kernels against
    `mamba_scan_backward_plain`, as Jamba's training feeds them (zero h0,
    no cotangent on h_final, A drawn per element)."""
    ops = scan_inputs(B, S, di, ns, seed, False, "random")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn((B, S, di), generator=gen, device="cuda")
    c = SCAN_BWD_PLAIN_CHUNK
    got = mamba_scan_backward_call(*ops, dy, chunk=c)
    again = mamba_scan_backward_call(*ops, dy, chunk=c)
    want = mamba_scan_backward_plain(*ops, dy, chunk=c)
    torch.cuda.synchronize()
    row = _bwd_row(f"scan backward at B={B} S={S} di={di}", got, again, want,
                   SCAN_BWD_MAX_REL_ERR,
                   lambda: mamba_scan_backward_call(*ops, dy, chunk=c),
                   lambda: mamba_scan_backward_plain(*ops, dy, chunk=c),
                   scan_bwd_bound(B, S, di, ns))
    del got, again, want
    torch.cuda.empty_cache()
    return {"B": B, "S": S, "di": di, "ns": ns, "dtype": "float32", **row}


def phase_recurrent_kernels() -> tuple[dict, dict]:
    """Both backward kernels against their plain versions at the
    training shapes (B 8 x 2048) and the LM phase's (B 2 x 2048); returns
    the training shapes' rows."""
    rwkv, jamba = load_config("rwkv6_7b"), load_config("jamba_v0_1_52b")
    H, hd = rwkv.n_rwkv_heads, rwkv.rwkv_head_size
    di, ns = jamba.d_inner, jamba.mamba_d_state
    print("[train] wkv6 backward B S H hd | ms plain_ms bound_ms bound_by bound/ms | "
          "max_abs_err max_rel_err  (card time, CUDA-graph replay; bound: "
          f"{WKV_BWD_FLOPS} fp32 flops per state element and step at the FMA peak, "
          f"or 9 (B, S, H, hd) fp32 tensors once at {PEAK_BYTES_S / 1e12:g} TB/s; "
          f"tolerance {WKV_BWD_MAX_REL_ERR} of the max; two launches bit-identical)")
    wkv_rows = []
    for seed, B in enumerate((TRAIN_BATCH, LM_BATCH)):
        row = wkv_bwd_case(B, TRAIN_SEQ, H, hd, 40 + seed)
        wkv_rows.append(row)
        print(f"[train] wkv6 backward {B} {TRAIN_SEQ} {H} {hd} | {row['ms']:.5f} "
              f"{row['plain_ms']:.5f} {row['bound_ms']:.5f} {row['bound_by']} "
              f"{row['bound_share']:.3f} | {row['max_abs_err']:.3g} "
              f"{row['max_rel_err']:.3g}; bit-identical across launches")
    print("[train] scan backward B S di ns | ms plain_ms bound_ms bound_by bound/ms | "
          "max_abs_err max_rel_err  (card time, CUDA-graph replay; plain: chunk "
          f"{SCAN_BWD_PLAIN_CHUNK}; bound: one exponential per state element and step "
          f"on the SFUs at {SM_CLOCK_HZ / 1e9:g} GHz or {SCAN_BWD_FLOPS} fp32 flops at "
          "the FMA peak, or 5 (B, S, di) fp32 tensors once; A per element; tolerance "
          f"{SCAN_BWD_MAX_REL_ERR} of the max; two launches bit-identical)")
    scan_rows = []
    for seed, B in enumerate((TRAIN_BATCH, LM_BATCH)):
        row = scan_bwd_case(B, TRAIN_SEQ, di, ns, 50 + seed)
        scan_rows.append(row)
        print(f"[train] scan backward {B} {TRAIN_SEQ} {di} {ns} | {row['ms']:.5f} "
              f"{row['plain_ms']:.5f} {row['bound_ms']:.5f} {row['bound_by']} "
              f"{row['bound_share']:.3f} | {row['max_abs_err']:.3g} "
              f"{row['max_rel_err']:.3g}; bit-identical across launches")
    return wkv_rows[0], scan_rows[0]


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def train_card_vs_cpu(cfg, seed) -> dict:
    """One train step (loss, gradients, AdamW update) of a 2-layer model
    at full width, on the card and on the CPU from the same bf16 weights
    and batch: the step `make_train_step` takes, written out so that its
    gradients can be compared too."""
    small = dataclasses.replace(cfg, n_layers=TRAIN_CPU_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = lm.init_params(gen, small, torch.bfloat16, "cuda")
    raw = SyntheticTokenDataset(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_CPU_SEQ, global_batch=TRAIN_CPU_BATCH,
        seed=seed)).batch(0)
    opt_cfg = AdamWConfig(lr_peak=TRAIN_LR, total_steps=TRAIN_STEPS)
    runs = {}
    for device in ("cuda", "cpu"):
        p = params if device == "cuda" else _to(params, "cpu")
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        t0 = time.perf_counter()
        (loss, _), grads = value_and_grad(p, small, batch)
        new, _, om = adamw_update(p, grads, adamw_init(p), opt_cfg,
                                  decay=lm.decay_mask(p))
        loss, gnorm = loss.item(), om["grad_norm"].item()
        runs[device] = (loss, gnorm, _to(grads, "cpu"), _to(new, "cpu"),
                        time.perf_counter() - t0)
        del p, grads, new
    del params
    torch.cuda.empty_cache()
    (c_loss, c_gn, c_g, c_p, c_s), (h_loss, h_gn, h_g, h_p, h_s) = (
        runs["cuda"], runs["cpu"])
    check(math.isfinite(c_loss) and math.isfinite(c_gn), "finite card loss")
    worst = {}
    for kind, got, want in (("gradient", c_g, h_g), ("parameter", c_p, h_p)):
        paths, g_leaves, _ = flatten_with_paths(got)
        _, w_leaves, _ = flatten_with_paths(want)
        errs = [(_rel_l2(g, w), path) for g, w, path in zip(g_leaves, w_leaves, paths)]
        worst[kind] = max(errs)
        check(worst[kind][0] <= CARD_CPU_REL_L2,
              f"2-layer train step card vs CPU: {kind} {worst[kind][1]} rel L2 "
              f"{worst[kind][0]:.3g} > {CARD_CPU_REL_L2}")
    for name, a, b in (("loss", c_loss, h_loss), ("grad norm", c_gn, h_gn)):
        check(_rel(a, b) <= CARD_CPU_REL_L2,
              f"2-layer train step card vs CPU: {name} {a} vs {b}")
    print(f"[train] {cfg.name}: card vs CPU, {TRAIN_CPU_LAYERS} layers at full width, "
          f"B={TRAIN_CPU_BATCH} S={TRAIN_CPU_SEQ}, one AdamW step: loss {c_loss:.6f} "
          f"vs {h_loss:.6f} (rel {_rel(c_loss, h_loss):.3g}), grad norm {c_gn:.6f} "
          f"vs {h_gn:.6f} (rel {_rel(c_gn, h_gn):.3g}); worst leaf rel L2: "
          f"gradient {worst['gradient'][0]:.3g} ({worst['gradient'][1]}), "
          f"parameter after the update {worst['parameter'][0]:.3g} "
          f"({worst['parameter'][1]}), all <= {CARD_CPU_REL_L2}; host s card "
          f"{c_s:.3f}, CPU {h_s:.3f}")
    return {"loss_rel": _rel(c_loss, h_loss), "grad_norm_rel": _rel(c_gn, h_gn),
            "worst_grad_rel_l2": worst["gradient"][0],
            "worst_param_rel_l2": worst["parameter"][0]}


@contextlib.contextmanager
def gc_pauses():
    """The host time of every garbage collection inside, by generation:
    yields a list that fills with (generation, ms)."""
    seen, started = [], {}

    def on_gc(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            seen.append((info["generation"], (time.perf_counter() - started.pop("t")) * 1e3))

    gc.callbacks.append(on_gc)
    try:
        yield seen
    finally:
        gc.callbacks.remove(on_gc)


@contextlib.contextmanager
def train_step_metrics():
    """Every step's metrics (loss, grad norm, lr) of the `train_loop` runs
    inside, collected by wrapping the step function it builds."""
    seen, make = [], train_mod.make_train_step

    def wrapped(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        def step(*step_args):
            out = step_fn(*step_args)
            seen.append(out[2])
            return out

        return step

    train_mod.make_train_step = wrapped
    try:
        yield seen
    finally:
        train_mod.make_train_step = make


def train_main_path(cfg, label="main path") -> dict:
    """`train_loop` at full width (and at ``cfg``'s depth): a path of this
    phase. Host clock at each step's end (its loss read back, so
    synchronised); the last step runs under the profiler and is left out
    of ms per step. Every kernel of the stack launches as its layers say:
    each attention, RWKV and mamba layer's forward twice a step (once
    more under remat) and its backward once."""
    marks, prof = [], profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(step, loss):
        marks.append(time.perf_counter())
        if step == TRAIN_STEPS - 2:
            prof.__enter__()
        elif step == TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    # The earlier phases leave over a million objects alive in this
    # process; a full collection during a step would scan them all (a
    # stall a process that only trains never meets). Collect once, timed,
    # then move the survivors out of the collector's reach.
    tracked = len(gc.get_objects())
    t_gc = time.perf_counter()
    gc.collect()
    full_gc_ms = (time.perf_counter() - t_gc) * 1e3
    gc.freeze()
    reset_counts()  # the path starts here
    with train_step_metrics() as metrics, gc_pauses() as pauses:
        t0 = time.perf_counter()
        losses = train_mod.train_loop(
            cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            lr=TRAIN_LR, seed=TRAIN_SEED, log_every=1, on_step=on_step,
            device="cuda")
    gc.unfreeze()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries0
    launched = dict(counts(),
                    flash_attention_backward=flash_attention_backward_call.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gnorms = [m["grad_norm"].item() for m in metrics]
    check(len(losses) == len(gnorms) == TRAIN_STEPS, "one loss per step")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{cfg.name}: finite losses {losses} and grad norms {gnorms}")
    plan = cfg.layer_plan()
    n_attn, n_rwkv, n_mamba = (sum(m == kind for m, _ in plan)
                               for kind in ("attn", "rwkv", "mamba"))
    per_step = {"flash_attention": 2 * n_attn, "flash_attention_backward": n_attn,
                "rwkv6_scan": 2 * n_rwkv, "rwkv6_scan_backward": n_rwkv,
                "mamba_scan": 2 * n_mamba, "mamba_scan_backward": n_mamba,
                "preemptible_matmul_window": 0}
    for kernel, want in per_step.items():
        check(launched[kernel] == want * TRAIN_STEPS,
              f"{cfg.name}: {launched[kernel]} {kernel} launches in {TRAIN_STEPS} "
              f"steps, want {want} per step")
    step_s = [b - a for a, b in zip(marks[:-2], marks[1:-1])]  # steps 1 .. N-2
    ms_step = sum(step_s) / len(step_s) * 1e3
    tokens_s = TRAIN_BATCH * TRAIN_SEQ / (ms_step / 1e3)
    card_us, n_card, top, own = _on_card(prof)
    busy = card_us / 1e3 / ms_step
    n_moe = sum(f == "moe" for _, f in plan)
    print(f"[train] {label}: {cfg.name}: {cfg.n_layers} layers ({n_attn} attention, "
          f"{n_mamba} mamba, {n_rwkv} RWKV; {n_moe} MoE ffns), d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {cfg.param_counts()['total'] / 1e9:.3f} B parameters "
          f"(the config's count), bf16, fp32 AdamW moments; global batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, {TRAIN_STEPS} steps, lr {TRAIN_LR}, seed {TRAIN_SEED}")
    print(f"[train] {cfg.name}: launches {launched} (per step: "
          + ", ".join(f"{k} {v}" for k, v in per_step.items() if v)
          + "; each forward twice under remat)")
    print(f"[train] {cfg.name}: losses {[round(x, 4) for x in losses]}")
    print(f"[train] {cfg.name}: grad norms {[round(x, 4) for x in gnorms]}")
    print(f"[train] {cfg.name}: step 0 (with set-up and first calls) "
          f"{(marks[0] - t0) * 1e3:.3f} ms; steps 1-{TRAIN_STEPS - 2} {ms_step:.3f} ms "
          f"per step (each {[round(x * 1e3, 3) for x in step_s]}), {tokens_s:.1f} "
          f"tokens/s; card peak memory {peak_gb:.3f} GB")
    model_flops = roofline.analytic_cost(
        cfg, ShapeCase("train", TRAIN_SEQ, TRAIN_BATCH, "train")).model_flops
    rate = model_flops / (ms_step / 1e3)
    print(f"[train] {cfg.name}: model FLOP rate {rate / 1e12:.3f} TFLOP/s "
          f"({model_flops:.4e} model flops a step: roofline.analytic_cost's 6 N D, "
          f"N the config's {cfg.param_counts()['active'] / 1e9:.3f} B active "
          f"parameters), {rate / roofline.PEAK_FLOPS * 100:.2f}% of "
          f"{roofline.PEAK_FLOPS / 1e12:g} TFLOP/s; {card_line()}")
    print(f"[train] {cfg.name}: host: {tracked} objects tracked by the garbage "
          f"collector before the path, one full collection of them {full_gc_ms:.3f} "
          f"ms, then frozen; {len(pauses)} collections in the path "
          f"took {sum(ms for _, ms in pauses):.3f} ms (longest "
          f"{max((ms for _, ms in pauses), default=0.0):.3f} ms, generation-2 "
          f"collections {sum(g == 2 for g, _ in pauses)}); allocator retries "
          f"{retries}")
    print(f"[train] {cfg.name}: step {TRAIN_STEPS - 1} under the profiler: card busy "
          f"{card_us / 1e3:.3f} ms of {ms_step:.3f} ms ({busy * 100:.2f}%) in "
          f"{n_card} kernels and copies; top:")
    for t_us, cnt, key in top:
        print(f"[train]   {t_us / 1e3:.3f} ms in {cnt} x {key[:70]}")
    for kernel, (t_us, cnt) in own.items():
        print(f"[train]   port kernel {kernel}: {t_us / 1e3:.3f} ms in {cnt} "
              f"({t_us / card_us * 100:.2f}% of the card time)")
    backward = {}
    for group, names in (("flash attention", BWD_PASSES), ("WKV-6", WKV_BWD_PASSES),
                         ("selective scan", SCAN_BWD_PASSES)):
        passes = {k: own.get(k, (0.0, 0)) for k in names}
        if not any(cnt for _, cnt in passes.values()):
            continue
        backward.update({k: t_us / 1e3 for k, (t_us, _) in passes.items()})
        print(f"[train] {cfg.name}: {group} backward passes in the profiled step: "
              + "; ".join(f"{k} {t_us / 1e3:.3f} ms in {cnt}"
                          for k, (t_us, cnt) in passes.items())
              + f"; together {sum(t for t, _ in passes.values()) / 1e3:.3f} ms")
    return {"launches": launched, "launches_per_step": per_step, "losses": losses,
            "grad_norms": gnorms, "ms_per_step": ms_step, "tokens_per_s": tokens_s,
            "peak_gb": peak_gb, "busy_share": busy, "backward_ms": backward,
            "model_flop_rate": rate}


def train_resume() -> dict:
    """30 steps straight, and 20 steps then a resume to 30 from the
    checkpoint, on the card: the last 10 losses agree at RESUME_RTOL.
    The embedding's backward on the card sums with atomics, so the runs
    need not agree bit for bit."""
    cfg = dataclasses.replace(smoke_config(load_config("minitron_4b")), head_dim=64)
    kw = dict(global_batch=4, seq_len=32, log_every=1000, ckpt_every=10,
              schedule_steps=30, device="cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        full = train_mod.train_loop(cfg, steps=30, ckpt_dir=os.path.join(root, "a"), **kw)
        train_mod.train_loop(cfg, steps=20, ckpt_dir=os.path.join(root, "b"), **kw)
        resumed = train_mod.train_loop(cfg, steps=30, ckpt_dir=os.path.join(root, "b"),
                                       **kw)
    worst = max(_rel(a, b) for a, b in zip(resumed[-10:], full[-10:]))
    check(len(resumed) == 10 and worst <= RESUME_RTOL,
          f"resume: last 10 losses {resumed[-10:]} vs {full[-10:]}")
    print(f"[train] resume on the card ({cfg.name}, head width 64): 30 steps "
          f"straight vs 20 + resume to 30, last 10 losses worst rel diff "
          f"{worst:.3g} (<= {RESUME_RTOL}); {time.perf_counter() - t0:.3f} s")
    return {"worst_rel": worst}


def phase_train() -> tuple[dict, dict]:
    """The backward kernel against its plain version, a 2-layer step card
    vs CPU, the main path, a resume; returns the kernel row the
    ``kernels`` line reports (StableLM's shape) and the main path's
    numbers."""
    t0 = time.perf_counter()
    cfg = load_config(TRAIN_MODEL)
    nemo = load_config("mistral_nemo_12b")
    fwd = forward_lse_case(LM_BATCH, LM_PROMPT, nemo.n_heads, nemo.n_kv_heads,
                           nemo.head_dim, 29)
    print(f"[train] flash forward at B={LM_BATCH} S={LM_PROMPT} "
          f"H={nemo.n_heads}/{nemo.n_kv_heads} hd={nemo.head_dim} bf16: "
          f"{fwd['ms']:.5f} ms without lse, {fwd['lse_ms']:.5f} ms with lse "
          "(card time, CUDA-graph replay); o the same bits both ways; lse vs "
          f"plain max abs err {fwd['lse_err']:.3g} (<= {FLASH_LSE_TOL})")
    fw = flash_case(TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                    torch.bfloat16, 28)
    print(f"[train] flash forward at StableLM's training shape B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ} H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} bf16: "
          f"{fw['ms']:.5f} ms (card time, CUDA-graph replay, no lse), plain "
          f"{fw['plain_ms']:.5f} ms, SDPA {fw['library_ms']:.5f} ms; bound "
          f"{fw['bound_ms']:.5f} ms ({fw['bound_by']}), split floor "
          f"{fw['split_floor_ms']:.5f} ms; max abs err {fw['max_abs_err']:.3g}, "
          f"{fw['tol_ratio']:.3g} x the limit")
    print("[train] flash backward B S H/Hkv hd dtype | ms plain_ms sdpa_bwd_ms "
          "bound_ms bound_by split_floor_ms | max_abs_err err/limit  (ms: card "
          "time, CUDA-graph replay, the forward's lse given; sdpa_bwd_ms: "
          "torch.autograd.grad through scaled_dot_product_attention, its forward "
          "outside, CUDA events around back-to-back calls; bound: five products "
          "at the bf16 tensor-core peak; split_floor_ms: "
          f"{BWD_SPLIT_PRODUCTS} products, P and dS as bf16 hi + lo; limit per "
          "element rtol|want| + floor rms(want), (rtol, floor) "
          f"{BACKWARD_TOL[torch.bfloat16]} bf16, {BACKWARD_TOL[torch.float32]} fp32)")
    rows = []
    for seed, (B, S, H, Hkv, hd, dtype) in enumerate((
        (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
         torch.bfloat16),
        (LM_BATCH, LM_PROMPT, nemo.n_heads, nemo.n_kv_heads, nemo.head_dim,
         torch.bfloat16),
        (LM_BATCH, 1000, nemo.n_heads, nemo.n_kv_heads, nemo.head_dim,
         torch.float32),
    )):
        row = bwd_case(B, S, H, Hkv, hd, dtype, 30 + seed)
        rows.append(row)
        print(f"[train] flash backward {B} {S} {H}/{Hkv} {hd} {row['dtype']} | "
              f"{row['ms']:.5f} {row['plain_ms']:.5f} {row['library_ms']:.5f} "
              f"{row['bound_ms']:.5f} {row['bound_by']} {row['split_floor_ms']:.5f} | "
              f"{row['max_abs_err']:.3g} {row['tol_ratio']:.3g}; bit-identical "
              "across launches")
    wkv_row, scan_row = phase_recurrent_kernels()
    cpu = train_card_vs_cpu(cfg, TRAIN_SEED + 1)
    rwkv_cpu = train_card_vs_cpu(load_config("rwkv6_7b"), TRAIN_SEED + 2)
    main = train_main_path(cfg)
    resume = train_resume()
    recurrent = {}
    for name, n_layers in RECURRENT_TRAIN:
        full = load_config(name)
        cut = dataclasses.replace(full, n_layers=n_layers)
        print(f"[train] {name}: depth cut to {n_layers} of {full.n_layers} layers at "
              f"full width ({cut.param_counts()['total'] / 1e9:.2f} of "
              f"{full.param_counts()['total'] / 1e9:.2f} B parameters by the "
              f"config's count); global batch {TRAIN_BATCH} x {TRAIN_SEQ}")
        recurrent[name] = train_main_path(cut, label="recurrent path")
    print(f"[train] phase: {time.perf_counter() - t0:.3f} s")
    return rows[0], dict(main, card_vs_cpu=cpu, resume=resume, forward_lse=fwd,
                         stablelm_forward=fw,
                         rwkv_card_vs_cpu=rwkv_cpu, recurrent=recurrent,
                         wkv_bwd_row=wkv_row, scan_bwd_row=scan_row)


# ---------------------------------------------------------------------------
# the pipeline executor: GPipe over torch.distributed, one stage per rank
# ---------------------------------------------------------------------------
#: StableLM-1.6B at full width and depth, 4 stages of 6 layers, every
#: rank a process on the one card
PIPELINE_MODEL, PIPELINE_STAGES, PIPELINE_MICRO, PIPELINE_SEED = "stablelm_1_6b", 4, 8, 7
#: NCCL takes one card per rank (it refuses two ranks on one card), so
#: the ranks sharing this card talk over gloo, each hop staged through
#: pinned host memory
PIPELINE_BACKEND = "gloo"
PIPELINE_TIMEOUT = 300.0


def phase_pipeline() -> dict:
    """`repro_torch.pipeline.executor` on the card: 4 spawned ranks, each
    building StableLM-1.6B from the seed and keeping its 6 layers; rank 0
    injects 8 microbatches of 2 x 2048 bf16 embeddings drawn from the
    seed. The pipelined output must equal rank 0's sequential
    `reference_backbone` bit for bit (the JAX package's test holds its
    executor to ``err == 0.0``), and each rank's measured pass must launch
    the flash kernel once per microbatch per attention layer it holds.
    Returns the phase's numbers and its flash launches."""
    t0 = time.perf_counter()
    cfg = load_config(PIPELINE_MODEL)
    case = BackboneCase(cfg, torch.bfloat16, PIPELINE_MICRO, LM_BATCH, LM_PROMPT,
                        PIPELINE_SEED)
    gc.collect()
    torch.cuda.empty_cache()  # the ranks' four contexts and models need the room
    print(f"[pipeline] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}; "
          f"{PIPELINE_STAGES} stage ranks of {cfg.n_layers // PIPELINE_STAGES} layers, "
          f"all on cuda:0 (this process holds {torch.cuda.memory_allocated() / 1e9:.3f} "
          f"GB allocated, {torch.cuda.memory_reserved() / 1e9:.3f} GB reserved); "
          f"{PIPELINE_MICRO} microbatches of {LM_BATCH} x {LM_PROMPT} bf16")
    _build.build()  # built in phase 1: the ranks only load the libraries
    reset_counts()
    ranks = [r[0] for r in launch(backbone_job, PIPELINE_STAGES,
                                  backend=PIPELINE_BACKEND, device="cuda",
                                  timeout=PIPELINE_TIMEOUT, args=([case],))]
    check(not any(counts().values()), "the parent launched no kernel")
    out, ref = ranks[-1]["out"], ranks[0]["ref"]
    check(tuple(out.shape) == (PIPELINE_MICRO, LM_BATCH, LM_PROMPT, cfg.d_model)
          and out.dtype == torch.bfloat16, f"pipelined output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out.float()).all()), "pipelined output finite")
    same = torch.equal(out, ref)
    diff = (out.float() - ref.float()).abs().max().item()
    print(f"[pipeline] pipelined output vs reference_backbone: "
          f"{'bit-identical' if same else 'DIFFERENT'} (max abs diff {diff:.3g})")
    check(same, "pipelined output bit-identical to reference_backbone")
    per = cfg.n_layers // PIPELINE_STAGES
    plan = cfg.layer_plan()
    for r in ranks:
        attn = sum(m == "attn" for m, _ in plan[r["stage"] * per:(r["stage"] + 1) * per])
        check(r["backend"] == PIPELINE_BACKEND, f"rank {r['stage']} backend {r['backend']}")
        check(r["flash_launches"] == PIPELINE_MICRO * attn,
              f"rank {r['stage']}: {r['flash_launches']} flash launches, want "
              f"{PIPELINE_MICRO * attn}")
    launches = sum(r["flash_launches"] for r in ranks)
    n_attn = sum(m == "attn" for m, _ in plan)
    check(ranks[0]["ref_flash_launches"] == launches == PIPELINE_MICRO * n_attn,
          f"sequential run launched {ranks[0]['ref_flash_launches']}, pipeline {launches}")
    card = card_line()
    for r in ranks:
        print(f"[pipeline] rank {r['stage']}: layers {r['stage'] * per}-"
              f"{(r['stage'] + 1) * per - 1}, {r['ms']:.3f} ms (host clock from the "
              f"barrier to its last output), peak {r['peak_bytes'] / 1e9:.3f} GB "
              f"allocated, {r['flash_launches']} flash launches, {r['hops']} hops "
              f"sent of {r['hop_bytes']} bytes over {r['backend']}")
    pipe_ms = max(r["ms"] for r in ranks)
    print(f"[pipeline] pipelined {pipe_ms:.3f} ms (the slowest rank), sequential "
          f"reference_backbone {ranks[0]['ref_ms']:.3f} ms on rank 0 alone, "
          f"{ranks[0]['ref_flash_launches']} flash launches; four ranks share one "
          f"card, so no speedup is expected; {card}")
    print(f"[pipeline] phase: {time.perf_counter() - t0:.3f} s")
    return {"launches": launches, "pipelined_ms": pipe_ms,
            "sequential_ms": ranks[0]["ref_ms"],
            "ranks": [{k: r[k] for k in ("stage", "ms", "peak_bytes", "flash_launches",
                                          "hops", "hop_bytes", "backend")}
                      for r in ranks]}


# ---------------------------------------------------------------------------
# the SPMD policy: the dry run, and Granite-MoE-3B through `lowerable`
# ---------------------------------------------------------------------------
#: the dry run's cells, each on the 16x16 production mesh of torch's fake
#: process group: a train step and an MoE prefill
SPMD_DRYRUN_CELLS = (("stablelm_1_6b", "train_4k"),
                     ("granite_moe_3b_a800m", "prefill_32k"))
SPMD_DRYRUN_TIMEOUT = 240.0
#: Granite-MoE-3B: 32 layers, d 1536, 24/8 heads, 40 experts padded to 48,
#: top 8; prefill at full depth, training at 8 layers (its 32 with fp32
#: AdamW moments and B 8 x 2048 activations would not leave room for the
#: NO_POLICY step held beside it)
SPMD_MODEL, SPMD_TRAIN_LAYERS, SPMD_SEED = "granite_moe_3b_a800m", 8, 11
SPMD_PREFILLS, SPMD_STEPS = 3, 4
#: the first step's loss against the NO_POLICY (dropless) step on the same
#: parameters and batch, capacity factor E / top_k (nothing drops): bf16
#: activations through other product groupings (an expert's C rows at
#: once vs its own rows), a mean over 16384 tokens; the loss is a mean,
#: so tighter than the logits' CARD_CPU_REL_L2
SPMD_LOSS_RTOL = 1e-2


def dryrun_records(cells, timeout=SPMD_DRYRUN_TIMEOUT) -> list[dict]:
    """`repro_torch.launch.dryrun.run_cell` of each (arch, shape) on the
    16x16 mesh, in a subprocess: the dry run's fake process group of 256
    ranks must not meet this process's groups."""
    script = ("import json, sys\n"
              "from repro_torch.launch import dryrun\n"
              "cells = json.loads(sys.argv[1])\n"
              "print(json.dumps([dryrun.run_cell(a, s, False) for a, s in cells]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", script, json.dumps(cells)],
                         capture_output=True, text=True, timeout=timeout, env=env,
                         cwd=ROOT)
    check(run.returncode == 0, f"dry run failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def one_rank_mesh(device="cuda"):
    """A 1 x 1 (data, model) mesh over a process group of this process
    alone (nccl on the card, gloo on the CPU), for the block."""
    backend = {"cpu": "gloo"}.get(torch.device(device).type, "nccl")
    with tempfile.TemporaryDirectory(prefix="spmd-") as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            yield make_dev_mesh(1, 1, device=device)
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def routed_slots():
    """(kept, offered) (token, expert) slots of every capacity-MoE call in
    the block: offered T x top_k a layer, kept those with a capacity
    slot. Reads each layer's count back to the host."""
    tally, route = [0, 0], L._route

    def counted(xg, router, k, cap, e_store):  # on local shards
        out = route(xg, router, k, cap, e_store)
        tally[0] += int((out[1] > 0).sum())
        tally[1] += xg.shape[0] * xg.shape[1] * k
        return out

    L._route = counted
    try:
        yield tally
    finally:
        L._route = route


def spmd_inputs(cfg, case, seed, device="cuda") -> dict:
    """Tokens, labels and an all-ones mask drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (case.global_batch, case.seq_len)
    batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen,
                                     device=device, dtype=torch.int32)}
    if case.kind == "train":
        batch["labels"] = torch.randint(0, cfg.vocab, shape, generator=gen,
                                        device=device, dtype=torch.int32)
        batch["mask"] = torch.ones(shape, device=device)
    return batch


def spmd_model(cfg, case, mesh, seed, device="cuda"):
    """`lowerable`'s step with parameters from ``seed`` (and, for a train
    step, fresh AdamW moments) and a batch, all distributed at its
    in-shardings; returns (fn, args)."""
    fn, _ = lowerable(cfg, case, mesh)
    params = lm.init_params(torch.Generator(device=device).manual_seed(seed), cfg,
                            device=device)
    args = [distribute_tree(mesh, params, fn.in_shardings[0])]
    if case.kind == "train":
        args.append(distribute_tree(mesh, adamw_init(params), fn.in_shardings[1]))
    del params
    batch = spmd_inputs(cfg, case, seed + 1, device)
    args.append(distribute_tree(mesh, batch, fn.in_shardings[-1]))
    return fn, args


def local(tree):
    """The local tensors of a tree of DTensors (on a 1 x 1 mesh, the
    whole tensors)."""
    return tree_map(lambda t: t.to_local(), tree)


def spmd_prefill_gate(cfg, case, mesh, seed, device="cuda") -> dict:
    """Granite at capacity factor E / top_k (nothing drops) through
    `lowerable` against the NO_POLICY prefill (the dropless MoE) on the
    same parameters and tokens: last-token logits' relative L2."""
    fn, (params, batch) = spmd_model(cfg, case, mesh, seed, device)
    with routed_slots() as slots:
        got = fn(params, batch)[0].to_local()
    L.moe_dropless.host_reads = 0
    want = make_prefill_step(cfg, case.seq_len)(local(params), local(batch))[0]
    return {"rel_l2": _rel_l2(got, want), "kept": slots[0], "offered": slots[1],
            "dropless_host_reads": L.moe_dropless.host_reads,
            "finite": bool(torch.isfinite(got).all())}


def spmd_train_gate(cfg, case, mesh, seed, device="cuda") -> dict:
    """The first `lowerable` train step's loss at capacity factor E /
    top_k against the NO_POLICY step (dropless) on the same parameters,
    moments and batch, with the same micro-batches."""
    fn, (params, opt, batch) = spmd_model(cfg, case, mesh, seed, device)
    got = fn(params, opt, batch)[2]["loss"].to_local().item()
    step = make_train_step(cfg, AdamWConfig(),
                           micro_batches=auto_micro_batches(cfg, case, mesh))
    want = step(local(params), local(opt), local(batch))[2]["loss"].item()
    return {"loss": got, "dropless_loss": want, "rel": abs(got - want) / abs(want)}


def phase_spmd() -> dict:
    """The dry run's records; Granite-MoE-3B's prefill at full width and
    depth and its train step at 8 layers through `lowerable` on a 1 x 1
    mesh under the SPMD policy (the capacity MoE, flash on local shards),
    each held to the NO_POLICY path at a capacity where nothing drops.
    Returns the phase's numbers and its flash launches."""
    t0 = time.perf_counter()
    card = card_line()
    recs = dryrun_records(SPMD_DRYRUN_CELLS)
    for rec in recs:
        check(rec["status"] == "OK", f"dry run {rec}")
        check(rec["flops"] > 0 and rec["collective_bytes"]["count"] > 0,
              f"dry run {rec['arch']} {rec['shape']}: counted nothing")
        print(f"[spmd] dry run {rec['arch']} x {rec['shape']} on {rec['mesh']} "
              f"(fake process group, rank 0): {dryrun_summary(rec)}; analytic model "
              f"flops {rec['analytic']['model_flops']:.4e}, roofline at "
              f"{roofline.PEAK_FLOPS:.3g} FLOP/s, {roofline.HBM_BW:.3g} B/s, "
              f"{roofline.ICI_BW:.3g} B/s (the card's peaks, not measured here)")
    t_dry = time.perf_counter() - t0
    cfg = load_config(SPMD_MODEL)
    generous = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    prefill = ShapeCase("prefill", LM_PROMPT, LM_BATCH, "prefill")
    cfg8 = dataclasses.replace(cfg, n_layers=SPMD_TRAIN_LAYERS)
    train = ShapeCase("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan, plan8 = cfg.layer_plan(), cfg8.layer_plan()
    n_attn = sum(m == "attn" for m, _ in plan)
    n_attn8 = sum(m == "attn" for m, _ in plan8)
    with one_rank_mesh() as mesh:
        gate = spmd_prefill_gate(generous, prefill, mesh, SPMD_SEED)
        check(gate["finite"] and gate["rel_l2"] <= CARD_CPU_REL_L2,
              f"spmd prefill at capacity factor {generous.capacity_factor}: logits "
              f"vs dropless rel L2 {gate['rel_l2']:.3g} (<= {CARD_CPU_REL_L2})")
        check(gate["kept"] == gate["offered"], f"generous capacity dropped {gate}")
        gc.collect()
        torch.cuda.empty_cache()
        fn, (params, batch) = spmd_model(cfg, prefill, mesh, SPMD_SEED)
        fn(params, batch)  # warm-up
        with routed_slots() as slots:
            logits, _ = fn(params, batch)
        check(bool(torch.isfinite(logits.to_local()).all()), "spmd logits finite")
        torch.cuda.synchronize()
        reset_counts()  # the path starts here
        L.moe_dropless.host_reads = 0
        marks = []
        for _ in range(SPMD_PREFILLS):
            t = time.perf_counter()
            out = fn(params, batch)
            torch.cuda.synchronize()
            marks.append(time.perf_counter() - t)
        prefill_launches = counts()
        host_reads = L.moe_dropless.host_reads
        check(tuple(out[0].shape) == (LM_BATCH, cfg.vocab), "spmd logits shape")
        check(prefill_launches["flash_attention"] == SPMD_PREFILLS * n_attn,
              f"spmd prefill flash launches {prefill_launches}, want {n_attn} each")
        check(host_reads == 0, f"capacity MoE read {host_reads} times to the host")
        ms_prefill = sum(marks) / len(marks) * 1e3
        dropped = 1 - slots[0] / slots[1]
        del fn, params, batch, out, logits
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[spmd] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
              f"(banks {cfg.expert_pad_to}), top {cfg.top_k}, bf16, `lowerable` "
              f"prefill B {LM_BATCH} x {LM_PROMPT} on a 1 x 1 mesh: "
              f"{ms_prefill:.3f} ms per prefill (host clock to the sync, "
              f"{SPMD_PREFILLS} after a warm-up: {[round(m * 1e3, 3) for m in marks]}); "
              f"flash launches {prefill_launches['flash_attention'] // SPMD_PREFILLS} "
              f"a prefill; MoE host reads {host_reads}; at capacity factor "
              f"{cfg.capacity_factor} {dropped * 100:.3f}% of (token, expert) slots "
              f"dropped ({slots[1] - slots[0]} of {slots[1]}); at {generous.capacity_factor:g}"
              f" the last-token logits vs the NO_POLICY dropless prefill rel L2 "
              f"{gate['rel_l2']:.4g} (<= {CARD_CPU_REL_L2}; the dropless MoE read "
              f"{gate['dropless_host_reads']} times); {card}")
        tgate = spmd_train_gate(dataclasses.replace(generous, n_layers=SPMD_TRAIN_LAYERS),
                                train, mesh, SPMD_SEED + 2)
        check(tgate["rel"] <= SPMD_LOSS_RTOL,
              f"spmd train loss {tgate['loss']} vs dropless {tgate['dropless_loss']}")
        gc.collect()
        torch.cuda.empty_cache()
        fn, (params, opt, batch) = spmd_model(cfg8, train, mesh, SPMD_SEED + 2)
        micro = auto_micro_batches(cfg8, train, mesh)
        torch.cuda.reset_peak_memory_stats()
        losses, marks = [], []
        for i in range(1 + SPMD_STEPS):
            if i == 1:
                reset_counts()  # the path starts after the warm-up
            t = time.perf_counter()
            params, opt, metrics = fn(params, opt, batch)
            losses.append(metrics["loss"].to_local().item())
            marks.append(time.perf_counter() - t)
        train_launches = dict(counts(),
                              flash_attention_backward=flash_attention_backward_call.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del fn, params, opt, batch, metrics
    check(all(math.isfinite(x) for x in losses), f"spmd train losses {losses}")
    want_fwd, want_bwd = 2 * n_attn8 * micro, n_attn8 * micro
    check(train_launches["flash_attention"] == SPMD_STEPS * want_fwd
          and train_launches["flash_attention_backward"] == SPMD_STEPS * want_bwd,
          f"spmd train launches {train_launches}, want {want_fwd} / {want_bwd} a step")
    ms_step = sum(marks[1:]) / SPMD_STEPS * 1e3
    model_flops = roofline.analytic_cost(cfg8, train).model_flops
    rate = model_flops / (ms_step / 1e3)
    print(f"[spmd] {cfg8.name} at {SPMD_TRAIN_LAYERS} layers: `lowerable` train step B "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} ({micro} micro-batches, remat), bf16 "
          f"parameters, fp32 AdamW moments: {ms_step:.3f} ms per step (host clock to "
          f"the loss read back, {SPMD_STEPS} after a warm-up: "
          f"{[round(m * 1e3, 3) for m in marks[1:]]}), "
          f"{TRAIN_BATCH * TRAIN_SEQ / (ms_step / 1e3):.1f} tokens/s, card peak "
          f"memory {peak_gb:.3f} GB; flash launches a step "
          f"{train_launches['flash_attention'] // SPMD_STEPS} forward, "
          f"{train_launches['flash_attention_backward'] // SPMD_STEPS} backward; losses "
          f"{[round(x, 4) for x in losses]}; model FLOP rate {rate / 1e12:.3f} TFLOP/s "
          f"({model_flops:.4e} model flops a step, analytic_cost), "
          f"{rate / roofline.PEAK_FLOPS * 100:.2f}% of {roofline.PEAK_FLOPS / 1e12:g} "
          f"TFLOP/s; first step at capacity factor {generous.capacity_factor:g}: loss "
          f"{tgate['loss']:.6f} vs the NO_POLICY dropless step's "
          f"{tgate['dropless_loss']:.6f}, rel {tgate['rel']:.3g} (<= {SPMD_LOSS_RTOL}); "
          f"{card}")
    secs = time.perf_counter() - t0
    print(f"[spmd] phase: {secs:.3f} s (the dry run {t_dry:.3f} s)")
    launches = (prefill_launches["flash_attention"]
                + train_launches["flash_attention"])
    return {"launches": launches,
            "backward_launches": train_launches["flash_attention_backward"],
            "prefill_ms": ms_prefill, "prefill_flash": n_attn, "dropped": dropped,
            "gate_rel_l2": gate["rel_l2"], "train_ms": ms_step, "peak_gb": peak_gb,
            "model_flop_rate": rate, "loss_rel": tgate["rel"], "seconds": secs,
            "dryrun": recs}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


#: each kernel's card time at the same shape before this version, copied
#: from PERF.md §6 (H100 80GB HBM3, 700 W) and printed as a text line
#: beside this run's readings; never part of the ``kernels`` line
PREVIOUS_MS = {
    "preemptible_matmul_window": (0.08465, "the fp32-FMA kernel, PR 14"),
    "flash_attention": (2.56539, "the fp32-FMA kernel, PR 13"),
    "rwkv6_scan": (0.71597, "the step kernel before its TMA redesign"),
    "mamba_scan": (0.47799, "the one-channel-per-thread kernel before its redesign"),
    "flash_attention_backward": (22.83953, "the SIMT fp32-FMA kernel of PR 24"),
    "rwkv6_scan_backward": (5.79748, "the first 4-warp sweep-and-reverse kernel"),
    "mamba_scan_backward": (5.31701, "the first kernel: 16-step stash, p in shared memory"),
}


def kernel_entry(name, source, replaces, mma, launches, row) -> dict:
    """One entry of the ``kernels`` line; ``mma`` names the units that do
    its products ("wgmma" or "mma.sync" on the tensor cores, "fma" on the
    CUDA cores)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "mma": mma, "launches": launches,
            **{k: row[k] for k in keys}}


def previous_line(entries) -> str:
    """A text line (not JSON) with each kernel's time in this run beside
    its earlier time as copied from PERF.md (``PREVIOUS_MS``)."""
    parts = []
    for e in entries:
        if e["name"] not in PREVIOUS_MS:  # its first version
            parts.append(f"{e['name']} {e['ms']:.5f} ms now, no earlier time")
            continue
        prev_ms, prev_from = PREVIOUS_MS[e["name"]]
        parts.append(f"{e['name']} {e['ms']:.5f} ms now, {prev_ms} ms before "
                     f"({prev_from})")
    return "[previous] copied from PERF.md §6, not measured here: " + "; ".join(parts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(f"[card] {card_line()}")  # every number below was taken on it
    phase_build()
    rows, head = phase_kernel()
    launches = phase_serve()
    phase_wall()
    gateway = phase_gateway()
    sharded = phase_sharded()
    conf = phase_conformance(gateway.pop("built"))
    flash_row, wkv_row, scan_row = phase_lm_kernels()
    lm_runs = {name: phase_lm(name, seed=100 + i, n_layers=n, kv_quant=q)
               for i, (name, n, q) in enumerate(LM_MODELS)}
    bwd_row, train = phase_train()
    pipeline = phase_pipeline()
    spmd = phase_spmd()
    pmm = kernel_entry(
        "preemptible_matmul_window", "src/repro_torch/csrc/preemptible_matmul.cu",
        "src/repro/kernels/preemptible_matmul/kernel.py:36", "mma.sync",
        launches + gateway["launches"] + sharded + conf["launches"],
        dict(head, max_abs_err=max(
            r["max_abs_err"] for r in rows if r["dtype"] == "float32")),
    )
    pmm.update(launches_by_path={"serve": launches, "gateway": gateway["launches"],
                                 "sharded": sharded, "conformance": conf["launches"]},
               launch_ms=head["launch_ms"],
               fp32_fma_bound_ms=head["fp32_fma_bound_ms"],
               shape={k: head[k] for k in ("M", "K", "N", "window", "dtype")})
    flash = kernel_entry(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:32", "wgmma",
        lm_runs["mistral_nemo_12b"]["launches"]["flash_attention"]
        + pipeline["launches"] + spmd["launches"], flash_row,
    )
    flash.update(launches_by_path={
                     "lm": lm_runs["mistral_nemo_12b"]["launches"]["flash_attention"],
                     "pipeline": pipeline["launches"], "spmd": spmd["launches"]},
                 split_floor_ms=flash_row["split_floor_ms"],
                 shape={k: flash_row[k] for k in ("B", "S", "H", "Hkv", "hd", "dtype")})
    wkv = kernel_entry(
        "rwkv6_scan", "src/repro_torch/csrc/rwkv6_scan.cu",
        "src/repro/kernels/rwkv6_scan/kernel.py:29", "fma",
        lm_runs["rwkv6_7b"]["launches"]["rwkv6_scan"], wkv_row,
    )
    wkv["shape"] = {k: wkv_row[k] for k in ("B", "S", "H", "hd", "dtype")}
    scan = kernel_entry(
        "mamba_scan", "src/repro_torch/csrc/mamba_scan.cu",
        "src/repro/kernels/mamba_scan/kernel.py:27", "fma",
        lm_runs["jamba_v0_1_52b"]["launches"]["mamba_scan"], scan_row,
    )
    scan["shape"] = {k: scan_row[k] for k in ("B", "S", "di", "ns", "dtype")}
    bwd = kernel_entry(
        "flash_attention_backward", "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/models/layers.py:140", "wgmma",
        train["launches"]["flash_attention_backward"] + spmd["backward_launches"],
        bwd_row,
    )
    bwd.update(launches_by_path={
                   "train": train["launches"]["flash_attention_backward"],
                   "spmd": spmd["backward_launches"]},
               split_floor_ms=bwd_row["split_floor_ms"],
               shape={k: bwd_row[k] for k in ("B", "S", "H", "Hkv", "hd", "dtype")})
    rwkv_train = train["recurrent"]["rwkv6_7b"]["launches"]
    jamba_train = train["recurrent"]["jamba_v0_1_52b"]["launches"]
    wkv_bwd = kernel_entry(
        "rwkv6_scan_backward", "src/repro_torch/csrc/rwkv6_scan_bwd.cu",
        "src/repro/models/rwkv.py:109", "fma",
        rwkv_train["rwkv6_scan_backward"], train["wkv_bwd_row"],
    )
    wkv_bwd["shape"] = {k: train["wkv_bwd_row"][k] for k in ("B", "S", "H", "hd", "dtype")}
    scan_bwd = kernel_entry(
        "mamba_scan_backward", "src/repro_torch/csrc/mamba_scan_bwd.cu",
        "src/repro/models/ssm.py:99", "fma",
        jamba_train["mamba_scan_backward"], train["scan_bwd_row"],
    )
    scan_bwd["shape"] = {k: train["scan_bwd_row"][k]
                         for k in ("B", "S", "di", "ns", "dtype")}
    entries = [pmm, flash, wkv, scan, bwd, wkv_bwd, scan_bwd]
    print(previous_line(entries))
    print(json.dumps({"conformance": conf}))
    print(json.dumps({"kernels": entries}))
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
