"""GPipe pipeline executor over ``torch.distributed``: the PHAROS chained
topology with one stage per rank (the counterpart of
``repro.pipeline.executor``).

The paper's spatial architecture — M accelerators, each owning a
consecutive layer segment, jobs streaming through FIFO links — maps to
a 1-D ``stage`` device mesh, one process (rank) per stage:

- stage k holds layers ``[k*L/M, (k+1)*L/M)`` of the per-layer
  ``params["blocks"]`` (`split_blocks_for_stages`);
- activations advance stage -> stage by point-to-point send and receive
  (the JAX package's ``lax.ppermute``; the HLS stream of paper Fig. 2);
- microbatches play the role of jobs: rank 0 injects them in order, and
  after the M-1 microbatches of the fill every stage works on a
  different microbatch at the same time, each in its own process — the
  paper's pipelined execution model (one job per accelerator, §3.3).

GPipe schedule: each rank runs its segment once per microbatch, in
order, and the last stage's output for microbatch i is the backbone's
output i. The JAX package's SPMD scan instead runs ``n_micro + M - 1``
ticks on every stage and throws away what a stage computes in the fill
and drain ticks (its zero buffer, or the last microbatch again); the
outputs are the same either way. The executor covers the backbone
(B, S, d) -> (B, S, d); embed and head run outside (they belong to the
first and last stage in a deployment and are not part of the block
stack).

Equal segments are required (``n_repeats % n_stages == 0``): the
asymmetric designs from the DSE run through the host runtime
(`pipeline.serve`) and the DES.

Transport: the backend is the caller's, and it is never switched.
NCCL sends card tensors and takes one card per rank. gloo sends host
tensors, so on a card each hop is staged through a pinned host buffer
(card -> host, send; receive, host -> card); the compute stays on the
card. Several ranks may share one card that way.

`launch` spawns one process per stage, joins them into a process group
and runs a job on each; `backbone_job` is the job that builds a model's
parameters from a seed, runs the pipelined backbone and, on rank 0, the
sequential `reference_backbone`.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.kernel import flash_attention_call
from repro_torch.models import lm
from repro_torch.tree import flatten

STAGE_AXIS = "stage"


def make_stage_mesh(n_stages: int, *, device="cuda"):
    """A 1-D mesh with dim name ``"stage"`` over the default process
    group's first ``n_stages`` ranks, for tensors on ``device``'s type."""
    return init_device_mesh(torch.device(device).type, (n_stages,),
                            mesh_dim_names=(STAGE_AXIS,))


def _segment_apply(cfg: ArchConfig, kinds, blocks, x, positions):
    """Run this stage's layers in order."""
    for kind, blk in zip(kinds, blocks):
        x = lm._apply_block(kind, blk["mixer"], blk["ffn"], x, cfg, positions)
    return x


class _Link:
    """One rank's end of the hops to and from its neighbours: tensors of
    one shape and dtype, sent as they are, or staged through a pinned
    host buffer where the backend (gloo) takes only host tensors."""

    def __init__(self, shape, dtype, device, group):
        self.shape, self.dtype, self.device, self.group = shape, dtype, device, group
        self.host = None
        if device.type != "cpu" and dist.get_backend(group) == "gloo":
            self.host = torch.empty(shape, dtype=dtype, pin_memory=True)

    def send(self, y, dst: int) -> None:
        if self.host is None:
            dist.send(y.contiguous(), dst, group=self.group)
        else:
            self.host.copy_(y)  # waits for the card
            dist.send(self.host, dst, group=self.group)

    def recv(self, src: int):
        if self.host is None:
            x = torch.empty(self.shape, dtype=self.dtype, device=self.device)
            dist.recv(x, src, group=self.group)
            return x
        dist.recv(self.host, src, group=self.group)
        return self.host.to(self.device)  # a synchronous copy: the buffer is free again


def _stage_ranks(mesh) -> tuple[list[int], int]:
    """The stage dim's global ranks, and this rank's stage."""
    ranks = mesh.mesh.flatten().tolist()
    return ranks, ranks.index(dist.get_rank())


def pipeline_backbone(cfg: ArchConfig, mesh, n_stages: int):
    """Build ``fn(stage_blocks, microbatches) -> outputs`` for this rank.

    ``stage_blocks``: this rank's layers,
    ``split_blocks_for_stages(params, n_stages)[stage]``.
    ``microbatches``: (n_micro, B_mb, S, d) embedded inputs on rank 0;
    the other ranks read only its shape and dtype (a tensor on the
    ``meta`` device will do).
    Returns (n_micro, B_mb, S, d), the backbone output per microbatch,
    on the last stage, and None on the others.
    """
    if cfg.n_repeats % n_stages:
        raise ValueError(
            f"n_repeats={cfg.n_repeats} not divisible by stages={n_stages}"
        )
    if mesh.mesh_dim_names != (STAGE_AXIS,) or mesh.size() != n_stages:
        raise ValueError(f"need a 1-D {STAGE_AXIS!r} mesh of {n_stages} ranks, "
                         f"got {mesh}")
    ranks, stage = _stage_ranks(mesh)
    group = mesh.get_group(STAGE_AXIS)
    per = cfg.n_layers // n_stages
    kinds = cfg.layer_plan()[stage * per:(stage + 1) * per]
    last = stage == n_stages - 1

    @torch.inference_mode()
    def run(stage_blocks, micro):
        if len(stage_blocks) != per:
            raise ValueError(f"stage {stage} holds {per} layers, "
                             f"got {len(stage_blocks)}")
        n_micro, B, S, d = micro.shape
        device = flatten(stage_blocks)[0][0].device
        if device.type != mesh.device_type:
            raise ValueError(f"parameters on {device}, mesh on {mesh.device_type}")
        if stage == 0 and micro.device != device:
            raise ValueError(f"microbatches on {micro.device}, parameters on {device}")
        link = _Link((B, S, d), micro.dtype, device, group)
        outs = []
        for i in range(n_micro):
            x = micro[i] if stage == 0 else link.recv(ranks[stage - 1])
            y = _segment_apply(cfg, kinds, stage_blocks, x, lm._positions(x))
            if last:
                outs.append(y)
            else:
                link.send(y, ranks[stage + 1])
        return torch.stack(outs) if last else None

    return run


def split_blocks_for_stages(params, n_stages: int):
    """The per-layer block list cut into ``n_stages`` consecutive runs of
    equal length: entry k is stage k's layers, the paper's
    consecutive-layer mapping. (The JAX package's version is the
    identity: its stacked repeats axis, sharded over ``stage``, does the
    cutting.)"""
    blocks = params["blocks"]
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} layers not divisible by stages={n_stages}")
    per = len(blocks) // n_stages
    return [blocks[k * per:(k + 1) * per] for k in range(n_stages)]


@torch.inference_mode()
def reference_backbone(cfg: ArchConfig, params, micro):
    """Non-pipelined oracle: every microbatch through all layers in one
    process, positions ``arange(S)``. Returns (n_micro, B, S, d)."""
    outs = []
    for x in micro:
        outs.append(_segment_apply(cfg, cfg.layer_plan(), params["blocks"], x,
                                   lm._positions(x)))
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# ranks: one process per stage
# ---------------------------------------------------------------------------
def _rank_main(rank, n_stages, backend, device, tmp, timeout, job, args):
    """One rank: join the process group, build the stage mesh, run
    ``job(mesh, *args)`` and save what it returns for `launch`; a failure
    leaves its traceback there and exits non-zero."""
    # one intra-op thread: the ranks share the host's cores, and a rank on
    # the CPU then does the arithmetic of a one-thread process
    torch.set_num_threads(1)
    # every rank runs on this host: gloo's pairs go over the loopback
    # device, whatever the host's name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=n_stages, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
        )
        result = job(make_stage_mesh(n_stages, device=device), *args)
        torch.save(result, os.path.join(tmp, f"result-{rank}.pt"))
    except BaseException:
        # rtlint: disable=clock-domain -- orders the ranks' failures on the host
        failed_at = time.time_ns()
        with open(os.path.join(tmp, f"error-{rank}.txt"), "w") as f:
            f.write(f"{failed_at}\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _failures(tmp, n_stages: int, rank: int, exitcode: int) -> str:
    """The tracebacks the failed ranks left, the first to fail first (a
    rank's failure often makes its neighbours' sends and receives fail
    after it)."""
    found = []
    for r in range(n_stages):
        path = os.path.join(tmp, f"error-{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                failed_at, said = f.read().split("\n", 1)
            found.append((int(failed_at), f"rank {r} of {n_stages} failed:\n{said}"))
    if not found:
        return f"rank {rank} of {n_stages} exited with code {exitcode}, no traceback"
    return "\n".join(said for _, said in sorted(found))


def launch(job, n_stages: int, *, backend: str, device="cuda",
           timeout: float = 600.0, args=()) -> list:
    """Run ``job(mesh, *args)`` on ``n_stages`` ranks, one spawned process
    each, joined into a ``backend`` process group (``"gloo"`` or
    ``"nccl"``) through a ``file://`` rendezvous in a fresh temporary
    directory; ``mesh`` is the rank's `make_stage_mesh`. ``job`` must be
    importable by name (a module-level function) and return what
    ``torch.save`` takes. Returns the ranks' results in rank order.

    Raises with the rank's traceback as soon as any rank fails, and
    ``TimeoutError`` if the ranks are not all done within ``timeout``
    seconds (also each collective's limit); either way the other ranks
    are killed. NCCL takes one card per rank, so it raises when fewer
    cards than stages are visible.
    """
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError(f"nccl sends card tensors; device is {device}")
        if torch.cuda.device_count() < n_stages:
            raise ValueError(
                f"nccl takes one card per rank: {n_stages} stages, "
                f"{torch.cuda.device_count()} card(s) visible; use gloo")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pipeline-") as tmp:
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(rank, n_stages, backend, device, tmp, timeout, job,
                              tuple(args)))
            for rank in range(n_stages)
        ]
        # rtlint: disable=clock-domain -- the join's own deadline on the host
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            running = list(procs)
            while running:
                # rtlint: disable=clock-domain -- the join's own deadline on the host
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {[procs.index(p) for p in running]} still running "
                        f"after {timeout} s")
                wait([p.sentinel for p in running], timeout=left)
                for p in [p for p in running if not p.is_alive()]:
                    p.join()
                    running.remove(p)
                    if p.exitcode != 0:
                        raise RuntimeError(_failures(tmp, n_stages, procs.index(p),
                                                     p.exitcode))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"result-{rank}.pt"), weights_only=False)
                for rank in range(n_stages)]


# ---------------------------------------------------------------------------
# the backbone job: parameters from a seed, pipelined vs sequential
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BackboneCase:
    """One pipelined run: ``cfg`` at ``dtype``, parameters from
    ``lm.init_params`` on a generator seeded with ``seed``, and
    ``n_micro`` microbatches of (batch, seq, d_model) standard normals
    drawn in fp32 from ``seed + 1`` and cast to ``dtype``."""

    cfg: ArchConfig
    dtype: torch.dtype
    n_micro: int
    batch: int
    seq: int
    seed: int

    def micro(self, device):
        gen = torch.Generator(device=device).manual_seed(self.seed + 1)
        shape = (self.n_micro, self.batch, self.seq, self.cfg.d_model)
        return torch.randn(shape, generator=gen, device=device).to(self.dtype)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _backbone_case(mesh, case: BackboneCase) -> dict:
    cfg, n_stages = case.cfg, mesh.size()
    ranks, stage = _stage_ranks(mesh)
    group = mesh.get_group(STAGE_AXIS)
    device = torch.device(mesh.device_type)
    gen = torch.Generator(device=device).manual_seed(case.seed)
    params = lm.init_params(gen, cfg, case.dtype, device=device)
    blocks = split_blocks_for_stages(params, n_stages)[stage]
    shape = (case.n_micro, case.batch, case.seq, cfg.d_model)
    if stage == 0:
        micro = case.micro(device)
    else:
        micro = torch.empty(shape, dtype=case.dtype, device="meta")
        del params  # keep only this stage's layers
    run = pipeline_backbone(cfg, mesh, n_stages)
    run(blocks, micro)  # first calls: kernel libraries, library handles
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    flash_attention_call.launches = 0
    _sync(device)
    dist.barrier(group=group)
    # rtlint: disable=clock-domain -- measures the run on the host clock
    t0 = time.perf_counter()
    out = run(blocks, micro)
    _sync(device)
    # rtlint: disable=clock-domain -- measures the run on the host clock
    seconds = time.perf_counter() - t0
    res = {
        "stage": stage, "layers": len(blocks), "ms": seconds * 1e3,
        "flash_launches": flash_attention_call.launches,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "backend": str(dist.get_backend(group)),
        "hop_bytes": case.batch * case.seq * cfg.d_model * micro.element_size(),
        "hops": case.n_micro if stage < n_stages - 1 else 0,
    }
    if out is not None:
        res["out"] = out.cpu()
    dist.barrier(group=group)  # the sequential run below has the card alone
    if stage == 0:
        flash_attention_call.launches = 0
        _sync(device)
        # rtlint: disable=clock-domain -- measures the run on the host clock
        t0 = time.perf_counter()
        ref = reference_backbone(cfg, params, micro)
        _sync(device)
        # rtlint: disable=clock-domain -- measures the run on the host clock
        res["ref_ms"] = (time.perf_counter() - t0) * 1e3
        res["ref_flash_launches"] = flash_attention_call.launches
        res["ref"] = ref.cpu()
    dist.barrier(group=group)
    return res


def backbone_job(mesh, cases) -> list[dict]:
    """A rank's part of each `BackboneCase`, in turn. Every rank builds
    the whole model from the seed and keeps its stage's layers (rank 0
    keeps all); rank 0 draws the microbatches. A warm pass, then the
    measured pass: its host-clock milliseconds from a barrier to the
    rank's last output (``ms``), the flash-attention kernel's launches in
    it (``flash_launches``, counted only on a card) and, on a card, the
    peak memory allocated (``peak_bytes``, parameters included), the
    backend and the bytes of one hop. The last stage returns the
    pipelined output (``out``, on the host). Then, with the other ranks
    waiting, rank 0 runs `reference_backbone` on the same parameters and
    microbatches (``ref``, ``ref_ms``, ``ref_flash_launches``)."""
    return [_backbone_case(mesh, case) for case in cases]
