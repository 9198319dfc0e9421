"""DSE -> SPMD pipeline: PHAROS partitioning for an assigned LM arch.

1. Extract minitron-4b's layer chain (the PHAROS task view of an LM),
2. run the SRT-guided DSE for a 2-task serving mix (prefill task +
   decode task with different periods) on a 16-chip slice via the
   unified `explore` driver (batched evaluator; the TG configuration
   is shown alongside for contrast),
3. show the chosen stage partition + per-stage utilizations,
4. provision a registry scenario straight from the DSE (`provision`:
   design -> shard plan -> per-shard Eq. 3 contracts + headroom),
5. run the *equal-stage* variant on the pipeline executor (4 stage
   ranks, one process each, joined over gloo; point-to-point sends
   between neighbouring stages) and validate it against the
   sequential backbone.

Run: ``PYTHONPATH=src python -m repro_torch.examples.dse_pipeline``
(``--device cpu`` runs step 5's ranks on the CPU with the kernels' plain
versions; the default, ``cuda``, puts all four ranks on the one card,
each launching the hand-written flash-attention kernel).
"""
import argparse
import dataclasses

import torch

from repro_torch import _build
from repro_torch.configs import load_config
from repro_torch.core.dse import DSEConfig, explore, provision
from repro_torch.core.dse.space import evaluate_design
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.core.rt.schedulability import stage_utilizations
from repro_torch.core.rt.task import Task, TaskSet
from repro_torch.models.extract import arch_workload
from repro_torch.pipeline.executor import BackboneCase, backbone_job, launch

#: step 5's pipeline: stage ranks and microbatches of (batch, seq)
STAGES, N_MICRO, MICRO_BATCH, MICRO_SEQ = 4, 8, 2, 32


def plan(cfg=None, *, device="cuda"):
    """Steps 1-4: prints them; returns the DSE's best design, or None
    when no design is feasible at these periods. The provisioned
    gateway's servers hold their weights on ``device``."""
    cfg = cfg if cfg is not None else load_config("minitron_4b")
    platform = paper_platform(16)

    # -- PHAROS task view of the LM: prefill + decode tenants ---------
    wl_prefill = arch_workload(cfg, batch=1, seq=2048, mode="prefill")
    wl_decode = arch_workload(cfg, batch=32, seq=2048, mode="decode")
    print(f"{cfg.name}: prefill chain {wl_prefill.num_layers} layers, "
          f"decode chain {wl_decode.num_layers} layers")

    # periods: prefill every 60ms, decode step budget 15ms
    ts = TaskSet(tasks=(
        Task(workload=wl_prefill, period=0.060, name="prefill"),
        Task(workload=wl_decode, period=0.015, name="decode"),
    ))
    # two ~160-layer flattened chains: a layer-granular split grid has
    # ~26k slice pairs per chip budget, so coarsen the boundaries to
    # every 8 layers (the DSE still prices every layer exactly)
    res = explore([wl_prefill, wl_decode], ts, platform,
                  method="beam", max_m=4, beam_width=8, split_stride=8)
    if res.best is None:
        print("no feasible design at these periods; relax and retry")
        return None
    best = res.best
    table = evaluate_design(best.accs, best.splits,
                            [wl_prefill, wl_decode], ts)
    print(f"best: {best.n_stages} stages chips={[a.chips for a in best.accs]} "
          f"max_util={best.max_util:.3f} "
          f"({res.stats.candidates_per_sec:,.0f} candidates/s batched)")
    print("stage utilizations:",
          [f"{u:.3f}" for u in stage_utilizations(table, ts, False)])
    print("layer split (prefill):",
          [best.splits[k][0] for k in range(best.n_stages)])
    tg = explore([wl_prefill, wl_decode], ts, platform, method="tg")
    print(f"TG baseline (same driver, throughput objective): "
          f"max_util={tg.tg.max_util:.3f} eq2_feasible={tg.tg_eq2_feasible}")

    # -- DSE -> serving: provision a registry scenario ----------------
    prov = provision("steady_city", platform,
                     cfg=DSEConfig(method="beam", max_m=3, beam_width=4),
                     shards=2, placement="least_loaded")
    gw = prov.sharded_gateway(device=device)
    gw.open()
    print(f"\nprovisioned steady_city across K={prov.n_shards} shards "
          f"({prov.placement}): assignment={prov.plan.assignment}, "
          f"admission verified={gw.verify()}")
    for hr in gw.headroom():
        print(f"  shard {hr.shard}: tenants={list(hr.tenants)} "
              f"slacks={[f'{s:.2f}' for s in hr.stage_slacks]}")
    return best


def pipeline_case(cfg=None) -> BackboneCase:
    """Step 5's model and inputs: minitron-4b cut to 4 layers of width
    128 (4 heads of 32), bf16, parameters from seed 0, 8 microbatches
    of 2 x 32 from seed 1."""
    cfg = cfg if cfg is not None else load_config("minitron_4b")
    small = dataclasses.replace(
        cfg, name="minitron-pipe", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=1024,
    )
    return BackboneCase(small, torch.bfloat16, N_MICRO, MICRO_BATCH, MICRO_SEQ,
                        seed=0)


def run_pipeline(case: BackboneCase, *, device="cuda", timeout=300.0):
    """Step 5: the case on `STAGES` gloo ranks on ``device``; prints the
    max error against rank 0's sequential `reference_backbone`. Returns
    (error, the ranks' results in rank order)."""
    if torch.device(device).type == "cuda":
        _build.build(["flash_attention"])  # the ranks only load the library
    ranks = [r[0] for r in launch(backbone_job, STAGES, backend="gloo",
                                  device=device, timeout=timeout,
                                  args=([case],))]
    out, ref = ranks[-1]["out"], ranks[0]["ref"]
    err = float((out.float() - ref.float()).abs().max())
    print(f"\nSPMD pipeline ({STAGES} stages x {case.n_micro} microbatches over "
          f"gloo send/recv): max err vs sequential = {err:.2e}")
    return err, ranks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    if plan(device=args.device) is None:
        return
    # -- equal-stage pipeline executor ----------------------------------
    run_pipeline(pipeline_case(), device=args.device)


if __name__ == "__main__":
    main()
