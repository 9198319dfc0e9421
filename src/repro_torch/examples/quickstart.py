"""Quickstart: the PHAROS flow end to end in ~a minute on CPU.

1. Build a task set (two DNN workloads with periods),
2. run the SRT-guided beam search (paper Alg. 1),
3. check Eq. 3 schedulability + analytic response bounds,
4. simulate FIFO vs EDF on the chosen design (DES),
5. serve the design for real with the EDF runtime (tile-preemptible
   GEMM windows).

Run: ``PYTHONPATH=src python -m repro_torch.examples.quickstart``
(``--device cpu`` serves step 5 on the window kernel's plain version;
the default, ``cuda``, on the hand-written window kernel).
"""
import argparse

from repro_torch.core.dse.beam import beam_search
from repro_torch.core.dse.space import evaluate_design, fixed_design
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.core.rt.response_time import end_to_end_bounds
from repro_torch.core.rt.schedulability import srt_schedulable, stage_utilizations
from repro_torch.core.workloads import PAPER_WORKLOADS, make_taskset
from repro_torch.pipeline import PharosServer, design_to_segments
from repro_torch.scheduler.des import simulate_taskset


def plan():
    """Steps 1-4: prints them; returns (best design, workloads, task set)."""
    platform = paper_platform(16)
    combo = ("pointnet", "mlp_mixer")
    workloads = [PAPER_WORKLOADS[c] for c in combo]
    taskset = make_taskset(combo, ratios=(0.8, 0.8), platform=platform)
    print(f"tasks: {[t.name for t in taskset.tasks]}")
    print(f"periods: {[f'{t.period*1e6:.1f}us' for t in taskset.tasks]}")

    # -- 1. one big accelerator is NOT schedulable --------------------
    fx = fixed_design(workloads, taskset, platform)
    print(f"\nfixed single accelerator: max_util={fx.max_util:.3f} "
          f"(needs <= 1)")

    # -- 2. SRT-guided DSE (Algorithm 1) ------------------------------
    res = beam_search(workloads, taskset, platform, max_m=4, beam_width=8)
    best = res.best
    print(f"beam search: {len(res.succ_pts)} feasible designs in "
          f"{res.stats.wall_time_s:.2f}s")
    print(f"best design: {best.n_stages} stages, chips="
          f"{[a.chips for a in best.accs]}, max_util={best.max_util:.3f}")

    # -- 3. schedulability + response bounds --------------------------
    table = evaluate_design(best.accs, best.splits, workloads, taskset)
    print(f"Eq.3 SRT-schedulable: {srt_schedulable(table, taskset, False)}")
    print(f"stage utilizations: "
          f"{[f'{u:.3f}' for u in stage_utilizations(table, taskset, False)]}")
    for pol in ("fifo", "edf"):
        b = end_to_end_bounds(table, taskset, pol)
        print(f"{pol} analytic response bounds: "
              f"{[f'{x*1e6:.1f}us' for x in b]}")

    # -- 4. discrete-event simulation ---------------------------------
    for pol in ("fifo", "edf"):
        sim = simulate_taskset(table, taskset, pol)
        print(f"DES {pol}: schedulable={sim.schedulable} "
              f"max_response={[f'{r*1e6:.1f}us' for r in sim.max_response]} "
              f"preemptions={sim.preemptions}")
    return best, workloads, taskset


def serve(best, workloads, taskset, *, device="cuda", horizon_s=1.5):
    """Step 5: serves the design on ``device`` for ``horizon_s`` wall
    seconds and prints it; returns (serve tasks, server report)."""
    # -- 5. serve it for real (host runtime, wall-clock ms scale) -----
    tasks = design_to_segments(best, workloads, taskset, period_scale=2e3,
                               device=device)
    srv = PharosServer(tasks, best.n_stages, policy="edf", window_tiles=4,
                       device=device)
    rep = srv.run(horizon_s=horizon_s)
    print(f"\nlive EDF serving ({horizon_s}s):")
    for t in tasks:
        r = rep.response_times[t.name]
        if r:
            print(f"  {t.name:16s} jobs={len(r):4d} "
                  f"mean={1e3*sum(r)/len(r):6.2f}ms max={1e3*max(r):6.2f}ms "
                  f"misses={rep.deadline_misses[t.name]}")
    print(f"  preemptions={rep.preemptions} windows={rep.windows_executed}")
    return tasks, rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the window kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    best, workloads, taskset = plan()
    serve(best, workloads, taskset, device=args.device)


if __name__ == "__main__":
    main()
