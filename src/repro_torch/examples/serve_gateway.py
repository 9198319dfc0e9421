"""Admission-controlled serving under bursty traffic.

Runs the ``rush_hour`` scenario (sporadic LiDAR PointNet + a bursty
MMPP DeiT camera stream) end-to-end through the traffic subsystem:

1. the scenario is resolved against the paper platform — the DSE picks
   the pipelined design, producing the `SegmentTable` the admission
   controller reasons over;
2. every tenant passes online admission (O(stages) incremental Eq. 3)
   and the controller prints its headroom report — how much more
   traffic each stage/tenant could take;
3. the `TrafficGateway` releases the MMPP/sporadic traffic into a
   `PharosServer` on a deterministic `VirtualClock` (real GEMM windows,
   virtual time driven per-window by the conformance `CostModel` — the
   same WCETs the analysis uses), with reject-newest shedding armed;
4. the same pipeline is then hammered with the ``overload_2x`` scenario
   — traffic at twice its provisioned rate — to show the backlog
   monitor engaging shedding when reality contradicts the analysis.

5. finally the multi-tenant scale layer: the ``multi_tenant_rush``
   scenario is served on a `ShardedGateway` — K replicas of one
   pipeline with slack-aware tenant placement, per-shard Eq. 3
   admission, and value-weighted per-tenant token buckets trimming the
   overdriven tenants back to their contracts.

Run: ``PYTHONPATH=src python -m repro_torch.examples.serve_gateway``
(``--device cpu`` runs the windows on the kernel's plain version; the
default, ``cuda``, on the hand-written window kernel; the virtual clock
makes the printed lines the same on either).

``--trace out.json`` records every run (gateway, runtime and sharded)
into one `repro_torch.obs.TraceRecorder` — each scenario pass tagged via
``annotate(scenario=...)`` — and writes the combined Chrome-trace
JSON, loadable in Perfetto or chrome://tracing.
"""
import argparse

import numpy as np

from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.obs import TraceRecorder, percentile, write_chrome_trace
from repro_torch.pipeline.serve import PharosServer
from repro_torch.traffic import (
    AdmissionController,
    RateLimiter,
    ShardedGateway,
    TrafficGateway,
    VirtualClock,
    build,
    get_scenario,
)
from repro_torch.traffic.shedding import get_policy


def run_scenario(
    name: str, horizon_periods: float = 60.0, trace=None, device="cuda"
):
    """Serves scenario ``name`` through a `TrafficGateway` on ``device``
    and prints it; returns the gateway report."""
    plat = paper_platform(16)
    scenario = get_scenario(name)
    built = build(scenario, plat)
    print(f"\n=== scenario {name!r}: {scenario.description}")
    print(
        f"  design: {built.design.n_stages} stages, "
        f"max analytic util {built.design.max_util:.3f}"
    )

    # serve directly on the analysis timebase: the CostModel charges
    # every executed tile window its modeled per-layer WCET, so the
    # virtual run needs no period rescaling or quantization knob
    tasks, requests, arrivals = built.serve_bundle(period_scale=1.0,
                                                   device=device)
    cost_model = built.conformance_cost_model(tasks)
    clk = VirtualClock()
    server = PharosServer(
        tasks,
        built.design.n_stages,
        policy=scenario.policy,
        cost_model=cost_model,
        clock=clk.now,
        sleep=clk.sleep,
        trace=trace,
        device=device,
    )
    admission = AdmissionController(
        list(built.table.overhead),
        preemptive=scenario.policy == "edf",
    )
    gateway = TrafficGateway(
        server,
        admission,
        requests,
        arrivals,
        shedding=get_policy("reject_newest"),
        clock=clk,
        trace=trace,
    )

    for dec in gateway.open():
        print(
            f"  admission {dec.request.name:14s} -> "
            f"{'ADMIT' if dec.admitted else 'REJECT':6s} ({dec.reason})"
        )
    probe = requests[0].base
    hr = admission.headroom_report(probe=probe)
    print(
        f"  headroom: bottleneck stage {hr.bottleneck}, "
        f"probe({requests[0].name}) max rate "
        f"{hr.probe_max_rate:.1f} jobs/s"
    )
    for tenant, mult in hr.tenant_rate_multipliers.items():
        print(f"    {tenant:14s} admits up to {mult:.2f}x its rate")

    horizon = horizon_periods * max(r.period for r in requests)
    report = gateway.run(horizon)

    sr = report.server_report
    for t in report.tenants:
        rts = sr.response_times.get(t.name, [])
        arr = np.asarray(rts) if rts else np.zeros(1)
        # p99 via the shared nearest-rank helper — the same number
        # `MetricsRegistry.from_trace` would report for this tenant
        p99 = percentile(rts, 99) if rts else 0.0
        print(
            f"  {t.name:14s} sched={t.scheduled:4d} released={t.released:4d} "
            f"shed={t.shed:4d} degraded={t.degraded:4d} | "
            f"rt mean={1e3 * arr.mean():6.2f}ms "
            f"p99={1e3 * p99:6.2f}ms "
            f"misses={sr.deadline_misses.get(t.name, 0)}"
        )
    print(
        f"  totals: completed={sr.jobs_completed} "
        f"preemptions={sr.preemptions} shed={report.total_shed()}"
    )
    # incremental admission verdicts must agree with the full analysis
    assert admission.verify(), "cached utilization diverged from Eq. 3"
    return report


def run_sharded(
    name: str, shards: int, horizon_periods: float = 40.0, trace=None,
    device="cuda",
):
    """Serves scenario ``name`` on a `ShardedGateway` of ``shards``
    replicas on ``device`` and prints it; returns the sharded report."""
    plat = paper_platform(16)
    built = build(get_scenario(name), plat)
    print(
        f"\n=== scenario {name!r} on {shards} shards "
        f"(slack-aware placement, value-weighted rate limiting)"
    )
    gateway = ShardedGateway.from_built(
        built,
        shards=shards,
        placement="slack_aware",
        shedding=get_policy("reject_newest"),
        make_ratelimit=lambda reqs: RateLimiter.for_requests(
            reqs, burst_periods=3.0, value_weighted=True
        ),
        trace=trace,
        device=device,
    )
    horizon = horizon_periods * max(r.period for r in built.requests)
    report = gateway.run(horizon)
    assert gateway.verify(), "a shard's Eq. 3 cache diverged"
    print(f"  placement: {report.plan.assignment}")
    for t in report.tenants:
        print(
            f"  shard {report.shard_of(t.name)} {t.name:12s} "
            f"sched={t.scheduled:4d} released={t.released:4d} "
            f"ratelimited={t.rate_limited:4d} shed={t.shed:4d}"
        )
    print(
        f"  totals: released={report.total_released()} "
        f"ratelimited={report.total_rate_limited()} "
        f"shed={report.total_shed()}"
    )
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--trace",
        metavar="OUT.json",
        help="record all runs and write a Chrome/Perfetto trace here",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (the window kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    rec = TraceRecorder() if args.trace else None

    if rec is not None:
        rec.annotate(scenario="rush_hour")
    run_scenario("rush_hour", trace=rec, device=args.device)
    if rec is not None:
        rec.annotate(scenario="overload_2x")
    run_scenario("overload_2x", trace=rec, device=args.device)
    if rec is not None:
        rec.annotate(scenario="multi_tenant_rush")
    run_sharded("multi_tenant_rush", shards=2, trace=rec, device=args.device)

    if rec is not None:
        write_chrome_trace(rec.events, args.trace)
        print(
            f"\nwrote {len(rec.events)} schedule events to "
            f"{args.trace} (load in Perfetto / chrome://tracing)"
        )


if __name__ == "__main__":
    main()
