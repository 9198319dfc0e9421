"""Deadline-compliant serving: FIFO vs EDF on a mixed-criticality mix.

Two tenants share a 2-stage PHAROS pipeline:
- ``perception`` — heavyweight inference, relaxed deadline,
- ``safety``     — lightweight inference, tight deadline (the paper's
  smart-transportation safety monitor).

Under FIFO the safety task queues behind perception layers; under EDF
the scheduler preempts perception *inside a layer* at a tile-window
boundary (the preemptible-matmul mechanism), spilling the fp32 partial
accumulator and resuming later — deadline misses drop accordingly.

Run: ``PYTHONPATH=src python -m repro_torch.examples.serve_edf``
(``--device cpu`` runs the windows on the kernel's plain version; the
default, ``cuda``, on the hand-written window kernel).
"""
import argparse
import math

import numpy as np
import torch

from repro_torch.pipeline.serve import PharosServer, ServeTask

POLICIES = ("fifo", "edf")


def mk_weights(dims, seed, device="cuda"):
    """N(0, 1) / sqrt(K) fp32 (K, N) weights, drawn on the CPU from a
    generator seeded with ``seed`` and moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for (k_dim, n_dim) in dims:
        w = torch.randn((k_dim, n_dim), generator=gen) / math.sqrt(k_dim)
        out.append(w.to(device))
    return tuple(out)


def make_tasks(device="cuda"):
    """The two tenants, their weights on ``device``."""
    perception = ServeTask(
        "perception",
        mk_weights([(512, 1024), (1024, 1024), (1024, 512)], 0, device),
        stage_of_layer=(0, 0, 1),
        period=0.08,
        input_rows=1024,
    )
    safety = ServeTask(
        "safety",
        mk_weights([(128, 256), (256, 128)], 1, device),
        stage_of_layer=(0, 1),
        period=0.02,
        deadline=0.012,
        input_rows=128,
    )
    return [perception, safety]


def serve(tasks, policy, *, device="cuda", horizon_s=2.0):
    """Serves ``tasks`` under ``policy`` for ``horizon_s`` wall seconds
    and prints the policy's lines; returns the server report."""
    srv = PharosServer(tasks, n_stages=2, policy=policy, window_tiles=2,
                       device=device)
    rep = srv.run(horizon_s=horizon_s)
    print(f"\n== {policy.upper()} ==")
    for name in ("perception", "safety"):
        r = rep.response_times[name]
        if not r:
            continue
        arr = np.asarray(r)
        misses = rep.deadline_misses[name]
        print(
            f"  {name:11s} jobs={len(r):4d} "
            f"mean={1e3*arr.mean():7.2f}ms p99={1e3*np.quantile(arr,0.99):7.2f}ms "
            f"max={1e3*arr.max():7.2f}ms deadline_misses={misses}"
        )
    print(f"  preemptions={rep.preemptions} "
          f"windows={rep.windows_executed}")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the window kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    tasks = make_tasks(args.device)
    for policy in POLICIES:
        serve(tasks, policy, device=args.device)


if __name__ == "__main__":
    main()
