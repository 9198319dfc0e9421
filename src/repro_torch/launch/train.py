"""Training driver: config -> data -> step loop -> checkpoints (the
counterpart of ``repro.launch.train``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \
        --smoke --steps 200 --ckpt-dir /tmp/ckpt

``--smoke`` trains the reduced same-family config; without it the full
config trains on the card. ``--device cpu`` runs on the CPU through the
kernels' plain versions. Fault tolerance: auto-resume from the newest
committed checkpoint; the `runtime.ft` watchdog wraps the loop
(simulated-failure hooks in tests).

Parameters come from `lm.init_params` with a seeded ``torch.Generator``
on the device: the JAX package's ``PRNGKey`` initialisation has no
counterpart here, so the two packages start from different weights
(the tests hand the same converted weights to both step functions
instead).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import CONFIG_NAMES, ArchConfig, load_config, smoke_config
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init


def train_loop(
    cfg: ArchConfig,
    *,
    steps: int = 100,
    global_batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    on_step=None,
    schedule_steps: int = 0,
    device="cuda",
):
    """Single-host training loop; returns the loss history.

    ``schedule_steps`` fixes the LR-schedule horizon independently of
    ``steps`` so a shorter run + resume follows the identical schedule
    (checkpoint/restart determinism). ``on_step(step, loss)`` is called
    after each step, once its loss has reached the host.
    """
    horizon = schedule_steps or steps
    opt_cfg = AdamWConfig(lr_peak=lr, warmup_steps=max(10, horizon // 20),
                          total_steps=horizon)
    step_fn = make_train_step(cfg, opt_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lm.init_params(gen, cfg, torch.bfloat16, device)
    opt_state = adamw_init(params)

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    ds = SyntheticTokenDataset(data_cfg)

    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, every=ckpt_every)
        start, state = mgr.restore_latest({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        # the loop rebinds params and opt_state every step: a dict still
        # holding the first ones would keep a second copy of the whole
        # state (parameters and fp32 moments) alive for the run
        del state
        if start:
            print(f"[train] resumed from step {start}")

    losses = []
    # rtlint: disable=clock-domain -- training-launch progress log, host wall time by nature
    t0 = time.time()
    for step in range(start, steps):
        raw = ds.batch(step)
        batch = {name: torch.from_numpy(raw[name]).to(device)
                 for name in ("tokens", "labels", "mask")}
        if cfg.frontend != "none":
            # stub frontends consume precomputed embeddings; derive a
            # deterministic one-hot embedding from the token ids, as the
            # reference's launch/train.py does
            emb = F.one_hot(batch.pop("tokens").long() % cfg.frontend_dim,
                            cfg.frontend_dim).to(torch.bfloat16)
            batch = {"embeds": emb, **batch}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step is not None:
            on_step(step, loss)
        if mgr is not None:
            mgr.maybe_save(step + 1, {"params": params, "opt": opt_state})
        if step % log_every == 0 or step == steps - 1:
            # rtlint: disable=clock-domain -- training-launch progress log
            dt = time.time() - t0
            print(
                f"[train] step {step:5d} loss {loss:7.4f} "
                f"gnorm {float(metrics['grad_norm']):8.3f} "
                f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)",
                flush=True,
            )
    if mgr is not None:
        mgr.maybe_save(steps, {"params": params, "opt": opt_state})
    return losses


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=CONFIG_NAMES, default="stablelm_1_6b")
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced same-family config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    cfg = load_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model}")
    losses = train_loop(
        cfg,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        lr=args.lr,
        device=args.device,
    )
    first = np.mean(losses[: max(1, len(losses) // 10)])
    last = np.mean(losses[-max(1, len(losses) // 10):])
    print(f"[train] loss {first:.4f} -> {last:.4f}")


if __name__ == "__main__":
    main()
