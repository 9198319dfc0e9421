"""End-to-end training driver: a ~100M-param model for a few hundred
steps on CPU, with checkpoints, auto-resume, and fault tolerance.

The model is a scaled-down stablelm-family config (~100M params, the
largest that trains in reasonable CPU time); the data pipeline is the
deterministic synthetic corpus; checkpoints commit atomically every 50
steps so killing and relaunching this script resumes (try it!).

Run: ``PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]``
(``--device cpu`` trains on the kernels' plain versions; the default,
``cuda``, on the hand-written flash-attention kernels). Checkpoints go
to ``pharos_torch_train_100m`` under the temporary directory, not to
the JAX example's ``/tmp/pharos_train_100m``: a run of that example
left there would make this one resume at its last step.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import load_config
from repro_torch.launch.train import train_loop
from repro_torch.models import lm
from repro_torch.models.module import param_count

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "pharos_torch_train_100m")


def build_100m():
    base = load_config("stablelm_1_6b")
    return dataclasses.replace(
        base,
        name="stablelm-100m",
        n_layers=6,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=2048,
        vocab=32768,
        max_seq=2048,
    )


def count_params(cfg) -> int:
    """Parameters of ``lm.init_params`` for ``cfg``, counted on the meta
    device (shapes only, nothing allocated)."""
    return param_count(lm.init_params(None, cfg, device="meta"))


def train(*, steps=300, batch=8, seq=256, ckpt_dir=DEFAULT_CKPT_DIR,
          device="cuda"):
    """Prints the run's lines and returns its loss history."""
    cfg = build_100m()
    n = count_params(cfg)
    print(f"[train_100m] {cfg.name}: {n/1e6:.1f}M params, "
          f"{steps} steps, batch {batch} x seq {seq}")
    losses = train_loop(
        cfg,
        steps=steps,
        global_batch=batch,
        seq_len=seq,
        lr=6e-4,
        ckpt_dir=ckpt_dir,
        ckpt_every=50,
        log_every=20,
        schedule_steps=steps,
        device=device,
    )
    k = max(1, len(losses) // 10)
    print(f"[train_100m] loss {sum(losses[:k])/k:.4f} -> "
          f"{sum(losses[-k:])/k:.4f} over {len(losses)} steps")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    train(steps=args.steps, batch=args.batch, seq=args.seq,
          ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
