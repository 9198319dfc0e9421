"""Training steps, closed loop: the port's ``make_train_step`` (the
forward and backward of `lm.loss_fn` with remat per layer and CE in
512-position chunks, then AdamW) on the frozen synthetic token chains.

Traffic keys: ``batch``, ``seq``, ``coherence`` (the chains'),
``optimizer`` (AdamW's numbers, handed to both sides), ``checked_steps``
and ``trace_calls``. Set-up makes the weights from the seed and drives
the one training-step object through its first ``checked_steps`` steps,
the warm-up; the window goes on with the same object. A step ends when
its loss is on the host, as in ``launch.train.train_loop``.

The check: the reference follows those first steps from the same
weights and batches. Compared: the largest gap of a step's loss (over the
reference's), and by the worst leaf the gap of the first gradient's norm
(the program's worked out from AdamW's first moment after one step) and
of the parameters' change after the checked steps, each over the larger
of the reference's norm of that leaf and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of the change."""
from __future__ import annotations

import torch

from benchkit import compare, tokens
from benchkit.harness import span


def make_program(arch, opt: dict):
    """The program's training step."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig

    return make_train_step(arch, AdamWConfig(**opt))


def batch_at(ctx, step: int) -> dict:
    t = ctx.traffic
    raw = tokens.batch(ctx.sizes.vocab, t["seq"], t["batch"], ctx.seed, step,
                       t.get("coherence", 0.9))
    return {k: torch.from_numpy(v).to(ctx.device) for k, v in raw.items()}


def leaf_norms(family, tree, s, scale=1.0) -> dict:
    named = family.port_leaves(tree, s)
    norms = torch.stack([x.float().norm() for x in named.values()]) * scale
    return dict(zip(named, norms.tolist()))


class Driver:
    counts_rows = False  # a step is one attempt

    def __init__(self, ctx):
        self.ctx = ctx
        self.B, self.S = ctx.traffic["batch"], ctx.traffic["seq"]

    def step(self, i: int) -> float:
        with span("batch"):
            batch = batch_at(self.ctx, i)
        with span("step"):
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
        with span("read"):
            return float(metrics["loss"])

    def setup(self) -> None:
        from repro_torch.optim import adamw_init

        ctx, s, fam = self.ctx, self.ctx.sizes, self.ctx.family
        w = fam.make_weights(s, ctx.seed, ctx.device)
        self.params = fam.port_tree(w, s)
        self.opt_state = adamw_init(self.params)
        self.step_fn = make_program(ctx.arch, ctx.traffic["optimizer"])
        self.losses, self.grad = [], {}
        b1 = ctx.traffic["optimizer"]["b1"]
        for i in range(ctx.traffic["checked_steps"]):
            self.losses.append(self.step(i))
            if i == 0:
                self.grad = leaf_norms(fam, self.opt_state["m"], s, 1.0 / (1.0 - b1))
        # the stacked weights keep the first values: AdamW makes new tensors
        named = fam.port_leaves(self.params, s)
        first = fam.stacked_leaves(w, s)
        diff = torch.stack([(named[n].float() - first[n].float()).norm() for n in named])
        self.change = dict(zip(named, diff.tolist()))
        self.next = ctx.traffic["checked_steps"]

    def window(self, loop) -> None:
        while loop.more():
            due = loop.due()
            self.step(self.next)
            self.next += 1
            loop.done(due, self.B, self.S)

    def release(self) -> None:
        self.params = self.opt_state = self.step_fn = None

    def reference_run(self, prec: str) -> dict:
        ctx = self.ctx
        w = ctx.family.make_weights(ctx.sizes, ctx.seed, ctx.device)
        batches = [batch_at(ctx, i) for i in range(ctx.traffic["checked_steps"])]
        return ctx.reference.train(ctx.sizes, w, batches, ctx.traffic["optimizer"], prec)

    def numbers(self, got: dict, want: dict) -> list[tuple[str, float]]:
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
        grad_gap, _ = compare.leaf_norm_gap(got["grad"], want["grad"])
        moving = compare.moving_leaves(want["grad"])
        change_gap, _ = compare.leaf_norm_gap(got["change"], want["change"], moving)
        return [("loss_gap", loss_gap), ("grad_norm_gap", grad_gap),
                ("change_norm_gap", change_gap)]

    def check(self) -> list[tuple[str, float, float]]:
        got = {"losses": self.losses, "grad": self.grad, "change": self.change}
        want = self.reference_run("fp32")
        lim = self.ctx.limits
        return [(n, v, lim[n]) for n, v in self.numbers(got, want)]

    def control(self) -> list[tuple[str, float]]:
        """The numbers with the reference in fp8 in the program's place."""
        got = self.reference_run("fp8")
        return self.numbers(got, self.reference_run("fp32"))
