"""Prefill calls, closed loop, one client: the port's
``make_prefill_step`` (`lm.prefill`: every layer over the whole prompt,
the KV cache written, the last token's logits) on prompts of uniform
token ids drawn on the device from the seed.

Traffic keys: ``batch`` (prompts a call, all of one length),
``cycle`` (the prompt lengths of successive calls, repeated in this
order: every seed sends the same lengths, and only the tokens differ, so
a window of a given length cuts the same mix of calls whatever the
seed), ``cache_extra`` (cache room past the prompt), ``check_requests``
and ``trace_calls``. Set-up warms up one call of each length. A call is due when the previous call's first tokens
(each row's argmax) are on the host, and ends when its own are.

The check, once the window has closed: the reference runs over the
last call's prompts and over ``check_requests`` more requests drawn from
the seed (with a row of the longest length served). Compared: the widest
gap by which a served token's logit lies below the reference's best,
the last call's logits (relative L2), and its cache, worst layer and
tensor (relative L2 of each tensor the reference names for the layer:
K and V in an attention layer; see the family's ``cache_views``)."""
from __future__ import annotations

import numpy as np
import torch

from benchkit import compare
from benchkit.harness import span
from benchkit.tokens import seed_u63


def make_program(arch, cache_len: int):
    """The program's prefill step."""
    from repro_torch.launch.steps import make_prefill_step

    return make_prefill_step(arch, cache_len)


def serve(logits):
    """The served first token of each row."""
    return logits.argmax(-1)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed_u63(seed), stream]))


class Driver:
    counts_rows = True  # each prompt of a call is one request

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.B = t["batch"]
        self.cycle = [int(n) for n in t["cycle"]]
        self.sent = 0

    def next_length(self) -> int:
        self.sent += 1
        return self.cycle[(self.sent - 1) % len(self.cycle)]

    def prompts_from_seed(self) -> None:
        self.gen = torch.Generator(device=self.ctx.device)
        self.gen.manual_seed(seed_u63(self.ctx.seed) ^ 0x5EED)

    def prompt(self, S: int):
        return torch.randint(0, self.ctx.sizes.vocab, (self.B, S),
                             generator=self.gen, device=self.ctx.device)

    def call(self, S: int):
        with span("batch"):
            toks = self.prompt(S)
        self.cache = None  # the previous call's cache is not kept alive
        with span("prefill"):
            logits, self.cache = self.steps[S](self.params, {"tokens": toks})
        with span("read"):
            first = serve(logits).cpu()
        self.logits = logits
        return toks, first

    def setup(self) -> None:
        ctx, s = self.ctx, self.ctx.sizes
        self.w = ctx.family.make_weights(s, ctx.seed, ctx.device)
        self.params = ctx.family.port_tree(self.w, s)
        extra = ctx.traffic["cache_extra"]
        self.steps = {S: make_program(ctx.arch, S + extra) for S in set(self.cycle)}
        self.prompts_from_seed()
        for S in sorted(self.steps):
            self.call(S)
        self.served = []

    def window(self, loop) -> None:
        while loop.more():
            due = loop.due()
            S = self.next_length()
            self.served.append(self.call(S))
            loop.done(due, self.B, S)

    def release(self) -> None:
        self.params = self.steps = None

    # ------------------------------------------------------------------
    def sample(self) -> dict[int, list[int]]:
        """{call index: rows} to judge: every row of the last call, and
        ``check_requests`` more drawn from the seed, with a row of the
        longest length served."""
        last = len(self.served) - 1
        picks = {last: list(range(self.B))}
        others = [(c, r) for c in range(last) for r in range(self.B)]
        n = min(self.ctx.traffic.get("check_requests", 0), len(others))
        if n:
            for j in _rng(self.ctx.seed, 2).choice(len(others), n, replace=False):
                c, r = others[int(j)]
                picks.setdefault(c, []).append(r)
        lengths = [t.shape[1] for t, _ in self.served]
        longest = max(lengths)
        if not any(lengths[c] == longest for c in picks):
            c = max(i for i, L in enumerate(lengths) if L == longest)
            picks[c] = [0]
        return {c: sorted(rows) for c, rows in sorted(picks.items())}

    def judge(self, outputs) -> list[tuple[str, float]]:
        """``outputs(picks, toks, on_layer)`` gives the served tokens of
        ``picks`` (``[(call, rows)]``, prompts ``toks``) and, for the last
        call (with ``on_layer``), its logits and each layer's named cache
        tensors to ``on_layer(i, {name: tensor})``. The reference works
        out its own: the rows of one length in one pass. A tensor that
        one side names for a layer and the other lacks fails the check."""
        ctx, s = self.ctx, self.ctx.sizes
        ref = ctx.reference
        last = len(self.served) - 1
        by_length = {}
        for c, rows in self.sample().items():
            if c != last:
                by_length.setdefault(self.served[c][0].shape[1], []).append((c, rows))
        gaps = []
        for _, picks in sorted(by_length.items()):
            toks = torch.cat([self.served[c][0][rows] for c, rows in picks])
            served, _ = outputs(picks, toks, None)
            gaps.append(compare.token_gaps(ref.prefill(s, self.w, toks), served).cpu())
        got_cache = {}
        toks = self.served[last][0]
        served, got_logits = outputs([(last, list(range(self.B)))], toks,
                                     got_cache.__setitem__)
        cache_gap = 0.0

        def on_layer(i, want):
            nonlocal cache_gap
            got = got_cache.pop(i)
            # a tensor that one side lacks reads 1, as zeros in its place would
            cache_gap = max([cache_gap, *(compare.rel_l2(got[n], want[n])
                                          if n in got and n in want else 1.0
                                          for n in sorted(got.keys() | want.keys()))])

        want = ref.prefill(s, self.w, toks, on_layer=on_layer)
        gaps.append(compare.token_gaps(want, served).cpu())
        return [("token_gap", float(torch.cat(gaps).max())),
                ("logits_rel", compare.rel_l2(got_logits, want)),
                ("cache_rel", cache_gap)]

    def program_outputs(self, picks, toks, on_layer):
        served = torch.cat([self.served[c][1][rows] for c, rows in picks])
        if on_layer is None:
            return served, None
        for i, named in enumerate(self.ctx.family.cache_views(self.cache, toks.shape[1])):
            on_layer(i, named)
        return served, self.logits

    def check(self) -> list[tuple[str, float, float]]:
        lim = self.ctx.limits
        return [(n, v, lim[n]) for n, v in self.judge(self.program_outputs)]

    def control(self) -> list[tuple[str, float]]:
        """The numbers with the reference in fp8 in the program's place,
        over the prompts a window's first cycle of calls would send."""
        self.prompts_from_seed()
        self.w = self.ctx.family.make_weights(self.ctx.sizes, self.ctx.seed, self.ctx.device)
        for S in sorted(set(self.cycle)):
            self.prompt(S)  # the warm-up's draws
        self.served = [(self.prompt(self.next_length()), None)
                       for _ in range(len(self.cycle))]
        ref, s = self.ctx.reference, self.ctx.sizes

        def outputs(picks, toks, on_layer):
            logits = ref.prefill(s, self.w, toks, prec="fp8", on_layer=on_layer)
            return serve(logits), logits

        return self.judge(outputs)
