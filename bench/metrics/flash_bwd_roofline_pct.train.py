"""The flash-attention backward's share of its roofline over the traced
window: the least time of every step's causal attention backward (five
products, or its bytes), one backward a layer a step, over the
profiler's card time in its three passes (``delta_kernel``,
``dkdv_kernel``, ``dq_kernel``)."""
from benchkit import flops

PASSES = ("delta_kernel", "dkdv_kernel", "dq_kernel")


def read(run):
    if run.trace is None or run.traffic["driver"] != "train":
        return None
    spent, launches = run.trace.kernel_seconds(*PASSES)
    s = run.sizes
    if launches != len(PASSES) * s.layers * len(run.calls) or spent <= 0:
        return None
    least = sum(s.layers * flops.least_seconds(
        flops.flash_bwd_flops(c.rows, c.seq, s.heads, s.head_dim),
        flops.flash_bwd_bytes(c.rows, c.seq, s.heads, s.kv_heads, s.head_dim))
        for c in run.calls)
    return 100.0 * least / spent
