"""The flash-attention forward kernel's share of its roofline over the
traced window: the least time of every call's causal attention (the
larger of its operations at 989 TFLOP/s and its bytes at 3.35 TB/s), one
launch per layer a call, over the profiler's card time in ``fa_kernel``."""
from benchkit import flops

KERNEL = "fa_kernel"


def read(run):
    if run.trace is None or run.traffic["driver"] != "prefill":
        return None
    spent, launches = run.trace.kernel_seconds(KERNEL)
    s = run.sizes
    if launches != s.layers * len(run.calls) or spent <= 0:
        return None
    least = sum(s.layers * flops.least_seconds(
        flops.flash_fwd_flops(c.rows, c.seq, s.heads, s.head_dim),
        flops.flash_fwd_bytes(c.rows, c.seq, s.heads, s.kv_heads, s.head_dim))
        for c in run.calls)
    return 100.0 * least / spent
