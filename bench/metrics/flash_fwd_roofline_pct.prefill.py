"""The flash-attention forward kernel's share of its roofline over the
traced window: the least time of every call's causal attention (the
larger of its operations at 989 TFLOP/s and its bytes at 3.35 TB/s), one
launch per attention layer a call (the family's ``attention_layers`` and
``attention_shape``), over the profiler's card time in ``fa_kernel``."""
from benchkit import flops

KERNEL = "fa_kernel"


def read(run):
    if run.trace is None or run.traffic["driver"] != "prefill":
        return None
    spent, launches = run.trace.kernel_seconds(KERNEL)
    layers = run.family.attention_layers(run.sizes)
    H, Hkv, hd = run.family.attention_shape(run.sizes)
    if launches != layers * len(run.calls) or spent <= 0:
        return None
    least = sum(layers * flops.least_seconds(
        flops.flash_fwd_flops(c.rows, c.seq, H, hd),
        flops.flash_fwd_bytes(c.rows, c.seq, H, Hkv, hd))
        for c in run.calls)
    return 100.0 * least / spent
