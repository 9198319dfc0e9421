"""The flash-attention backward's share of its roofline over the traced
window: the least time of every step's causal attention backward (five
products, or its bytes), one backward an attention layer a step (the
family's ``attention_layers`` and ``attention_shape``), over the
profiler's card time in its three passes (``delta_kernel``,
``dkdv_kernel``, ``dq_kernel``)."""
from benchkit import flops

PASSES = ("delta_kernel", "dkdv_kernel", "dq_kernel")


def read(run):
    if run.trace is None or run.traffic["driver"] != "train":
        return None
    spent, launches = run.trace.kernel_seconds(*PASSES)
    layers = run.family.attention_layers(run.sizes)
    H, Hkv, hd = run.family.attention_shape(run.sizes)
    if launches != len(PASSES) * layers * len(run.calls) or spent <= 0:
        return None
    least = sum(layers * flops.least_seconds(
        flops.flash_bwd_flops(c.rows, c.seq, H, hd),
        flops.flash_bwd_bytes(c.rows, c.seq, H, Hkv, hd))
        for c in run.calls)
    return 100.0 * least / spent
