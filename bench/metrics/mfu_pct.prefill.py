"""Model operations of the traced window's prefill calls over its time
(host clock) and the bf16 peak (989 TFLOP/s at 700 W): `benchkit.flops`'
2 N a token, the causal attention, and the head for the last token."""
from benchkit import flops, peaks


def read(run):
    if not run.on_card or run.traffic["driver"] != "prefill" or not run.calls:
        return None
    work = sum(flops.prefill_flops(run.sizes, c.rows, c.seq) for c in run.calls)
    return 100.0 * work / run.window_s / peaks.BF16_FLOPS
