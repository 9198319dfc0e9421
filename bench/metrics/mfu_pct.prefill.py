"""Model operations of the traced window's prefill calls over its time
(host clock) and the bf16 peak (989 TFLOP/s at 700 W): the family's
``prefill_flops`` (for the dense family `benchkit.flops`' 2 N a token,
the causal attention, and the head for the last token)."""
from benchkit import peaks


def read(run):
    if not run.on_card or run.traffic["driver"] != "prefill" or not run.calls:
        return None
    work = sum(run.family.prefill_flops(run.sizes, c.rows, c.seq) for c in run.calls)
    return 100.0 * work / run.window_s / peaks.BF16_FLOPS
