"""Model operations of the traced window's training steps over its time
(host clock) and the bf16 peak (989 TFLOP/s at 700 W): the family's
``train_step_flops`` (for the dense family `benchkit.flops`' 6 N a token
plus the attention of forward and backward)."""
from benchkit import peaks


def read(run):
    if not run.on_card or run.traffic["driver"] != "train" or not run.calls:
        return None
    work = sum(run.family.train_step_flops(run.sizes, c.rows, c.seq) for c in run.calls)
    return 100.0 * work / run.window_s / peaks.BF16_FLOPS
