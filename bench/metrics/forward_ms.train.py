"""Card milliseconds a training step in the program's ``train.forward``
span (`launch/steps.py value_and_grad` around `models/lm.py loss_fn`: the
embedding, the blocks under remat and the CE chunks, forward), over the
traced window's steps; CUDA events at the span's ends."""
from benchkit.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "train", "train.forward", "device")
