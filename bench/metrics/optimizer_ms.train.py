"""Card milliseconds a training step in the program's ``train.optimizer``
span (`launch/steps.py make_train_step` around `optim/adamw.py
adamw_update`: on a card the global-norm clip and AdamW of the whole tree
in two launches of the multi-tensor kernel, `csrc/adamw.cu`), over the
traced window's steps; CUDA events at the span's ends."""
from benchkit.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "train", "train.optimizer", "device")
