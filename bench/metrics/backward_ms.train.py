"""Card milliseconds a training step in the program's ``train.backward``
span (`launch/steps.py value_and_grad` around ``torch.autograd.grad``:
the blocks recomputed, their gradients with the flash backward, the CE
chunks' backward), over the traced window's steps; CUDA events at the
span's ends."""
from benchkit.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "train", "train.backward", "device")
