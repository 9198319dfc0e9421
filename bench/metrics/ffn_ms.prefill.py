"""Card milliseconds a call in the program's ``prefill.ffn`` spans, every
layer's (`models/layers.py mlp`: the norm, the SwiGLU products, their
elementwise work and the residual), over the traced window's calls; CUDA
events at each span's ends."""
from benchkit.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "prefill", "prefill.ffn", "device")
