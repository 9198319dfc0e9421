"""Card milliseconds a call in the program's ``prefill.mixer`` spans, every
layer's (`models/layers.py attention_prefill`: the norm, the q/k/v
projections, rotary, the flash forward, the cache write, the output
projection and the residual), over the traced window's calls; CUDA
events at each span's ends."""
from benchkit.program_spans import ms_per_call


def read(run):
    return ms_per_call(run, "prefill", "prefill.mixer", "device")
