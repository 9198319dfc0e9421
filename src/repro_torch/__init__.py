"""PHAROS on PyTorch and CUDA: the serving runtime of `repro`, ported to
run its tile windows on an NVIDIA H100.

Module paths mirror `repro` so each module's counterpart is easy to
find. The package imports `torch` and `numpy` and nothing of `repro` or
JAX. Its one kernel, the preemptible-matmul tile window, is CUDA C++
under ``csrc/``, built with ``nvcc`` at first use (`repro_torch._build`).
Entry points default to ``device="cuda"``; the CPU is used only when a
caller passes CPU tensors or ``device="cpu"``.
"""
