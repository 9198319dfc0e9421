"""PHAROS on PyTorch and CUDA: the serving runtime of `repro` and its LM
serving path, with the Eq. 2/3 analysis, the design-space exploration,
the discrete-event simulator, the traffic layer (admission, shedding,
mode switches, the gateway), its sharded and elastic layer (sharding,
live migration, autoscaling) and the observability layer (schedule
traces, metrics, trace diff), ported to run on an NVIDIA H100.

Module paths mirror `repro` so each module's counterpart is easy to
find. The package imports `torch` and `numpy` and nothing of `repro` or
JAX. Its kernels (the preemptible-matmul tile window, flash attention,
the WKV-6 recurrence, the selective scan) are CUDA C++ under ``csrc/``, built with ``nvcc``
at first use (`repro_torch._build`). Entry points default to
``device="cuda"``; the CPU is used only when a caller passes CPU tensors
or ``device="cpu"``.
"""
