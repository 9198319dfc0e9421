"""Multi-tensor AdamW with global-norm clipping on an NVIDIA H100.

`adamw_fused_call` runs the kernels of ``repro_torch/csrc/adamw.cu``
over a whole tree of plain CUDA tensors: one launch sums the squares of
every gradient into fixed per-block partials, one more forms the norm
and the clip scale from them and writes every leaf's new parameter and
moments. Its plain version is the per-leaf code,
`repro_torch.optim.adamw.adamw_per_leaf`, which `adamw_update` runs on
CPU and DTensor trees; a tree of plain CUDA tensors goes here, and a
tree this call does not take raises: nothing falls back.

The leaves' descriptors (`descriptor_rows`) and the chunk table
(`plan_chunks`) go to the card as one int64 table, copied from pinned
memory without a sync, once a call.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch._build import load_library

#: elements a chunk of the table (``kChunk`` in the source)
CHUNK = 65536
#: threads a block and elements a thread takes a step (``kThreads``,
#: ``kVec``)
THREADS, VEC = 256, 8
#: blocks of the norm pass, one partial sum each (``kNormBlocks``)
NORM_BLOCKS = 528
#: int64 words of a leaf's descriptor (``kLeafWords``): the pointers to
#: p, g, m, v, p', m', v', the element count, the flags
LEAF_WORDS = 9
#: descriptor flags (``kDecay``, ``kParamBf16``, ``kGradBf16``,
#: ``kAligned`` in the source)
DECAY, PARAM_BF16, GRAD_BF16, ALIGNED = 1, 2, 4, 8
#: the norm's floor in `clip_by_global_norm` (``kNormFloor``)
NORM_FLOOR = 1e-12
#: bytes a vector access takes; a leaf whose pointers all sit on it is
#: read and written in vectors, any other element by element
ALIGN = 16
_DTYPES = (torch.bfloat16, torch.float32)
_INT32_MAX = 2**31 - 1


@functools.cache
def _kernels():
    lib = load_library("adamw")
    norm, update = lib.adamw_norm_partials, lib.adamw_update
    norm.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table, leaves, chunks
        ctypes.c_void_p, ctypes.c_void_p,  # partials, stream
    ]
    update.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table, leaves, chunks
        ctypes.c_void_p, ctypes.c_float,  # partials, max_norm
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lr, bc1, bc2
        *[ctypes.c_float] * 6,  # b1, 1 - b1, b2, 1 - b2, eps, weight decay
        ctypes.c_void_p, ctypes.c_void_p,  # norm out, stream
    ]
    norm.restype = update.restype = ctypes.c_int
    return norm, update


def plan_chunks(numels) -> np.ndarray:
    """The chunk table: an int64 ``leaf | (index << 32)`` for each chunk
    of CHUNK elements of each leaf in order, the last of a leaf shorter,
    none for a leaf of no elements."""
    n = np.asarray(numels, dtype=np.int64).reshape(-1)
    per = (n + CHUNK - 1) // CHUNK
    leaf = np.repeat(np.arange(len(n), dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    index = np.arange(int(per.sum()), dtype=np.int64) - first
    return leaf | (index << 32)


def _flags(p, g, decay: bool, pointers) -> int:
    """A leaf's flags: decay, the parameter's and gradient's dtypes, and
    whether every one of its ``pointers`` sits on ALIGN bytes."""
    return ((DECAY if decay else 0)
            | (PARAM_BF16 if p.dtype == torch.bfloat16 else 0)
            | (GRAD_BF16 if g.dtype == torch.bfloat16 else 0)
            | (0 if any(x % ALIGN for x in pointers) else ALIGNED))


def descriptor_rows(params, grads, ms, vs, outs, decay) -> np.ndarray:
    """(leaves, LEAF_WORDS) int64: each leaf's seven pointers (p, g, m, v
    and the new p', m', v' of ``outs``, three lists), its element count
    and flags."""
    rows = []
    for p, g, m, v, np_, nm, nv, d in zip(params, grads, ms, vs, *outs, decay):
        ptrs = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                np_.data_ptr(), nm.data_ptr(), nv.data_ptr())
        rows.append((*ptrs, p.numel(), _flags(p, g, d, ptrs)))
    return np.array(rows, dtype=np.int64).reshape(len(rows), LEAF_WORDS)


def _check(params, grads, ms, vs, decay) -> torch.device:
    """What the kernels take, else ValueError; returns the one device."""
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == len(decay) == n):
        raise ValueError("params, grads, moments and decay differ in length")
    for p, g, m, v in zip(params, grads, ms, vs):
        if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
            raise ValueError(f"parameters and gradients must be bfloat16 or float32, "
                             f"got {p.dtype} and {g.dtype}")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"moments must be float32, got {m.dtype} and {v.dtype}")
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"a leaf's shapes differ: {tuple(p.shape)}, "
                             f"{tuple(g.shape)}, {tuple(m.shape)}, {tuple(v.shape)}")
    leaves = (*params, *grads, *ms, *vs)
    if not all(t.is_contiguous() for t in leaves):
        raise ValueError("every leaf must be contiguous")
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"the kernel takes one device, got {sorted(map(str, devices))}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return device


def adamw_fused_call(params, grads, ms, vs, decay, *, lr, bc1, bc2, b1: float,
                     b2: float, eps: float, weight_decay: float, clip_norm: float):
    """One AdamW step with global-norm clipping over lists of leaves:
    (new params, new m, new v, the gradients' global norm), the first
    three new tensors of the inputs' shapes and dtypes; the inputs are
    only read.

    params: bfloat16 or float32; grads: bfloat16 or float32 (the clipped
    gradient is rounded to its own dtype); ms, vs: float32; each leaf's
    four of one shape; ``decay`` a bool a leaf. lr, bc1 (``1 - b1^t``) and
    bc2: 0-dim float32 tensors, read on the card. Everything on one CUDA
    device and contiguous, else ValueError. Two launches on the current
    stream (each adds one to ``adamw_fused_call.launches``, the leaves to
    ``adamw_fused_call.leaves``) and one copy of the descriptor table from
    pinned memory; no host sync.
    """
    device = _check(params, grads, ms, vs, decay)
    if any(s.device != device or s.dim() != 0 or s.dtype != torch.float32
           for s in (lr, bc1, bc2)):
        raise ValueError(f"lr, bc1 and bc2 must be 0-dim float32 tensors on {device}")
    outs = [[torch.empty_like(t) for t in ts] for ts in (params, ms, vs)]
    chunks = plan_chunks([p.numel() for p in params])
    n_leaves, n_chunks = len(params), len(chunks)
    if n_chunks > _INT32_MAX or n_leaves > _INT32_MAX:
        raise ValueError(f"too many leaves or chunks: {n_leaves}, {n_chunks}")
    table = torch.from_numpy(np.concatenate(
        [descriptor_rows(params, grads, ms, vs, outs, decay).reshape(-1), chunks]))
    partials = torch.empty(NORM_BLOCKS, dtype=torch.float32, device=device)
    norm = torch.empty((), dtype=torch.float32, device=device)
    norm_fn, update_fn = _kernels()
    with torch.cuda.device(device):
        on_card = table.pin_memory().to(device, non_blocking=True)
        stream = torch.cuda.current_stream().cuda_stream
        err = norm_fn(on_card.data_ptr(), n_leaves, n_chunks, partials.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"adamw norm launch failed: CUDA error {err}")
        adamw_fused_call.launches += 1
        err = update_fn(on_card.data_ptr(), n_leaves, n_chunks, partials.data_ptr(),
                        clip_norm, lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
                        b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
                        norm.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"adamw update launch failed: CUDA error {err}")
        adamw_fused_call.launches += 1
    adamw_fused_call.leaves += n_leaves
    return (*outs, norm)


#: kernel launches since the count was last set to 0
adamw_fused_call.launches = 0
#: leaves the kernel updated since the count was last set to 0
adamw_fused_call.leaves = 0
