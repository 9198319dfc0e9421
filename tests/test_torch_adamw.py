"""The multi-tensor AdamW kernel's host side and arithmetic, on the CPU
(`repro_torch.kernels.adamw`, `csrc/adamw.cu`; the kernel itself runs
in `test_torch_cuda.py` on a card).

- The chunk table and the descriptors: ragged leaves (0-dim, 1, 3,
  2,048 and 2^20 + 7 elements, one of none) at aligned and odd element
  offsets, walked as the kernels walk them (each block's chunks, each
  thread's vectors and tail), cover every element exactly once.
- The route: a CPU tree and a DTensor tree take the per-leaf code
  (`adamw_per_leaf`); the kernel is never called and counts nothing.
- The wrapper's refusals: another dtype, a non-contiguous leaf, leaves
  on two devices, a CPU tree.
- The source: its constants are the wrapper's, and its per-element
  update uses one rounding intrinsic per operation, in the per-leaf
  code's order. That order, emulated in numpy float32 one operation at a
  time, gives the per-leaf code's bits (the CPU's elementwise kernels
  round once per operation too), for bf16 and fp32 parameters and
  gradients, with clipping on and off. The emulation takes its square
  root from torch on the CPU: the CPU's vectorized sqrt is not always
  correctly rounded (it can miss by one ulp; `__fsqrt_rn` and the card's
  own sqrt are), so numpy's exact root would differ from the CPU's per-leaf
  code there and nowhere else.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor, init_device_mesh

import repro_torch.optim.adamw as adamw_mod
from repro_torch.kernels.adamw import kernel as K
from repro_torch.kernels.adamw import adamw_fused_call
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_per_leaf,
    adamw_update,
    step_scalars,
)

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "adamw.cu").read_text()
#: the planner's ragged leaves: 0-dim, 1, 3, 2,048 and 2^20 + 7
#: elements, and one of none
RAGGED = [(), (1,), (3,), (2048,), (2**20 + 7,), (0,)]


def _views(shapes, dtype, offset):
    """One view a shape into a shared buffer, each starting ``offset``
    elements past a 16-byte boundary (0: aligned)."""
    numels = [int(np.prod(s)) for s in shapes]
    stride = [(n + 8 + offset + 7) // 8 * 8 for n in numels]  # aligned slots
    buf = torch.zeros(sum(stride) + 16, dtype=dtype)
    base = (-buf.data_ptr() // buf.element_size()) % (16 // buf.element_size())
    out, at = [], base
    for shape, n, room in zip(shapes, numels, stride):
        out.append(buf[at + offset:at + offset + n].view(shape))
        at += room
    return out


def _walk(rows, chunks, cover):
    """Mark each element the kernels touch, as they walk the table: a
    chunk's leaf and start from its word; in an aligned leaf each thread
    takes vectors j = t, t + THREADS, ... of VEC elements, then the tail
    one by one; in any other leaf single elements."""
    for word in chunks:
        leaf, index = int(word & 0xFFFFFFFF), int(word >> 32)
        n, flags = int(rows[leaf, 7]), int(rows[leaf, 8])
        start = index * K.CHUNK
        length = min(K.CHUNK, n - start)
        assert 0 < length <= K.CHUNK and start % K.VEC == 0
        done = 0
        if flags & K.ALIGNED:
            nvec = length // K.VEC
            for t in range(K.THREADS):
                js = np.arange(t, nvec, K.THREADS)
                for k in range(K.VEC):
                    np.add.at(cover[leaf], start + js * K.VEC + k, 1)
            done = nvec * K.VEC
        for t in range(K.THREADS):
            np.add.at(cover[leaf], start + np.arange(done + t, length, K.THREADS), 1)


@pytest.mark.parametrize("offset", [0, 1, 3], ids=["aligned", "odd1", "odd3"])
def test_chunk_table_covers_every_element_once(offset):
    params = _views(RAGGED, torch.bfloat16, offset)
    grads = _views(RAGGED, torch.float32, offset)
    ms, vs = _views(RAGGED, torch.float32, 0), _views(RAGGED, torch.float32, 0)
    outs = [[torch.empty_like(t) for t in ts] for ts in (params, ms, vs)]
    decay = [i % 2 == 0 for i in range(len(RAGGED))]
    rows = K.descriptor_rows(params, grads, ms, vs, outs, decay)
    chunks = K.plan_chunks([p.numel() for p in params])
    numels = [p.numel() for p in params]
    assert rows.shape == (len(RAGGED), K.LEAF_WORDS)
    assert rows[:, 7].tolist() == numels
    for i, (p, g) in enumerate(zip(params, grads)):
        flags = int(rows[i, 8])
        assert bool(flags & K.DECAY) == decay[i]
        assert flags & K.PARAM_BF16 and not flags & K.GRAD_BF16
        aligned = all(int(x) % K.ALIGN == 0 for x in rows[i, :7])
        assert bool(flags & K.ALIGNED) == aligned
        if numels[i]:  # an empty view may sit anywhere
            assert aligned == (offset == 0)
    for out, leaf in zip(outs, (params, ms, vs)):  # new, contiguous, aligned
        for o, t in zip(out, leaf):
            assert o.shape == t.shape and o.dtype == t.dtype and o.is_contiguous()
            assert o.data_ptr() % K.ALIGN == 0 or o.numel() * o.element_size() % K.ALIGN
    assert len(chunks) == sum(-(-n // K.CHUNK) for n in numels)
    # every chunk has one block in the norm pass's fixed grid
    by_block = np.concatenate([np.arange(b, len(chunks), K.NORM_BLOCKS)
                               for b in range(K.NORM_BLOCKS)])
    assert sorted(by_block.tolist()) == list(range(len(chunks)))
    cover = [np.zeros(n, dtype=np.int64) for n in numels]
    _walk(rows, chunks, cover)
    for n, c in zip(numels, cover):
        assert c.shape == (n,) and (c == 1).all()


def test_chunk_table_words():
    got = K.plan_chunks([1, 0, K.CHUNK, K.CHUNK + 1, 3])
    want = [(0, 0), (2, 0), (3, 0), (3, 1), (4, 0)]
    assert got.dtype == np.int64
    assert [(int(w & 0xFFFFFFFF), int(w >> 32)) for w in got] == want
    assert K.plan_chunks([]).shape == (0,)


def _tree(seed, p_dtype, g_dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 8), "b": (8,), "blocks": [{"s": ()}, {"s": (3, 5)}],
              "big": (2**12 + 7,)}
    draw = lambda s, k: torch.from_numpy(  # noqa: E731
        np.asarray(rng.normal(size=s) * k, np.float32))
    params = {k: (draw(v, 1.0).to(p_dtype) if k != "blocks"
                  else [{"s": draw(b["s"], 1.0).to(p_dtype)} for b in v])
              for k, v in shapes.items()}
    grads = {k: (draw(v, scale).to(g_dtype) if k != "blocks"
                 else [{"s": draw(b["s"], scale).to(g_dtype)} for b in v])
             for k, v in shapes.items()}
    return params, grads


CFG = AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)


def test_cpu_tree_takes_the_per_leaf_code(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was called for a CPU tree")

    monkeypatch.setattr(adamw_mod, "adamw_fused_call", refuse)
    launches, leaves = adamw_fused_call.launches, adamw_fused_call.leaves
    card_leaves = adamw_per_leaf.card_leaves
    params, grads = _tree(0, torch.bfloat16, torch.bfloat16, scale=5.0)
    new, state, metrics = adamw_update(params, grads, adamw_init(params), CFG)
    assert (adamw_fused_call.launches, adamw_fused_call.leaves) == (launches, leaves)
    assert adamw_per_leaf.card_leaves == card_leaves  # CPU leaves count nothing
    flat_p, flat_g = (adamw_mod.flatten(t)[0] for t in (params, grads))
    zeros = [torch.zeros(p.shape) for p in flat_p]
    lr, bc1, bc2 = step_scalars(CFG, torch.ones((), dtype=torch.int32))
    want_p, want_m, want_v, want_n = adamw_per_leaf(
        flat_p, flat_g, zeros, zeros, [p.ndim >= 2 for p in flat_p], lr=lr,
        bc1=bc1, bc2=bc2, b1=CFG.b1, b2=CFG.b2, eps=CFG.eps,
        weight_decay=CFG.weight_decay, clip_norm=CFG.clip_norm)
    for tree, want in ((new, want_p), (state["m"], want_m), (state["v"], want_v)):
        for got, w in zip(adamw_mod.flatten(tree)[0], want):
            assert torch.equal(got, w)
    assert torch.equal(metrics["grad_norm"], want_n)


def test_dtensor_tree_takes_the_per_leaf_code(monkeypatch, tmp_path):
    """A one-rank gloo mesh: every leaf a replicated DTensor; the step's
    local values are the plain tree's bits."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel was called for a DTensor tree")

    monkeypatch.setattr(adamw_mod, "adamw_fused_call", refuse)
    params, grads = _tree(1, torch.float32, torch.float32, scale=5.0)
    state = adamw_init(params)
    want, want_state, want_metrics = adamw_update(params, grads, state, CFG)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,))
        put = lambda tree: adamw_mod.tree_map(  # noqa: E731
            lambda t: distribute_tensor(t, mesh, [Replicate()]), tree)
        got, got_state, metrics = adamw_update(put(params), put(grads), put(state), CFG)
        assert all(isinstance(t, DTensor) for t in adamw_mod.flatten(got)[0])
        for tree, ref in ((got, want), (got_state["m"], want_state["m"]),
                          (got_state["v"], want_state["v"])):
            for g, w in zip(adamw_mod.flatten(tree)[0], adamw_mod.flatten(ref)[0]):
                assert torch.equal(g.to_local(), w)
        assert metrics["grad_norm"].full_tensor().item() == pytest.approx(
            want_metrics["grad_norm"].item(), rel=1e-6)
    finally:
        dist.destroy_process_group()


def _call(params, grads, ms, vs, decay=None):
    one = torch.ones(())
    return adamw_fused_call(params, grads, ms, vs, decay or [True] * len(params),
                            lr=one, bc1=one, bc2=one, b1=0.9, b2=0.95, eps=1e-8,
                            weight_decay=0.1, clip_norm=1.0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    p, g = torch.zeros(4, 4, dtype=torch.bfloat16), torch.zeros(4, 4)
    m, v = torch.zeros(4, 4), torch.zeros(4, 4)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        _call([p.half()], [g], [m], [v])
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        _call([p], [g.double()], [m], [v])
    with pytest.raises(ValueError, match="moments must be float32"):
        _call([p], [g], [m.bfloat16()], [v])
    with pytest.raises(ValueError, match="shapes differ"):
        _call([p], [g[:2]], [m], [v])
    with pytest.raises(ValueError, match="contiguous"):
        _call([p.t()], [g.t()], [m.t()], [v.t()])
    with pytest.raises(ValueError, match="one device"):
        _call([p], [g.to("meta")], [m], [v])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        _call([p], [g], [m], [v])
    with pytest.raises(ValueError, match="differ in length"):
        _call([p, p], [g], [m], [v])


def test_kernel_constants_are_the_sources():
    for name, value in (("kThreads", K.THREADS), ("kVec", K.VEC), ("kChunk", K.CHUNK),
                        ("kNormBlocks", K.NORM_BLOCKS), ("kLeafWords", K.LEAF_WORDS)):
        assert re.search(rf"constexpr int {name} = {value};", SOURCE), name
    for name, value in (("kDecay", K.DECAY), ("kParamBf16", K.PARAM_BF16),
                        ("kGradBf16", K.GRAD_BF16), ("kAligned", K.ALIGNED)):
        assert re.search(rf"constexpr long long {name} = {value};", SOURCE), name
    floor = re.search(r"constexpr float kNormFloor = ([0-9.e+-]+)f;", SOURCE).group(1)
    assert np.float32(floor) == np.float32(K.NORM_FLOOR)
    assert K.CHUNK % K.VEC == 0 and K.NORM_BLOCKS % 132 == 0
    assert K.VEC * 2 == K.ALIGN  # a bf16 vector is one 16-byte access
    fields = re.search(r"struct Leaf \{(.*?)\};", SOURCE, re.S).group(1)
    assert len(re.findall(r";", fields)) == K.LEAF_WORDS


def _body(name):
    start = SOURCE.index(name)
    open_at = SOURCE.index("{", start)
    depth, i = 0, open_at
    while True:
        depth += {"{": 1, "}": -1}.get(SOURCE[i], 0)
        if depth == 0:
            return SOURCE[open_at + 1:i]
        i += 1


def test_update_arithmetic_uses_one_rounding_per_operation():
    """The per-element update and the clip scale: every operation through
    a round-to-nearest intrinsic, none as a bare operator nvcc could
    contract into an FMA."""
    elem = _body("__device__ __forceinline__ void adamw_elem(")
    calls = re.findall(r"__f(mul|add|sub|div|sqrt)_rn", elem)
    assert calls == ["mul", "add", "mul", "mul", "add", "mul", "mul", "mul", "div",
                     "div", "div", "add", "sqrt", "add", "mul", "sub", "mul"]
    bare = re.sub(r"__f\w+_rn|round_to<\w+>|[&]\s*\w|//.*", "", elem)
    assert not re.search(r"\w\s*[-+*/]\s*\w", bare.replace("->", "")), bare
    update = _body("adamw_update_kernel(const Leaf*")
    assert "__fsqrt_rn(sumsq)" in update
    assert "__fmul_rn(__fdiv_rn(1.0f, floored), max_norm)" in update


def _f32(x):
    return np.float32(x)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _emulated(p, g, m, v, decay, *, scale, lr, bc1, bc2, cfg, g_bf16):
    """``adamw_elem`` in numpy float32, one rounding an operation (the
    square root the CPU's, as the per-leaf code on the CPU takes it)."""
    gc = g * scale
    if g_bf16:
        gc = _bf16(gc)
    m = _f32(cfg.b1) * m + _f32(1.0 - cfg.b1) * gc
    v = _f32(cfg.b2) * v + _f32(1.0 - cfg.b2) * (gc * gc)
    root = torch.sqrt(torch.from_numpy(np.asarray(v / bc2, np.float32))).numpy()
    delta = (m / bc1) / (root + _f32(cfg.eps))
    if decay:
        delta = delta + _f32(cfg.weight_decay) * p
    return p - lr * delta, m, v


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("grad_scale", [0.01, 50.0], ids=["unclipped", "clipped"])
def test_kernel_order_emulated_gives_the_per_leaf_bits(p_dtype, g_dtype, grad_scale):
    """Three steps; the emulation takes the per-leaf code's norm, forms
    the scale as ``adamw_update_kernel`` does, and must give its bits."""
    params, grads = _tree(2, p_dtype, g_dtype, scale=grad_scale)
    flat_p, flat_g = (adamw_mod.flatten(t)[0] for t in (params, grads))
    decay = [p.ndim >= 2 for p in flat_p]
    ms = [torch.zeros(p.shape) for p in flat_p]
    vs = [torch.zeros(p.shape) for p in flat_p]
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    scales = []
    for t in range(1, 4):
        lr, bc1, bc2 = step_scalars(cfg, torch.tensor(t, dtype=torch.int32))
        new_p, new_m, new_v, norm = adamw_per_leaf(
            flat_p, flat_g, ms, vs, decay, lr=lr, bc1=bc1, bc2=bc2, b1=cfg.b1,
            b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay,
            clip_norm=cfg.clip_norm)
        n = _f32(norm.item())
        scale = min(_f32(1.0) / max(n, _f32(K.NORM_FLOOR)) * _f32(cfg.clip_norm),
                    _f32(1.0))
        scales.append(float(scale))
        for i, p in enumerate(flat_p):
            got = _emulated(p.float().numpy(), flat_g[i].float().numpy(),
                            ms[i].numpy(), vs[i].numpy(), decay[i], scale=scale,
                            lr=_f32(lr.item()), bc1=_f32(bc1.item()),
                            bc2=_f32(bc2.item()), cfg=cfg,
                            g_bf16=g_dtype == torch.bfloat16)
            want = (new_p[i].float().numpy(), new_m[i].numpy(), new_v[i].numpy())
            got_p = got[0] if p_dtype == torch.float32 else _bf16(got[0])
            for a, b in zip((got_p, got[1], got[2]), want):
                np.testing.assert_array_equal(np.asarray(a, np.float32), b)
        flat_p, ms, vs = new_p, new_m, new_v
    assert (max(scales) < 1.0) == (grad_scale > 1.0)
