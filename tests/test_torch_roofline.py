"""The port's roofline (`repro_torch.launch.roofline`) against the JAX
package's, on the CPU.

- `analytic_cost` equals the reference's exactly (the same float
  arithmetic on the same layer chains) for all ten full-size configs x
  their applicable shapes.
- `roofline` at the reference's constants (197 TFLOP/s, 819 GB/s, 50
  GB/s) gives the reference's terms exactly; its defaults are one H100
  SXM's published peaks, the ones ``chip_smoke.py`` bounds its kernels
  with.
- The six LM kernels' custom ops pass ``torch.library.opcheck`` on CPU
  tensors; the public calls give the plain versions' bits; under
  ``FakeTensorMode`` their outputs have the plain outputs' shapes and
  dtypes; ``FlopCounterMode`` counts each by the operation count that
  ``chip_smoke.py``'s bounds use, which reads its peaks from here.
- `CollectiveCounter` counts a sharded matmul loop's collectives on every
  trip: 6 trips count 6 times one trip (the reference's HLO parser
  multiplies a scan body by its trip count, ``tests/test_launch.py``).
  The loop runs on a 2x2 mesh under torch's fake process group, in a
  subprocess, on fake tensors.
"""
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.launch import roofline as rroof
from repro.launch import shapes as rshapes
from repro_torch.configs import CONFIG_NAMES, load_config
from repro_torch.launch import roofline as R
from repro_torch.launch.shapes import SHAPES, applicable_shapes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(n, s) for n in CONFIG_NAMES for s in applicable_shapes(load_config(n))]


def _ref_config(name):
    return importlib.import_module(f"repro.configs.{name}").CONFIG


@pytest.mark.parametrize("name,shape", CELLS)
def test_analytic_cost_equals_reference(name, shape):
    got = R.analytic_cost(load_config(name), SHAPES[shape])
    want = rroof.analytic_cost(_ref_config(name), rshapes.SHAPES[shape])
    assert (got.flops, got.hbm_bytes, got.model_flops) == (
        want.flops, want.hbm_bytes, want.model_flops)
    assert got.useful_ratio() == want.useful_ratio()


@pytest.mark.parametrize("name,shape", CELLS)
def test_roofline_at_reference_constants_equals_reference(name, shape):
    chips, coll = 256, 3.5e9
    got = R.roofline(load_config(name), SHAPES[shape], chips, coll,
                     peaks=(rroof.PEAK_FLOPS, rroof.HBM_BW, rroof.ICI_BW))
    want = rroof.roofline(_ref_config(name), rshapes.SHAPES[shape], chips, coll)
    assert got.as_dict() == want.as_dict()


def test_roofline_defaults_are_h100_peaks():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.ICI_BW, R.NVLINK_BW) == (
        989e12, 3.35e12, 50e9, 450e9)
    cfg, case = load_config("stablelm_1_6b"), SHAPES["train_4k"]
    terms = R.roofline(cfg, case, 256, 1e9)
    cost = R.analytic_cost(cfg, case)
    assert terms.compute_s == cost.flops / (256 * 989e12)
    assert terms.memory_s == cost.hbm_bytes / (256 * 3.35e12)
    assert terms.collective_s == 1e9 / 50e9
    assert terms.dominant == max(("compute", terms.compute_s),
                                 ("memory", terms.memory_s),
                                 ("collective", terms.collective_s),
                                 key=lambda kv: kv[1])[0]


_LOOP = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.roofline import CollectiveCounter

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_dev_mesh(2, 2, device="cpu")
    out = {}
    with FakeTensorMode():
        w = DTensor.from_local(torch.empty(6, 32, 32), mesh,
                               [Shard(1), Shard(2)], run_check=False)
        x0 = DTensor.from_local(torch.empty(4, 64), mesh,
                                [Shard(0), Replicate()], run_check=False)
        for trips in (1, 6):
            with CollectiveCounter() as c:
                x = x0
                for i in range(trips):
                    x = torch.tanh(x @ w[i])
                    x = x.redistribute(mesh, [Shard(0), Replicate()])
            out[trips] = c.totals()
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_collective_counter_counts_every_loop_trip():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", _LOOP], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    one, six = out["1"], out["6"]
    assert one["count"] > 0 and one["all-gather"] > 0
    for k in (*R.COLLECTIVES, "count", "total"):
        assert six[k] == 6 * one[k], k
    assert six["total"] == sum(six[k] for k in R.COLLECTIVES)


# ---------------------------------------------------------------------------
# the LM kernels as custom ops (their flop formulas feed the dry run)
# ---------------------------------------------------------------------------
def _op_cases():
    """(name, op, public call, plain version, args) of the six ops at small
    CPU shapes, inputs from a seed; the flash ops also at head widths 16
    and 32."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.mamba_scan import kernel as MK
    from repro_torch.kernels.mamba_scan import ref as MR
    from repro_torch.kernels.rwkv6_scan import kernel as WK
    from repro_torch.kernels.rwkv6_scan import ref as WR

    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    r, kk, vv, dy = (rn(2, 12, 2, 8) for _ in range(4))
    w = torch.rand((2, 12, 2, 8), generator=g) * 0.3 + 0.69
    u = rn(2, 8)
    dt = torch.rand((2, 12, 6), generator=g) * 0.1
    B, C, x, dys = rn(2, 12, 4), rn(2, 12, 4), rn(2, 12, 6), rn(2, 12, 6)
    A, h0 = -torch.rand((6, 4), generator=g), rn(2, 6, 4)
    flash = []
    for hd in (8, 16, 32):  # 16 and 32: the narrow widths the kernels take
        fq, fk, fv, fdo = rn(2, 12, 4, hd), rn(2, 12, 2, hd), rn(2, 12, 2, hd), rn(2, 12, 4, hd)
        fo, flse = FR.attention_plain(fq, fk, fv, return_lse=True)
        tag = "" if hd == 8 else f"_hd{hd}"
        flash += [
            (f"flash{tag}", FK.flash_attention_op,
             lambda fq=fq, fk=fk, fv=fv: FK.flash_attention_call(
                 fq, fk, fv, return_lse=True),
             lambda fq=fq, fk=fk, fv=fv: FR.attention_plain(
                 fq, fk, fv, return_lse=True), (fq, fk, fv, True, True)),
            (f"flash_backward{tag}", FK.flash_attention_backward_op,
             lambda a=(fq, fk, fv, fo, fdo, flse): FK.flash_attention_backward_call(*a),
             lambda a=(fq, fk, fv, fo, fdo, flse): FR.attention_backward_plain(*a),
             (fq, fk, fv, fo, fdo, flse, True)),
        ]
    return [
        *flash,
        ("wkv", WK.rwkv6_scan_op, lambda: WK.rwkv6_scan_call(
            r, kk, vv, w, u, chunk=4), lambda: WR.rwkv6_scan_plain(
            r, kk, vv, w, u, chunk=4), (r, kk, vv, w, u, 4)),
        ("wkv_backward", WK.rwkv6_scan_backward_op,
         lambda: WK.rwkv6_scan_backward_call(r, kk, vv, w, u, dy),
         lambda: WR.rwkv6_scan_backward_plain(r, kk, vv, w, u, dy),
         (r, kk, vv, w, u, dy, None)),
        ("scan", MK.mamba_scan_op, lambda: MK.mamba_scan_call(
            dt, B, C, x, A, h0, chunk=4), lambda: MR.mamba_scan_plain(
            dt, B, C, x, A, h0, chunk=4), (dt, B, C, x, A, h0, 4)),
        ("scan_backward", MK.mamba_scan_backward_op,
         lambda: MK.mamba_scan_backward_call(dt, B, C, x, A, h0, dys, chunk=4),
         lambda: MR.mamba_scan_backward_plain(dt, B, C, x, A, h0, dys, chunk=4),
         (dt, B, C, x, A, h0, dys, None, 4)),
    ]


OP_NAMES = [c[0] for c in _op_cases()]


def _case(name):
    return next(c for c in _op_cases() if c[0] == name)


@pytest.mark.parametrize("name", OP_NAMES)
def test_custom_op_passes_opcheck(name):
    _, op, _, _, args = _case(name)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", OP_NAMES)
def test_public_call_gives_the_plain_versions_bits_on_cpu(name):
    _, _, call, plain, _ = _case(name)
    got, want = call(), plain()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", OP_NAMES)
def test_fake_outputs_match_the_plain_outputs(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, op, _, plain, args = _case(name)
    want = plain()
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
    with mode:
        got = op(*fake_args)
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]


def _chip_smoke():
    """``chip_smoke.py`` as a module (it exits only from ``main``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", OP_NAMES)
def test_flop_formulas_equal_chip_smokes_counts(name):
    """FlopCounterMode counts each op by its formula, the operations
    ``chip_smoke.py``'s bounds divide by the peaks."""
    from torch.utils.flop_counter import FlopCounterMode

    cs = _chip_smoke()
    _, op, _, _, args = _case(name)
    with FlopCounterMode(display=False) as fc:
        op(*args)
    got = fc.get_total_flops()
    q = args[0]
    # each count as chip_smoke.py wrote it before the formulas were shared
    name = name.split("_hd")[0]
    if name == "flash":
        B, S, H, hd = q.shape
        want = 4.0 * hd * B * H * S * (S + 1) / 2
    elif name == "flash_backward":
        B, S, H, hd = q.shape
        want = 5 * 2.0 * hd * B * H * S * (S + 1) / 2
    elif name == "wkv":
        B, S, H, hd = q.shape
        want = float(B * S * H) * (5 * hd * hd + 5 * hd)
    elif name == "wkv_backward":
        B, S, H, hd = q.shape
        want = cs.WKV_BWD_FLOPS * B * S * H * hd * hd
    else:
        Bb, S, di = q.shape
        ns = args[1].shape[2]
        want = (6 if name == "scan" else cs.SCAN_BWD_FLOPS) * Bb * S * di * ns
    assert got == int(want)
    assert cs.PEAK_FLOPS[torch.bfloat16] == R.PEAK_FLOPS
    assert cs.PEAK_FLOPS[torch.float32] == R.PEAK_FLOPS_F32
    assert cs.PEAK_BYTES_S == R.HBM_BW
