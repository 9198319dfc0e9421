"""The port's boundaries: it imports neither JAX nor the JAX package,
`repro_torch.convert` carries the reference's objects across field for
field, the kernel build is content-addressed, and ``chip_smoke.py``
refuses to report without a card and prices its kernels' bounds."""
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.core.dse.space import DesignPoint as RefDesignPoint
from repro.core.dse.space import evaluate_design as ref_evaluate
from repro.core.perfmodel.exec_model import AccDesign as RefAccDesign
from repro.core.perfmodel.exec_model import layer_latency as ref_layer_latency
from repro.core.perfmodel.hardware import paper_platform as ref_platform
from repro.core.workloads import PAPER_WORKLOADS as REF_WORKLOADS
from repro.core.workloads import make_taskset as ref_make_taskset
from repro.obs.metrics import percentile_summary as ref_summary
from repro_torch import _build, convert
from repro_torch.core.dse.space import evaluate_design
from repro_torch.core.perfmodel.exec_model import AccDesign, layer_latency
from repro_torch.core.perfmodel.hardware import paper_platform
from repro_torch.core.workloads import PAPER_WORKLOADS, make_taskset
from repro_torch.obs.metrics import percentile_summary

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_EVERYTHING = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import repro_torch
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]
    examples = {f"repro_torch.examples.{n}" for n in (
        "quickstart", "serve_edf", "serve_gateway", "dse_pipeline", "train_100m")}
    assert examples <= set(names), sorted(examples - set(names))
    for name in names:
        importlib.import_module(name)
    bad = sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.") or m == "jaxlib"
        or m.startswith("jaxlib.") or m == "repro" or m.startswith("repro.")
    )
    assert not bad, bad
    print("IMPORTED", len(names))
    """
)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_EVERYTHING],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 20  # every module of the slice was imported


@pytest.mark.parametrize("name", sorted(REF_WORKLOADS))
def test_paper_workloads_and_exec_model_are_copies(name):
    got, want = PAPER_WORKLOADS[name], REF_WORKLOADS[name]
    assert got == convert.workload_from(want)
    for block in ((128, 128, 128), (256, 128, 256)):
        for chips in (1, 4):
            acc, ref_acc = AccDesign(chips, block), RefAccDesign(chips, block)
            assert [layer_latency(l, acc) for l in got.layers] == [
                ref_layer_latency(l, ref_acc) for l in want.layers
            ]


def test_convert_carries_design_and_taskset_field_for_field():
    combo, ratios = ("pointnet", "mlp_mixer"), (1.0, 0.8)
    ref_ts = ref_make_taskset(combo, ratios, ref_platform())
    ts = make_taskset(combo, ratios, paper_platform())
    assert ts == convert.taskset_from(ref_ts)
    ref_design = RefDesignPoint(
        accs=(RefAccDesign(1, (256, 128, 128)), RefAccDesign(15)),
        splits=((4, 1), (4, 7)),
        max_util=0.5,
    )
    design = convert.design_from(ref_design)
    assert [dataclasses.asdict(a) for a in design.accs] == [
        dataclasses.asdict(a) for a in ref_design.accs
    ]
    assert design.splits == ref_design.splits
    wls = [PAPER_WORKLOADS[n] for n in combo]
    got = evaluate_design(design.accs, design.splits, wls, ts)
    want = ref_evaluate(ref_design.accs, ref_design.splits,
                        [REF_WORKLOADS[n] for n in combo], ref_ts)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_percentile_summary_matches_reference():
    vals = [0.3, 0.1, 0.7, 0.2, 0.9, 0.4]
    assert percentile_summary(vals) == ref_summary(vals)
    assert percentile_summary(vals, (0, 100)) == ref_summary(vals, (0, 100))


def test_kernel_build_is_content_addressed():
    assert _build.source_names() == [
        "adamw", "flash_attention", "flash_attention_bwd", "mamba_scan",
        "mamba_scan_bwd", "preemptible_matmul", "rwkv6_scan", "rwkv6_scan_bwd",
    ]
    path = _build.library_path("preemptible_matmul")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libpreemptible_matmul-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No visible card (``CUDA_VISIBLE_DEVICES`` empty), or no repo
    beside the script: a non-zero exit and no result line."""
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        proc = _run_smoke(cwd)
        assert proc.returncode != 0
        lines = proc.stdout.strip().splitlines()
        assert not lines or '"ok"' not in lines[-1]
        for line in lines:
            with pytest.raises(json.JSONDecodeError):
                json.loads(line)


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_kernels_line_holds_only_this_runs_numbers():
    """Each ``kernels`` entry carries the contract's keys and the route of
    its products, every number taken from this run's row; the earlier
    times copied from PERF.md go on a text line of their own."""
    smoke = _load_smoke()
    row = {"max_abs_err": 1e-7, "ms": 0.05, "plain_ms": 0.04, "bound_ms": 0.008,
           "bound_by": "operations", "library_ms": 0.043, "previous_ms": 9.0}
    entries = [smoke.kernel_entry(name, f"src/{name}.cu", "kernel.py:1", "fma", 3, row)
               for name in smoke.PREVIOUS_MS]
    contract = {"name", "route", "source", "replaces", "launches", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in entries:
        assert set(e) == contract | {"mma"}
        assert {k: e[k] for k in row if k in e} == {k: v for k, v in row.items()
                                                     if k in contract}
    line = smoke.previous_line(entries)
    assert line.startswith("[previous]") and "not measured here" in line
    for name, (prev_ms, _) in smoke.PREVIOUS_MS.items():
        assert f"{name} 0.05000 ms now, {prev_ms} ms before" in line
    with pytest.raises(json.JSONDecodeError):
        json.loads(line)


def test_chip_smoke_bounds_price_the_units_that_run_the_products():
    """The window's fp32 bound is 3xTF32 at the TF32 tensor-core peak, the
    FMA figure beside it; the fp32 peak the scans use is unchanged; flash
    keeps the function's bound and prints the P split's 1.5x floor."""
    smoke = _load_smoke()
    assert smoke.PEAK_FLOPS[torch.float32] == 67e12
    flops = 2.0 * 24 * 128 * 128 * 1664
    bound, by, fma = smoke.window_bound(128, 1664, 3072, 0, 24, torch.float32)
    assert by == "operations"
    assert bound == pytest.approx(3 * flops / smoke.PEAK_TF32_FLOPS * 1e3)
    assert fma == pytest.approx(flops / 67e12 * 1e3)
    assert round(bound, 5) == 0.00793 and round(fma, 5) == 0.01953
    assert smoke.window_bound(128, 1664, 3072, 0, 24, torch.bfloat16)[2] is None
    bound, by = smoke.flash_bound(2, 2048, 32, 8, 128, 2)
    floor, _ = smoke.flash_bound(2, 2048, 32, 8, 128, 2, smoke.FLASH_SPLIT_PRODUCTS)
    assert by == "operations" and round(bound, 5) == 0.06952
    assert floor == pytest.approx(1.5 * bound)
    # the backward: five products of 2 hd flops per causal pair
    bound, by = smoke.bwd_bound(8, 2048, 32, 32, 64, 2)
    assert by == "operations" and round(bound, 5) == 0.34759


def test_chip_smoke_recurrent_backward_bounds():
    """The WKV-6 backward's bound at RWKV-6-7B's training shape is its 12
    fp32 flops per state element and step at the FMA peak (the 9 tensors'
    bytes take less; dw's walk is O(hd) a step and adds none); the scan backward's at Jamba's is its 5 (B, S, di)
    tensors' bytes (one exponential per state element and step on the
    SFUs, and its flops, take less). Every entry of the ``kernels`` line
    without an earlier time says so on the text line; the two backwards,
    redesigned, carry their first versions' times there."""
    smoke = _load_smoke()
    bound, by = smoke.wkv_bwd_bound(8, 2048, 64, 64)
    flops = 12.0 * 8 * 2048 * 64 * 64 * 64
    assert by == "operations" and bound == pytest.approx(flops / 67e12 * 1e3)
    assert round(bound, 5) == 0.76925
    bound, by = smoke.scan_bwd_bound(8, 2048, 8192, 16)
    assert by == "bytes" and round(bound, 5) == 0.80537
    row = {"max_abs_err": 0.0, "ms": 5.0, "plain_ms": 200.0, "bound_ms": 0.9,
           "bound_by": "operations", "library_ms": None}
    entry = smoke.kernel_entry("rwkv6_scan_backward", "src/x.cu", "rwkv.py:109",
                               "fma", 8, row)
    assert smoke.PREVIOUS_MS["rwkv6_scan_backward"][0] == 5.79748
    assert smoke.PREVIOUS_MS["mamba_scan_backward"][0] == 5.31701
    assert "rwkv6_scan_backward 5.00000 ms now, 5.79748 ms before" in (
        smoke.previous_line([entry]))
    first = smoke.kernel_entry("a_first_version", "src/x.cu", "x.py:1", "fma", 8, row)
    assert "a_first_version" not in smoke.PREVIOUS_MS
    assert "a_first_version 5.00000 ms now, no earlier time" in (
        smoke.previous_line([first]))
