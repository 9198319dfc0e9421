"""The port's boundaries: it imports neither JAX nor the JAX package,
`repro_torch.convert` carries the reference's objects across field for
field, the kernel build is content-addressed, and ``chip_smoke.py``
refuses to report without a card."""
import dataclasses
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
        "flash_attention", "mamba_scan", "preemptible_matmul", "rwkv6_scan"
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
