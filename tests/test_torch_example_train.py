"""The port's copy of ``examples/train_100m.py`` against the original, on
the CPU.

The copy's ~100M-parameter config must be the original's field for
field, and its parameter count (``lm.init_params`` on the meta device)
the original's (``jax.eval_shape`` of its ``lm.init_params``: shapes
only). A 2-step run at batch 1 x 16 on the CPU (the kernels' plain
versions) must finish with finite losses and the original's lines.
"""
import contextlib
import dataclasses
import importlib.util
import io
import math
import os

import jax
import torch

from repro.models import lm as ref_lm
from repro.models.module import param_count as ref_param_count
from repro_torch.examples import train_100m

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    spec = importlib.util.spec_from_file_location(
        "ref_train_100m", os.path.join(ROOT, "examples", "train_100m.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_and_parameter_count_equal_the_originals():
    ref_cfg = _reference().build_100m()
    cfg = train_100m.build_100m()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.vocab) == (
        6, 768, 12, 64, 32768)
    shapes = jax.eval_shape(lambda: ref_lm.init_params(jax.random.PRNGKey(0), ref_cfg))
    want = ref_param_count(shapes)
    assert train_100m.count_params(cfg) == want
    assert 80e6 < want < 130e6


def test_a_short_cpu_run_finishes(tmp_path):
    argv = ["--steps", "2", "--batch", "1", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_100m.main(argv)
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("[train_100m] stablelm-100m: ")
    assert "2 steps, batch 1 x seq 16" in lines[0]
    steps = [l for l in lines if l.startswith("[train] step")]
    assert len(steps) == 2
    assert all(math.isfinite(float(l.split("loss")[1].split()[0])) for l in steps)
    assert lines[-1].startswith("[train_100m] loss ") and "over 2 steps" in lines[-1]
