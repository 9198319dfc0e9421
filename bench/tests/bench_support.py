"""What the benchmark's tests share (``python -m pytest bench/tests``
from the repository's root): the smoke cells and their fixtures, which
each test file imports from here. Importing this puts ``bench/`` and
``src/`` on the path. CPU tests run the harness at smoke sizes through
the port's plain kernels; tests marked ``cuda`` skip where no card is
seen."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a smoke configuration of the dense family (head width 16, which the
#: card's flash kernels take too)
SMOKE_CONFIG = {
    "source": "smoke", "reference": "dense", "hidden_act": "silu",
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
    "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
}
SMOKE_OPT = {"lr_peak": 3e-4, "lr_min": 3e-5, "warmup_steps": 0,
             "total_steps": 10000, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
             "weight_decay": 0.1, "clip_norm": 1.0}
SMOKE_TRAFFIC = {
    "smoke_train": {"driver": "train", "batch": 4, "seq": 64, "optimizer": SMOKE_OPT,
                    "checked_steps": 3, "trace_calls": 2},
    "smoke_prefill": {"driver": "prefill", "batch": 2,
                      "cycle": [16, 48, 16], "cache_extra": 8,
                      "check_requests": 3, "trace_calls": 3},
}
#: limits for the smoke cells, set as the cells' are (lower^0.4 x
#: upper^0.6) from CPU readings of `calibration/readings.py` over 10 sound
#: and 6 control seeds: train loss 4.0e-4 sound, 6.7e-4 control (no upper
#: reading; the unchanged state reads 2.5e-3), grad 1.8e-3 / 1.39e-2,
#: change 3.6e-3 / 9.8e-3; prefill token 4.2e-4 / 7.3e-2, logits
#: 1.08e-2 / 0.113, cache 8.6e-3 / 0.121
SMOKE_LIMITS = {
    "smoke.smoke_train": {"loss_gap": 1e-3, "grad_norm_gap": 6e-3,
                          "change_norm_gap": 6.5e-3},
    "smoke.smoke_prefill": {"token_gap": 0.01, "logits_rel": 0.04,
                            "cache_rel": 0.04},
}


def write_root(root: Path, metrics=None, extra_metric_files=None) -> Path:
    """A checkout-like directory holding only a BENCHMARK.json of the smoke
    cells and their data files (and any extra metric readers)."""
    b = root / "bench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (b / d).mkdir(parents=True, exist_ok=True)
    (b / "configs" / "smoke.json").write_text(json.dumps(SMOKE_CONFIG))
    for name, t in SMOKE_TRAFFIC.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, lim in SMOKE_LIMITS.items():
        (b / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    for name, text in (extra_metric_files or {}).items():
        (b / "metrics" / f"{name}.py").write_text(text)
    doc = {
        "command": ["python3", "bench/run.py"], "paths": ["bench"], "run_seconds": 1,
        "configs": [{"name": "smoke", "source": "smoke", "file": "bench/configs/smoke.json",
                     "reduced": [], "why": "smoke"}],
        "workloads": [{"name": f"smoke.{t}", "config": "smoke", "traffic": t,
                       "chips": 1, "why": "smoke"} for t in SMOKE_TRAFFIC],
        "end_to_end": metrics or [
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"},
            {"name": "train_tokens_per_s", "unit": "tokens/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": ["smoke.smoke_train"]},
            {"name": "prefill_tokens_per_s", "unit": "tokens/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": ["smoke.smoke_prefill"]},
            {"name": "response_ms_p95", "unit": "ms", "better": "lower", "bound": 0.05,
             "source": "host_clock", "workloads": ["smoke.smoke_prefill"]}],
        "per_layer": [],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


@pytest.fixture
def smoke_root(tmp_path):
    torch.set_num_threads(2)
    return write_root(tmp_path)


@pytest.fixture
def card():
    """Skips where no CUDA card is visible (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def card_absent():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
