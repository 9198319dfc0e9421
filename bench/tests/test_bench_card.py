"""On the card (skipped elsewhere): the harness at smoke size through the
CUDA kernels, untraced and traced."""
import pytest

from bench_support import card, smoke_root  # noqa: F401 (fixtures)
from benchkit import harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["smoke.smoke_train", "smoke.smoke_prefill"])
def test_smoke_cells_on_the_card(card, smoke_root, cell):
    out = harness.execute(cell, 2**31 + 3, 0.5, False, root=smoke_root, device=card)
    line = out["line"]
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    traced = harness.execute(cell, 2**31 + 4, 0.5, True, root=smoke_root, device=card)
    dev = traced["line"]["device"]
    assert traced["line"]["correct"] is True
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert traced["line"]["breakdown"]["device_ops"]
