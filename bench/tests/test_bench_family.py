"""A family other than dense enters the benchmark through new files only.

A copy of ``bench/`` and ``BENCHMARK.json`` gains, as new files, a family
adapter over the port's smoke-sized Jamba (attention and Mamba mixers,
dense and MoE ffns), its configuration, a traffic mix naming the
``prefill`` driver, its limits, and a stand-in reference; and, in
``BENCHMARK.json``, the configuration, the cell and the cell's name in
``prefill_tokens_per_s``'s list. The harness runs the cell on the CPU
with no other edit, and the check compares every layer's cache by the
names the family gives it: K and V in the attention layers, the
convolution window and the scan state in the Mamba ones.

The stand-in reference is the port's own prefill in fp32 on the CPU:
plumbing for this test, not a plain reference."""
import json
import shutil

import pytest
import torch

from bench_support import BENCH, ROOT
from benchkit import compare, harness
from benchkit.spec import Spec

FAMILY = "hybrid_smoke"
CONFIG = "hybrid-smoke"
CELL = "hybrid-smoke.prefill_smoke"

ADAPTER = '''"""The port's smoke-sized Jamba as a family (test only), served in fp32."""
from dataclasses import replace

import torch

from benchkit.tokens import seed_u63


def sizes(name, cfg):
    from repro_torch.configs.base import smoke_config
    from repro_torch.configs.jamba_v0_1_52b import CONFIG

    return replace(smoke_config(CONFIG), name=name, n_layers=cfg["num_hidden_layers"])


def arch_config(s):
    return s


def make_weights(s, seed, device, dtype=torch.float32):
    from repro_torch.models import lm

    gen = torch.Generator(device=device)
    gen.manual_seed(seed_u63(seed))
    return lm.init_params(gen, s, dtype, device)


def port_tree(w, s):
    return w


def port_leaves(tree, s):
    from repro_torch.tree import flatten_with_paths

    paths, leaves, _ = flatten_with_paths(tree)
    return dict(zip(paths, leaves))


stacked_leaves = port_leaves


def cache_views(cache, S):
    return [{n: c[n][:, :, :S].transpose(1, 2) for n in ("k", "v")} if "k" in c
            else {"conv": c["conv"], "ssm": c["ssm"]} for c in cache]


def prefill_flops(s, B, S):
    return 2.0 * s.param_counts()["active"] * B * S


def train_step_flops(s, B, S):
    return 3.0 * prefill_flops(s, B, S)


def attention_layers(s):
    return sum(mixer == "attn" for mixer, _ in s.layer_plan())


def attention_shape(s):
    return s.n_heads, s.n_kv_heads, s.head_dim
'''

STAND_IN = '''"""Stand-in reference (test only): the port's own prefill in fp32."""
import torch


def _fp32(tree):
    if isinstance(tree, dict):
        return {k: _fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp32(v) for v in tree]
    return tree.float()


@torch.no_grad()
def prefill(s, w, tokens, prec="fp32", on_layer=None):
    from repro_torch.models import lm

    logits, cache = lm.prefill(_fp32(w), s, {"tokens": tokens}, tokens.shape[1])
    if on_layer is not None:
        for i, c in enumerate(cache):
            on_layer(i, {n: c[n].transpose(1, 2) for n in ("k", "v")} if "k" in c
                     else {"conv": c["conv"], "ssm": c["ssm"]})
    return logits
'''

SMOKE_JAMBA = {"source": "smoke", "reference": FAMILY, "model_type": "jamba",
               "num_hidden_layers": 16}
TRAFFIC = {"driver": "prefill", "batch": 2, "cycle": [24, 40], "cache_extra": 8,
           "check_requests": 2, "trace_calls": 2}
#: the program and the stand-in run the same code on the same fp32
#: weights: every number read 0 on the CPU over 6 seeds
LIMITS = {"token_gap": 0.0, "logits_rel": 0.0, "cache_rel": 0.0}


@pytest.fixture
def hybrid_root(tmp_path):
    """A copy of the benchmark with the hybrid cell added as new files."""
    torch.set_num_threads(2)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    b = tmp_path / "bench"
    new = {b / "families" / f"{FAMILY}.py": ADAPTER,
           b / "reference" / f"{FAMILY}.py": STAND_IN,
           b / "configs" / f"{CONFIG}.json": json.dumps(SMOKE_JAMBA),
           b / "traffic" / "prefill_smoke.json": json.dumps(TRAFFIC),
           b / "limits" / f"{CELL}.json": json.dumps(LIMITS)}
    for path, text in new.items():
        assert not path.exists()
        path.write_text(text)
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": CONFIG, "source": "smoke",
                           "file": f"bench/configs/{CONFIG}.json", "reduced": [],
                           "why": "smoke"})
    doc["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "prefill_smoke",
                             "chips": 1, "why": "smoke"})
    for m in doc["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp_path


def test_the_copy_differs_from_the_benchmark_by_new_files_only(hybrid_root):
    old = {p.relative_to(BENCH) for p in BENCH.rglob("*")
           if p.is_file() and "__pycache__" not in p.parts and "tests" not in p.parts}
    copy = hybrid_root / "bench"
    for rel in old:
        assert (copy / rel).read_bytes() == (BENCH / rel).read_bytes(), rel


def test_a_hybrid_cell_runs_and_checks_both_kinds_of_cache(hybrid_root, monkeypatch):
    spec = Spec(hybrid_root)
    plan = spec.module("families", FAMILY).arch_config(
        harness.context(spec, CELL, 0, "cpu").sizes).layer_plan()
    assert {m for m, _ in plan} == {"attn", "mamba"} and {f for _, f in plan} == {"dense", "moe"}
    compared = []
    rel_l2 = compare.rel_l2

    def recording(got, want):
        compared.append(tuple(want.shape))
        return rel_l2(got, want)

    monkeypatch.setattr(compare, "rel_l2", recording)
    out = harness.execute(CELL, 2**31 + 17, 0.3, False, root=hybrid_root, device="cpu")
    line = out["line"]
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"token_gap", "logits_rel", "cache_rel"}
    assert line["metrics"]["prefill_tokens_per_s"]["value"] > 0
    s = out["run"].sizes
    S = out["run"].calls[-1].seq
    di = s.d_inner
    kinds = [m for m, _ in plan]
    want = [(2, S, s.n_kv_heads, s.head_dim)] * 2 * kinds.count("attn")
    want += [(2, s.mamba_d_conv - 1, di), (2, di, s.mamba_d_state)] * kinds.count("mamba")
    # every layer's named tensors as the reference passes them, then the logits
    assert sorted(compared[:-1]) == sorted(want) and compared[-1] == (2, s.vocab)


def test_a_wrong_scan_state_fails_the_hybrid_cell(hybrid_root):
    family = Spec(hybrid_root).module("families", FAMILY)
    views = family.cache_views

    def one_state_off(cache, S):
        out = views(cache, S)
        mamba = next(v for v in out if "ssm" in v)
        mamba["ssm"] = mamba["ssm"] * 1.5
        return out

    family.cache_views = one_state_off
    try:
        out = harness.execute(CELL, 5, 0.2, False, root=hybrid_root, device="cpu")
    finally:
        family.cache_views = views
    assert out["line"]["correct"] is False
    assert out["line"]["checks"]["cache_rel"]["value"] >= 0.4


@pytest.mark.parametrize("change", ["drop", "add"])
def test_a_cache_tensor_on_one_side_only_fails_the_hybrid_cell(hybrid_root, change):
    family = Spec(hybrid_root).module("families", FAMILY)
    views = family.cache_views

    def one_name_off(cache, S):
        out = views(cache, S)
        mamba = next(v for v in out if "conv" in v)
        if change == "drop":
            del mamba["conv"]
        else:
            mamba["extra"] = mamba["conv"]
        return out

    family.cache_views = one_name_off
    try:
        out = harness.execute(CELL, 6, 0.2, False, root=hybrid_root, device="cpu")
    finally:
        family.cache_views = views
    assert out["line"]["correct"] is False
    assert out["line"]["checks"]["cache_rel"]["value"] == 1.0
