"""The plain reference against the port at smoke size on the CPU, both
fed the same tensors: in fp32 they agree to rounding, so the reference
computes what the port computes (with and without q, k, v biases)."""
import pytest
import torch

from bench_support import ROOT, SMOKE_CONFIG, SMOKE_OPT
from benchkit import tokens, weights
from benchkit.model import arch_config, sizes
from benchkit.spec import Spec
from reference import dense

DENSE = Spec(ROOT).module("families", "dense")
S = sizes("smoke", SMOKE_CONFIG)
#: AI21-Jamba2-Mini's config.json keys, as the model-configs catalog gives
#: them (https://huggingface.co/ai21labs/AI21-Jamba2-Mini): blocks of 8
#: layers, attention at offset 4 and Mamba-1 elsewhere, an MoE of 16
#: experts (top 2) on every other layer
JAMBA2_MINI = {
    "attn_layer_offset": 4, "attn_layer_period": 8, "expert_layer_offset": 1,
    "expert_layer_period": 2, "hidden_act": "silu", "hidden_size": 4096,
    "intermediate_size": 14336, "mamba_conv_bias": True, "mamba_d_conv": 4,
    "mamba_d_state": 16, "mamba_dt_rank": 256, "mamba_expand": 2,
    "mamba_proj_bias": False, "max_position_embeddings": 262144, "model_type": "jamba",
    "num_attention_heads": 32, "num_experts": 16, "num_experts_per_tok": 2,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "num_logits_to_keep": 1,
    "rms_norm_eps": 1e-06, "sliding_window": None, "tie_word_embeddings": False,
    "use_mamba_kernels": True, "vocab_size": 65536,
}
BIASED = sizes("smoke", {**SMOKE_CONFIG, "qkv_bias": True})


def _weights(seed=3, s=S):
    return weights.make(s, seed, "cpu", dtype=torch.float32)


@pytest.mark.parametrize("S", [S, BIASED], ids=["plain", "qkv_bias"])
def test_prefill_logits_and_cache_match_the_port(S):
    from repro_torch.launch.steps import make_prefill_step

    w = _weights(s=S)
    assert ("bq" in w) == S.qkv_bias
    toks = torch.randint(0, S.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    logits, cache = make_prefill_step(arch_config(S), 48)(weights.port_tree(w, S),
                                                          {"tokens": toks})
    kv = {}
    want = dense.prefill(S, w, toks, on_layer=kv.__setitem__)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    for i, (layer, got) in enumerate(zip(cache, DENSE.cache_views(cache, 40))):
        assert set(got) == set(kv[i]) == {"k", "v"}
        torch.testing.assert_close(layer["k"][:, :, :40].transpose(1, 2), kv[i]["k"],
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(layer["v"][:, :, :40].transpose(1, 2), kv[i]["v"],
                                   rtol=1e-4, atol=1e-5)
        for name in ("k", "v"):
            torch.testing.assert_close(got[name], kv[i][name], rtol=1e-4, atol=1e-5)
        assert layer["k"][:, :, 40:].abs().max() == 0


def test_a_reference_query_block_boundary_changes_nothing(monkeypatch):
    w = _weights()
    toks = torch.randint(0, S.vocab, (1, 50), generator=torch.Generator().manual_seed(2))
    whole = dense.prefill(S, w, toks)
    monkeypatch.setattr(dense, "QUERY_BLOCK", 16)
    torch.testing.assert_close(dense.prefill(S, w, toks), whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [S, BIASED], ids=["plain", "qkv_bias"])
def test_train_steps_match_the_port_in_fp32(S):
    """Three AdamW steps: losses, the first clipped gradient's leaf norms
    and the change's, from the same fp32 weights and batches."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    w = _weights(seed=4, s=S)
    batches = [{k: torch.from_numpy(v) for k, v in
                tokens.batch(S.vocab, 32, 2, 9, i).items()} for i in range(3)]
    params = weights.port_tree({k: v.clone() for k, v in w.items()}, S)
    state = adamw_init(params)
    step = make_train_step(arch_config(S), AdamWConfig(**SMOKE_OPT))
    losses = []
    for i, b in enumerate(batches):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {n: float(t.norm()) / (1 - SMOKE_OPT["b1"]) for n, t in
                    weights.port_leaves(state["m"], S).items()}
    # the reference stores bf16 parameters, as the configuration states;
    # the port here keeps fp32 ones, so compare the gradient and losses
    ref = dense.train(S, w, batches, SMOKE_OPT)
    assert max(abs(a - b) for a, b in zip(losses[:1], ref["losses"][:1])) < 1e-5
    for n in grad:
        assert abs(grad[n] - ref["grad"][n]) <= 1e-4 * max(ref["grad"][n], 1e-3), n


def test_reference_gradients_do_not_depend_on_the_query_block(monkeypatch):
    w = _weights(seed=5)
    batches = [{k: torch.from_numpy(v) for k, v in
                tokens.batch(S.vocab, 48, 2, 3, i).items()} for i in range(2)]
    whole = dense.train(S, w, batches, SMOKE_OPT)
    monkeypatch.setattr(dense, "QUERY_BLOCK", 16)
    blocked = dense.train(S, w, batches, SMOKE_OPT)
    for key in ("grad", "change"):
        for n, v in whole[key].items():
            assert abs(blocked[key][n] - v) <= 1e-5 * max(v, 1e-3), (key, n)


@pytest.mark.parametrize("key,value", [("layer_norm_eps", 1e-5),
                                       ("partial_rotary_factor", 0.25),
                                       ("hidden_act", "gelu"),
                                       ("num_experts", 16),
                                       ("num_local_experts", 8),
                                       ("attn_layer_period", 8),
                                       ("expert_layer_period", 2),
                                       ("mamba_d_state", 16),
                                       ("mamba_expand", 2),
                                       ("sliding_window", 4096),
                                       ("use_sliding_window", True),
                                       ("layer_types", ["full_attention"] * 2)])
def test_a_block_the_dense_stack_does_not_compute_is_refused(key, value):
    with pytest.raises(ValueError):
        sizes("smoke", {**SMOKE_CONFIG, key: value})


def test_the_dense_family_refuses_jamba2_mini():
    with pytest.raises(ValueError, match="experts"):
        DENSE.sizes("ai21-jamba2-mini", JAMBA2_MINI)
    # one expert (as Jamba2-3B has), the Mamba layers still refuse it
    with pytest.raises(ValueError, match="mamba_d_state"):
        DENSE.sizes("ai21-jamba2-mini", {**JAMBA2_MINI, "num_experts": 1})


@pytest.mark.parametrize("name", ["qwen1.5-1.8b", "mistral-nemo-12b"])
def test_the_dense_family_takes_the_benchmarks_configurations(name):
    _, cfg = Spec(ROOT).config(name)
    s = DENSE.sizes(name, cfg)
    assert DENSE.arch_config(s).layer_plan() == (("attn", "dense"),) * s.layers
    # a window that is off, or none, is no window
    assert DENSE.sizes(name, {**cfg, "sliding_window": None, "num_experts": 1}) == s
