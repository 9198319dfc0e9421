"""The plain reference against the port at smoke size on the CPU, both
fed the same tensors: in fp32 they agree to rounding, so the reference
computes what the port computes (with and without q, k, v biases)."""
import pytest
import torch

from bench_support import SMOKE_CONFIG, SMOKE_OPT
from benchkit import tokens, weights
from benchkit.model import arch_config, sizes
from reference import dense

S = sizes("smoke", SMOKE_CONFIG)
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
    want = dense.prefill(S, w, toks, on_layer=lambda i, k, v: kv.__setitem__(i, (k, v)))
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    for i, layer in enumerate(cache):
        torch.testing.assert_close(layer["k"][:, :, :40].transpose(1, 2), kv[i][0],
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(layer["v"][:, :, :40].transpose(1, 2), kv[i][1],
                                   rtol=1e-4, atol=1e-5)
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
                                       ("hidden_act", "gelu")])
def test_a_block_the_dense_stack_does_not_compute_is_refused(key, value):
    with pytest.raises(ValueError):
        sizes("smoke", {**SMOKE_CONFIG, key: value})
