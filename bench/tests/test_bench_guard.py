"""The whole-name check for JAX and the JAX package."""
from bench_support import smoke_root  # noqa: F401 (fixture)
from benchkit.guard import banned_modules


def test_the_jax_package_is_caught_by_its_whole_name():
    assert banned_modules(["repro"]) == ["repro"]
    assert banned_modules(["repro.models.lm", "os"]) == ["repro"]
    assert banned_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_the_port_and_lookalikes_pass():
    assert banned_modules(["repro_torch", "repro_torch.models.lm", "reprox",
                           "jaxtyping", "torch"]) == []


def test_a_harness_run_loads_neither(smoke_root):
    from benchkit.harness import execute

    out = execute("smoke.smoke_train", 1, 0.1, False, root=smoke_root, device="cpu")
    assert out["banned"] == []
