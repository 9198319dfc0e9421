"""A rank's run for `test_torch_spmd.py` and `test_torch_cuda.py`: the
port's LM under the SPMD policy on a (data, model) mesh of spawned ranks
(gloo on the CPU, nccl on cards). Imports no JAX: the spawned ranks load
only the port."""
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.launch.sharding import (
    batch_shardings,
    distribute_tree,
    opt_state_shardings,
    shardings_for_tree,
)
from repro_torch.launch.shapes import ShapeCase
from repro_torch.launch.steps import activation_policy, lowerable, make_train_step
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_map


def _full(tree):
    return tree_map(lambda t: t.full_tensor().cpu().numpy(), tree)


def spmd_job(_stage_mesh, cases, opt_cfg: AdamWConfig, shape=(2, 2),
             device="cpu") -> list[dict]:
    """`spmd_case` of each (cfg, params, batch) in ``cases`` (CPU
    tensors) on a ``shape`` mesh of ``device``."""
    mesh = make_dev_mesh(*shape, device=device)
    to = lambda tree: tree_map(lambda t: t.to(device), tree)  # noqa: E731
    return [spmd_case(mesh, cfg, to(params), to(batch), opt_cfg, *rest)
            for cfg, params, batch, *rest in cases]


def spmd_case(mesh, cfg, params, batch, opt_cfg: AdamWConfig, micro=1) -> dict:
    """Forward logits and one `lowerable` train step of ``cfg`` (its
    metrics hold `lm.loss_fn`'s loss) on this rank's shards of ``params``
    and ``batch`` (plain CPU tensors, the same on every rank), and with
    ``micro`` > 1 the same step through ``micro`` micro-batches; every
    result gathered whole."""
    policy = activation_policy(mesh, seq_parallel=True, n_experts=cfg.n_experts)
    p_shard = shardings_for_tree(mesh, params)
    dparams = distribute_tree(mesh, params, p_shard)
    dbatch = distribute_tree(mesh, batch, batch_shardings(mesh, batch))
    inputs = {k: v for k, v in dbatch.items() if k in ("tokens", "embeds")}
    logits = lm.forward(dparams, cfg, inputs, policy=policy)
    B, S = batch["labels"].shape
    fn, _ = lowerable(cfg, ShapeCase("train", S, B, "train"), mesh, opt_cfg)
    opt = distribute_tree(mesh, adamw_init(params),
                          opt_state_shardings(mesh, p_shard))
    new_params, _, metrics = fn(dparams, opt, dbatch)
    out = {}
    if micro > 1:  # the same step split into micro-batches
        step = make_train_step(cfg, opt_cfg, policy=policy, micro_batches=micro,
                               grad_shardings=p_shard)
        micro_params, _, micro_metrics = step(dparams, opt, dbatch)
        out = {"micro_loss": float(micro_metrics["loss"].full_tensor()),
               "micro_params": _full(micro_params)}
    return {**out,"logits": logits.full_tensor().cpu().numpy(),
            "step_loss": float(metrics["loss"].full_tensor()),
            "grad_norm": float(metrics["grad_norm"].full_tensor()),
            "params": _full(new_params)}


def prefill_job(_stage_mesh, cfg, params, tokens, device="cuda") -> dict:
    """`lowerable`'s prefill of ``cfg`` on a 1 x 1 mesh of this one rank,
    and the NO_POLICY prefill of the same parameters and tokens: their
    last-token logits, and the flash launches and MoE host reads of the
    `lowerable` one."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_call
    from repro_torch.models import layers as L

    mesh = make_dev_mesh(1, 1, device=device)
    params = tree_map(lambda t: t.to(device), params)
    B, S = tokens.shape
    fn, _ = lowerable(cfg, ShapeCase("prefill", S, B, "prefill"), mesh)
    dparams = distribute_tree(mesh, params, fn.in_shardings[0])
    batch = distribute_tree(mesh, {"tokens": tokens.to(device)}, fn.in_shardings[1])
    flash_attention_call.launches = L.moe_dropless.host_reads = 0
    logits, _ = fn(dparams, batch)
    got = {"logits": logits.full_tensor().cpu(),
           "flash_launches": flash_attention_call.launches,
           "host_reads": L.moe_dropless.host_reads}
    got["plain"] = lm.prefill(params, cfg, {"tokens": tokens.to(device)}, S)[0].cpu()
    return got
