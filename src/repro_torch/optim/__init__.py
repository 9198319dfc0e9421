from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_per_leaf,
    adamw_update,
    cosine_schedule,
    global_norm,
    step_scalars,
)

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_per_leaf",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "step_scalars",
]
