from repro_torch.kernels.adamw.kernel import adamw_fused_call

__all__ = ["adamw_fused_call"]
