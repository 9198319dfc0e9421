from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan

__all__ = ["rwkv6_scan"]
