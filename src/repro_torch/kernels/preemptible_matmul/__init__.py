from repro_torch.kernels.preemptible_matmul.ops import (
    DEFAULT_BLOCK,
    MatmulProgress,
    grid_geometry,
    matmul,
    matmul_resumable,
    matmul_window,
    pad_operands,
    pick_window,
)

__all__ = [
    "DEFAULT_BLOCK",
    "MatmulProgress",
    "grid_geometry",
    "matmul",
    "matmul_resumable",
    "matmul_window",
    "pad_operands",
    "pick_window",
]
