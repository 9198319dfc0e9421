"""Per-layer cost model of the serving runtime (`costmodel`)."""
from repro_torch.conformance.costmodel import CostModel

__all__ = ["CostModel"]
