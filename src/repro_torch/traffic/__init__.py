"""Traffic-layer pieces the serving runtime needs: injectable clocks."""
from repro_torch.traffic.clock import VirtualClock, WallClock

__all__ = ["VirtualClock", "WallClock"]
