"""Scheduler records shared with the serving runtime."""
from repro_torch.scheduler.des import StageOverhead

__all__ = ["StageOverhead"]
