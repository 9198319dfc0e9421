"""Deadline metrics shared by the serving reports."""
from repro_torch.obs.metrics import percentile, percentile_summary

__all__ = ["percentile", "percentile_summary"]
