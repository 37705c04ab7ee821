"""Deterministic synthetic LM data pipeline of the port (numpy)."""
from .pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]
