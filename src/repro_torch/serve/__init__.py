"""Serving: the continuous-batching engine over KV-cache lanes."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
