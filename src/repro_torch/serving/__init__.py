"""Paged continuous-batching serving engine."""
from .config import ServeConfig
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeConfig", "ServeEngine"]
