"""Paged continuous-batching serving engine and its replica router."""
from .config import ServeConfig
from .engine import Request, ServeEngine
from .router import ReplicaRouter

__all__ = ["ReplicaRouter", "Request", "ServeConfig", "ServeEngine"]
