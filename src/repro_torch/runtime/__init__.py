"""Execution context, kernel registry and serving planner."""
from . import planner, registry
from .context import Runtime, resolve_device

__all__ = ["Runtime", "resolve_device", "planner", "registry"]
