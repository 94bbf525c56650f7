"""Procedural data the port needs: the paper's digits (numpy only)."""
from .mnist import SynthDigits, make_dataset

__all__ = ["SynthDigits", "make_dataset"]
