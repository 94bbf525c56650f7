"""Procedural data the port needs (numpy only): the paper's digits and the
Markov token stream of LM training."""
from .mnist import SynthDigits, make_dataset
from .tokens import TokenStream, markov_batch

__all__ = ["SynthDigits", "make_dataset", "TokenStream", "markov_batch"]
