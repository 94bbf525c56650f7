"""Training of the paper's MLP and the Q-network: the optimizers of
``repro.training.optimizer`` and autograd over dense f32 params."""
from .grad import value_and_grad
from .optimizer import (Optimizer, clip_by_global_norm, global_norm,
                        make_optimizer)

__all__ = ["Optimizer", "make_optimizer", "global_norm",
           "clip_by_global_norm", "value_and_grad"]
