"""Training: the optimizers of ``repro.training`` (SGD, AdamW, AdamW-Q8),
autograd over dense f32 params, SPx gradient compression, checkpoints and
the train loop with its watchdog."""
from .checkpoint import (latest_step, list_checkpoints, restore_checkpoint,
                         save_checkpoint)
from .compression import GradCompressor
from .grad import value_and_grad
from .optimizer import (Optimizer, clip_by_global_norm, global_norm,
                        make_optimizer)
from .train_loop import (StallDetected, StepWatchdog, TrainConfig, TrainLoop,
                         make_grad_accum_step)

__all__ = ["Optimizer", "make_optimizer", "global_norm",
           "clip_by_global_norm", "value_and_grad", "GradCompressor",
           "save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints", "TrainLoop", "TrainConfig", "StepWatchdog",
           "StallDetected", "make_grad_accum_step"]
