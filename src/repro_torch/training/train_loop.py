"""The training loop (``repro.training.train_loop``): the step with
gradient accumulation, clipping and optional SPx gradient compression,
periodic checkpoints, resume after a failure, and a stall watchdog.

Fault model, as in the reference:
  * process death or preemption: a restart resumes from the latest
    committed checkpoint (``checkpoint.py``); ``kill_at_step`` injects it.
    The resumed run first draws the batches the restored steps took (the
    reference's loop does not), so a seeded stream gives it the batches,
    and the losses, of an unbroken run.
  * a stalled step: ``StepWatchdog`` tracks an EMA of step times and
    raises ``StallDetected`` for a step over ``stall_factor`` x the EMA;
    the loop checkpoints and carries on.

PyTorch runs eagerly: the reference's ``jax.jit`` and buffer donation
have no counterpart (the optimizers update params and moments in place).
Each step blocks on its loss with ``.item()``, as the reference's
``block_until_ready``, so its time is the device's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.nn.layers import tree_leaves, tree_map

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .compression import GradCompressor
from .grad import value_and_grad
from .optimizer import Optimizer, clip_by_global_norm

__all__ = ["TrainLoop", "StepWatchdog", "StallDetected", "TrainConfig",
           "make_grad_accum_step"]


class StallDetected(RuntimeError):
    pass


class StepWatchdog:
    """EMA step-time tracker; flags stragglers and stalls."""

    def __init__(self, stall_factor: float = 5.0, warmup: int = 3,
                 min_stall_s: float = 1.0):
        self.stall_factor = stall_factor
        self.warmup = warmup
        self.min_stall_s = min_stall_s
        self.ema = None
        self.n = 0
        self.stalls = 0

    def observe(self, dt: float):
        self.n += 1
        if self.n <= self.warmup:
            self.ema = dt if self.ema is None else 0.5 * (self.ema + dt)
            return
        threshold = max(self.stall_factor * self.ema, self.min_stall_s)
        if dt > threshold:
            self.stalls += 1
            raise StallDetected(
                f"step took {dt:.2f}s vs EMA {self.ema:.2f}s "
                f"(factor {self.stall_factor})")
        self.ema = 0.9 * self.ema + 0.1 * dt


@dataclasses.dataclass
class TrainConfig:
    max_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    grad_clip: float = 1.0
    accum_steps: int = 1
    compress_grads: str | None = None   # e.g. "sp2_8"
    kill_at_step: int | None = None     # fault injection


def make_grad_accum_step(loss_fn: Callable, opt: Optimizer, *,
                         accum_steps: int = 1, grad_clip: float = 1.0,
                         compressor: GradCompressor | None = None, rt=None):
    """The train step: (params, opt_state, ef, batch) -> (params,
    opt_state, ef, metrics). ``loss_fn(params, batch)`` returns (loss,
    metrics) (with ``rt``: ``loss_fn(params, batch, rt)``). With
    ``accum_steps > 1`` the batch's leading dim is split into that many
    microbatches whose gradients are summed in f32 and averaged; with a
    compressor the gradients are SPx-quantized with error feedback; then
    they are clipped to ``grad_clip`` global norm and the optimizer
    updates the params in place."""
    if rt is not None:
        inner_loss = loss_fn
        loss_fn = lambda params, batch: inner_loss(params, batch, rt)

    def step(params, opt_state, ef, batch):
        if accum_steps == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                    has_aux=True)
        else:
            micro = {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree_map(lambda _, p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, metricses = [], []
            for i in range(accum_steps):
                (l, m), g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in micro.items()},
                    has_aux=True)
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b.to(torch.float32))
                losses.append(l)
                metricses.append(m)
            grads = tree_map(lambda _, g: g / accum_steps, grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        if compressor is not None:
            grads, ef = compressor.compress(grads, ef)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, ef, dict(metrics, loss=loss, gnorm=gnorm)

    return step


class TrainLoop:
    """Drives steps with checkpoint/restart and the watchdog. Generic over
    the model: ``loss_fn(params, batch)`` (or ``(params, batch, rt)`` with
    ``rt``), an Optimizer, a function that makes the initial params, and an
    iterator of numpy batches (moved to the params' device each step)."""

    def __init__(self, loss_fn, opt: Optimizer, init_params_fn, data_iter,
                 cfg: TrainConfig, *,
                 compressor: GradCompressor | None = None, rt=None):
        self.cfg = cfg
        self.opt = opt
        self.init_params_fn = init_params_fn
        self.data = data_iter
        self.compressor = compressor
        self._step = make_grad_accum_step(
            loss_fn, opt, accum_steps=cfg.accum_steps,
            grad_clip=cfg.grad_clip, compressor=compressor, rt=rt)
        self.watchdog = StepWatchdog()
        self.history: list[dict] = []

    def init_or_restore(self):
        """(params, opt_state, ef, first step): fresh, or the latest
        committed checkpoint of ``cfg.ckpt_dir``."""
        params = self.init_params_fn()
        device = tree_leaves(params)[0].device
        opt_state = self.opt.init(params)
        ef = (self.compressor.init(params) if self.compressor
              else torch.zeros((), device=device))
        start = 0
        if self.cfg.ckpt_dir and latest_step(self.cfg.ckpt_dir) is not None:
            (params, opt_state, ef), start, _ = restore_checkpoint(
                self.cfg.ckpt_dir, (params, opt_state, ef))
            print(f"[train] resumed from step {start}")
        return params, opt_state, ef, start

    def _save(self, step_i, params, opt_state, ef):
        save_checkpoint(self.cfg.ckpt_dir, step_i, (params, opt_state, ef),
                        keep=self.cfg.keep_ckpts)

    def run(self):
        """Train to ``cfg.max_steps``. Returns (params, history): one
        {"step", "loss", "dt"} record per step taken."""
        params, opt_state, ef, start = self.init_or_restore()
        device = tree_leaves(params)[0].device
        # a resumed run replays the data stream past the batches the
        # restored steps took, so it sees the batches an unbroken run sees
        # (a departure: repro's loop restarts its stream on a resume)
        for _ in range(start):
            next(self.data)
        step_i = start
        while step_i < self.cfg.max_steps:
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in next(self.data).items()}
            t0 = time.monotonic()
            if (self.cfg.kill_at_step is not None
                    and step_i == self.cfg.kill_at_step):
                raise KeyboardInterrupt(
                    f"fault injection: killed at step {step_i}")
            params, opt_state, ef, metrics = self._step(params, opt_state,
                                                        ef, batch)
            loss = metrics["loss"].item()
            dt = time.monotonic() - t0
            step_i += 1
            try:
                self.watchdog.observe(dt)
            except StallDetected as e:
                print(f"[watchdog] {e}; checkpointing and continuing")
                if self.cfg.ckpt_dir:
                    self._save(step_i, params, opt_state, ef)
            rec = {"step": step_i, "loss": loss, "dt": dt}
            self.history.append(rec)
            if step_i % self.cfg.log_every == 0:
                print(f"[train] step {step_i} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)")
            if (self.cfg.ckpt_dir and self.cfg.ckpt_every
                    and step_i % self.cfg.ckpt_every == 0):
                self._save(step_i, params, opt_state, ef)
        if self.cfg.ckpt_dir:
            self._save(step_i, params, opt_state, ef)
        return params, self.history
