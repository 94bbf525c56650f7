"""The paper's §4.2 analog on the port: Q-learning with an MLP function
approximator, whose learned policy is then evaluated through the
SPx-quantized matmul (``spx_matmul``: the hand-written kernel on the card).

The environment is the reference's self-contained numpy cart-pole
(pole balancing, 4-dim state, 2 actions; ``examples/rl_qlearning.py`` at
the root of the repository), copied here: the role Acrobot-v1 plays in the
paper, a control loop whose policy evaluation is MLP inference at the
edge. The (4, 64, 64, 2) ReLU Q-network trains with AdamW (lr 1e-3) from a
replay buffer of 10000 transitions, batches of 64, gamma 0.99, epsilon
decaying by 0.97 per episode to 0.05. Exploration and replay sampling draw
from a seeded ``random.Random``; the weights from a seeded
``torch.Generator``.

    python -m repro_torch.examples.rl_qlearning [--episodes 120] [--device cpu]
"""
from __future__ import annotations

import argparse
import collections
import random

import numpy as np
import torch

from repro_torch.benchmarks.timing import device_label
from repro_torch.models.mlp_mnist import mlp_net_apply, mlp_net_init
from repro_torch.nn.layers import quantize_params
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.training import make_optimizer, value_and_grad

__all__ = ["CartPole", "train_step", "main", "Q_LAYERS", "GAMMA"]

Q_LAYERS = (4, 64, 64, 2)
GAMMA = 0.99


class CartPole:
    """Minimal cart-pole (Barto-Sutton dynamics), 200-step episodes: the
    reference's, verbatim."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)
        self.state = None

    def reset(self):
        self.state = self.rng.uniform(-0.05, 0.05, 4)
        self.t = 0
        return self.state.copy()

    def step(self, action):
        x, x_dot, th, th_dot = self.state
        force = 10.0 if action == 1 else -10.0
        costh, sinth = np.cos(th), np.sin(th)
        temp = (force + 0.05 * th_dot ** 2 * sinth) / 1.1
        th_acc = (9.8 * sinth - costh * temp) / \
            (0.5 * (4.0 / 3.0 - 0.1 * costh ** 2 / 1.1))
        x_acc = temp - 0.05 * th_acc * costh / 1.1
        dt = 0.02
        self.state = np.array([x + dt * x_dot, x_dot + dt * x_acc,
                               th + dt * th_dot, th_dot + dt * th_acc])
        self.t += 1
        done = (abs(self.state[0]) > 2.4 or abs(self.state[2]) > 0.21
                or self.t >= 200)
        return self.state.copy(), 1.0, done


def _q(params, s, rt=None):
    return mlp_net_apply(params, s, act=torch.relu, rt=rt)


def train_step(params, opt, state, s, a, r, s2, d, *, gamma: float = GAMMA):
    """One TD(0) step: the target ``r + gamma * max_a' Q(s2, a') * (1 - d)``
    held constant, the MSE of ``Q(s, a)`` against it differentiated and
    applied with ``opt``. Returns (params, state, loss)."""
    with torch.no_grad():
        target = r + gamma * _q(params, s2).amax(dim=-1) * (1.0 - d)

    def loss_fn(p):
        q_sa = _q(p, s).gather(-1, a[:, None].long())[:, 0]
        return torch.mean((q_sa - target) ** 2)

    loss, grads = value_and_grad(loss_fn, params)
    params, state = opt.update(params, grads, state)
    return params, state, loss


def main(argv=None, device=None) -> dict:
    """Train for ``--episodes``, then evaluate the greedy policy over 10
    trials in float32, sp2_8 and sp2_4 (``min_size=256``). Returns
    ``{"returns": [...], "eval": {scheme: average return}}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    rnd = random.Random(args.seed)
    env = CartPole(args.seed)
    qnet = mlp_net_init(torch.Generator(device=device).manual_seed(args.seed),
                        Q_LAYERS, device=device)
    opt = make_optimizer("adamw", lr=1e-3)
    state = opt.init(qnet)
    buffer: collections.deque = collections.deque(maxlen=10000)
    eps = 1.0

    def as_t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    print(f"== Q-learning, {args.episodes} episodes on "
          f"{device_label(device)} ==")
    returns = []
    for ep in range(args.episodes):
        s = env.reset()
        total, done = 0.0, False
        while not done:
            if rnd.random() < eps:
                a = rnd.randrange(2)
            else:
                with torch.no_grad():
                    a = int(torch.argmax(_q(qnet, as_t(s[None],
                                                       torch.float32))))
            s2, r, done = env.step(a)
            buffer.append((s, a, r, s2, float(done)))
            s = s2
            total += r
            if len(buffer) >= 128:
                bs, ba, br, bs2, bd = map(np.array,
                                          zip(*rnd.sample(buffer, 64)))
                qnet, state, _ = train_step(
                    qnet, opt, state, as_t(bs, torch.float32),
                    as_t(ba, torch.int64), as_t(br, torch.float32),
                    as_t(bs2, torch.float32), as_t(bd, torch.float32))
        eps = max(0.05, eps * 0.97)
        returns.append(total)
        if (ep + 1) % 20 == 0:
            print(f"episode {ep + 1}: avg return (last 20) "
                  f"{np.mean(returns[-20:]):.1f} eps={eps:.2f}")

    print("\n== quantized policy evaluation (the paper's edge-inference "
          "setting) ==")
    rt = Runtime(device=str(device))
    evals = {}
    for scheme in (None, "sp2_8", "sp2_4"):
        qp = quantize_params(qnet, scheme, min_size=256) if scheme else qnet
        trials = []
        for trial in range(10):
            env_eval = CartPole(1000 + trial)
            s = env_eval.reset()
            done, total = False, 0.0
            while not done:
                with torch.no_grad():
                    q = _q(qp, as_t(s[None], torch.float32), rt)
                s, r, done = env_eval.step(int(torch.argmax(q[0])))
                total += r
            trials.append(total)
        evals[scheme or "float32"] = float(np.mean(trials))
        print(f"  {scheme or 'float32':8s}: avg return "
              f"{evals[scheme or 'float32']:.1f}")
    return {"returns": returns, "eval": evals}


if __name__ == "__main__":
    main()
