"""The trainer's optimizer: optax.adam / optax.adamw as a
torch.optim.Optimizer (port of the optax chain the JAX trainer builds,
umeregrobust_tpu/train/trainer.py:225-226).

torch.optim.Adam computes the same update with its bias corrections in
float64 on the host; optax takes 1 - b^t in float32, which moves a
first step by 6.6e-6 of its size (at b2 = 0.999). This optimizer keeps
optax's arithmetic: per step t (int32 count)

    mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu
    u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)   [+ wd p]
    p  = p - lr u

with b1^t, b2^t float32 powers and the decay decoupled (added after the
moment scaling, optax.add_decayed_weights). State per parameter: "step"
(a float32 scalar tensor), "mu", "nu".
"""
from __future__ import annotations

import torch

from umeregrobust_tpu_torch.utils.profiling import host_read

__all__ = ["OptaxAdam"]


class OptaxAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                t = int(state["step"])
                mu, nu = state["mu"], state["nu"]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                # b^t as a float32 power of a float exponent, as optax's
                # jitted update takes it (an integer power rounds otherwise)
                f32 = dict(dtype=torch.float32, device=p.device)
                tt = torch.tensor(float(t), **f32)
                bc1 = 1 - torch.pow(torch.tensor(b1, **f32), tt)
                bc2 = 1 - torch.pow(torch.tensor(b2, **f32), tt)
                # three host scalars copied to the card
                host_read("optim.step", 3, device=p.device)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                if wd:
                    u = u + wd * p
                p.sub_(lr * u)
        return loss
