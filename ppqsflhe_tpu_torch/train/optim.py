"""``optax.adam`` in torch, safe to capture in a CUDA graph.

The JAX trainer's optimizer is ``optax.adam(lr)`` (``scale_by_adam`` then
``scale(-lr)``, ``ppqsflhe_tpu/train/trainer.py:105``). :class:`OptaxAdam`
computes that update literally:

    mu ← (1 − b1)·g + b1·mu          nu ← (1 − b2)·g² + b2·nu
    mû = mu / (1 − b1^t)             nû = nu / (1 − b2^t)
    p ← p + (−lr) · mû / (√nû + eps)

with one step count t per parameter group (optax keeps one for the whole
tree), a float32 tensor on the parameters' device. A step reads nothing
back to the host, so the step that a CUDA graph captures
(:mod:`.compiled`) is the one that runs eagerly on the CPU.
``torch.optim.Adam`` does not do for both: by default it reads its step
count on the host every step, and with ``capturable=True`` it refuses CPU
parameters.
"""

from __future__ import annotations

import torch


class OptaxAdam(torch.optim.Optimizer):
    """optax's Adam over ``params`` (``p.grad`` in, updated in place).
    State per parameter: ``mu`` and ``nu``; per group: ``count``."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        for group in self.param_groups:
            group["count"] = torch.zeros((), dtype=torch.float32,
                                         device=group["params"][0].device)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            b1, b2, count = group["b1"], group["b2"], group["count"]
            count.add_(1.0)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            mu_hat = torch._foreach_div(mus, 1.0 - torch.pow(b1, count))
            nu_hat = torch._foreach_div(nus, 1.0 - torch.pow(b2, count))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mu_hat, denom)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)
