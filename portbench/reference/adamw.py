"""AdamW in plain PyTorch: the optimizer half of the training reference.

One step, in float32: every gradient scaled by ``min(1, clip / (norm +
1e-9))`` with ``norm`` the gradients' global norm; the moments ``mu = b1
mu + (1 - b1) g`` and ``nu = b2 nu + (1 - b2) g²``; the update ``(mu / (1
- b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``, plus ``weight_decay · p`` on
matrices; ``p -= lr_t · update``. The learning rate rises linearly over
``warmup_steps`` (``lr · min(1, (t + 1) / warmup_steps)`` at step ``t``,
counted from 1) and then falls on a half cosine to ``min_lr_ratio · lr``
at ``total_steps``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(opt: dict, step: int) -> float:
    warm = min(1.0, (step + 1) / max(1, opt["warmup_steps"]))
    span = max(1, opt["total_steps"] - opt["warmup_steps"])
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"]) / span))
    lo = opt["min_lr_ratio"]
    return opt["lr"] * warm * (lo + (1 - lo) * 0.5 * (1 + math.cos(
        math.pi * prog)))


@torch.no_grad()
def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor], t: int,
         opt: dict) -> Dict[str, torch.Tensor]:
    """AdamW step ``t`` (from 1) on ``params``, ``mu`` and ``nu`` in
    place; returns the clipped gradients, which the moments took."""
    total = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    scale = torch.clamp(opt["grad_clip"] / (total + 1e-9), max=1.0)
    lr = lr_at(opt, t)
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    clipped = {}
    for name, p in params.items():
        g = grads[name].float() * scale
        clipped[name] = g
        mu[name].mul_(b1).add_(g, alpha=1 - b1)
        nu[name].mul_(b2).add_(g * g, alpha=1 - b2)
        upd = (mu[name] / c1) / (torch.sqrt(nu[name] / c2) + opt["eps"])
        if p.dim() >= 2:
            upd = upd + opt["weight_decay"] * p
        p.sub_(lr * upd)
    return clipped


__all__ = ["lr_at", "step"]
