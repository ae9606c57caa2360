"""optax's ``chain(clip_by_global_norm(clip), adamw(schedule, b1=0.9,
b2=0.999, eps=1e-8, weight_decay, mask=not logit_scale))`` with
``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))``,
written out in float32."""

from __future__ import annotations

import math

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def learning_rate(train: dict, count: int) -> float:
    peak, warmup = train["learning_rate"], train["warmup_steps"]
    total = max(train["total_steps"], warmup + 1)
    if count < warmup:
        return peak * count / warmup
    frac = min(count - warmup, total - warmup) / (total - warmup)
    return peak * 0.5 * (1.0 + math.cos(math.pi * frac))


class AdamW:
    def __init__(self, train: dict, params: dict):
        self.train = train
        self.clip = train.get("clip_norm", 1.0)
        self.decay = train.get("weight_decay", 0.01)
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        """Update ``params`` in place; returns the clipped gradients (what
        the moments were fed)."""
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
        factor = 1.0 if norm < self.clip else self.clip / norm
        lr = learning_rate(self.train, self.count)
        bc1, bc2 = 1.0 - B1 ** (self.count + 1), 1.0 - B2 ** (self.count + 1)
        fed = {}
        for k, p in params.items():
            g = grads[k] * factor
            fed[k] = g
            self.mu[k].mul_(B1).add_(g, alpha=1.0 - B1)
            self.nu[k].mul_(B2).add_(g * g, alpha=1.0 - B2)
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)
            if k != "logit_scale":
                u = u + self.decay * p
            p.sub_(lr * u)
        self.count += 1
        return fed
