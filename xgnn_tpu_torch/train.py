"""Loss, optimizer and the train step.

The port of ``xgnn_tpu/train.py``: the masked cross-entropy over the first
``num_valid`` seeds, Adam with optax's defaults, and the skip-on-overflow
no-op update.  The skip stays on the device: ``torch.where(skip, old, new)``
over the params, both moments and the step count, so a step never waits on
the host to learn whether its batch overflowed.  That is why Adam is a
small function here and not ``torch.optim.Adam``, which needs the decision
on the host.  Params and moments are updated in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.nn import functional as F

from .types import Block


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, num_valid):
    """Masked softmax cross-entropy and accuracy over the first
    ``num_valid`` rows.  Labels are clipped into range for the loss, and
    compared unclipped for the accuracy."""
    n, c = logits.shape
    mask = (torch.arange(n, device=logits.device) < num_valid).float()
    safe = torch.clamp(labels, 0, c - 1).long()
    ll = F.cross_entropy(logits, safe, reduction="none")
    total = torch.clamp(torch.as_tensor(num_valid, device=logits.device)
                        .float(), min=1.0)
    loss = torch.sum(ll * mask) / total
    acc = torch.sum((torch.argmax(logits, -1) == labels).float() * mask) / total
    return loss, acc


class Adam:
    """optax.adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    correction by the step count."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             skip: Optional[torch.Tensor] = None):
        """One update; where ``skip`` (a bool scalar on the device) is True
        the params, moments and count keep their old values."""
        count = self.count + 1
        cf = count.float()
        bc1 = 1.0 - torch.pow(self.b1, cf)
        bc2 = 1.0 - torch.pow(self.b2, cf)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu_new = (1.0 - self.b1) * g + self.b1 * mu
            nu_new = (1.0 - self.b2) * (g * g) + self.b2 * nu
            upd = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
            p_new = p + (-self.lr) * upd
            if skip is not None:
                mu_new = torch.where(skip, mu, mu_new)
                nu_new = torch.where(skip, nu, nu_new)
                p_new = torch.where(skip, p, p_new)
            mu.copy_(mu_new)
            nu.copy_(nu_new)
            p.copy_(p_new)
        if skip is not None:
            count = torch.where(skip, self.count, count)
        self.count = count


def train_step(model, opt: Adam, blocks: Sequence[Block], x: torch.Tensor,
               labels: torch.Tensor, num_valid,
               generator: Optional[torch.Generator] = None,
               skip: Optional[torch.Tensor] = None) -> dict:
    """Forward, backward and update.  Returns device scalars ``loss`` (NaN
    for a skipped step) and ``acc``; nothing here waits on the device."""
    logits = model(blocks, x, train=True, generator=generator)
    loss, acc = loss_fn(logits, labels, num_valid)
    grads = torch.autograd.grad(loss, opt.params)
    opt.step(grads, skip)
    loss = loss.detach()
    if skip is not None:
        loss = torch.where(skip, torch.full_like(loss, float("nan")), loss)
    return {"loss": loss, "acc": acc.detach()}
