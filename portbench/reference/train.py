"""Plain reference of the training step: the mean squared error of the
rollout over every predicted frame, its gradient, the global gradient norm
clipped to the learning rate (scale min(1, lr / (norm + 1e-6))) and AdamW
(decoupled decay, bias-corrected moments, eps outside the square root).

`train_steps` works the batch through in blocks of rows so that a large
batch fits beside the attention scores, and sums the blocks' gradients at
their share of the batch: the same gradient as the whole batch at once.
"""

from __future__ import annotations

import torch


def mse(prediction, target):
    return ((target - prediction) ** 2).mean()


def batch_loss_and_grads(model, batch, rows: int):
    """(loss, {name: grad}) of the batch's mean squared error."""
    const, pres, prog, target = batch
    B = prog.shape[0]
    params = dict(model.named_parameters())
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    total = torch.zeros((), device=prog.device)
    for lo in range(0, B, rows):
        hi = min(B, lo + rows)
        part = [None if x is None else x[lo:hi] for x in (const, pres, prog)]
        loss = mse(model(*part), target[lo:hi]) * ((hi - lo) / B)
        g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        for n, gi in zip(params, g):
            if gi is not None:
                grads[n] += gi
        total += loss.detach()
    return total, grads


def clip_to(grads: dict, max_norm: float) -> dict:
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: g * scale for n, g in grads.items()}


class AdamW:
    """AdamW over named parameters, updated in place."""

    def __init__(self, params: dict, lr: float, weight_decay: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1**self.t, 1 - b2**self.t
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps))


def train_steps(model, batches, lr: float, weight_decay: float, clip: bool, rows: int):
    """Train `model` in place on `batches`; returns (losses, the first
    step's gradient as the optimizer takes it, {name: grad}), the losses
    a list of 0-d tensors."""
    params = dict(model.named_parameters())
    opt = AdamW(params, lr, weight_decay)
    losses, first = [], None
    for batch in batches:
        loss, grads = batch_loss_and_grads(model, batch, rows)
        if clip:
            grads = clip_to(grads, lr)
        if first is None:
            first = grads
        opt.step(grads)
        losses.append(loss)
    return losses, first
