"""Optimizers with the update rules of fast_nnunet_tpu/training/optimizers.py
(optax chains), on torch.optim.

``nnunet_sgd`` follows the optax chain in its order: clip the gradients'
global norm to ``grad_clip`` as optax does (g / |g| * clip when |g| > clip —
not ``torch.nn.utils.clip_grad_norm_``, which divides by |g| + 1e-6), then
torch SGD with ``weight_decay`` (g + wd * p), nesterov momentum (optax's
``trace(nesterov=True)``: m = g + mu * m, update g + mu * m) and the learning
rate of the schedule at optax's count (before its increment). Adam / AdamW
follow ``scale_by_adam`` (+ decoupled decay) the same way.

The optimizers hold their step count (``count``), so a checkpoint can write
the optax state and resume it (training/checkpoint.py).
"""
from typing import Callable, Iterable, Optional, Union

import torch

Schedule = Union[float, Callable[[int], float]]


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place on a list of gradient tensors;
    returns the global norm (a device scalar, no host sync)."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class ChainedOptimizer:
    """A torch optimizer behind optax's clip -> update -> learning-rate
    chain: ``zero_grad()``, backward, then ``step()``."""

    def __init__(self, inner: torch.optim.Optimizer, learning_rate: Schedule,
                 grad_clip: Optional[float]):
        self.inner = inner
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        self.count = 0

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def lr(self, count: Optional[int] = None) -> float:
        c = self.count if count is None else count
        return float(self.learning_rate(c)) if callable(self.learning_rate) \
            else float(self.learning_rate)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        # a parameter the loss does not reach (a deep-supervision head of
        # weight 0) has a zero gradient under jax.grad: optax still decays
        # it and updates its trace, torch would skip it
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip is not None:
            clip_by_global_norm_([p.grad for p in self.params], self.grad_clip)
        lr = self.lr()
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1


def nnunet_sgd(params: Iterable[torch.Tensor], learning_rate: Schedule,
               momentum: float = 0.99, weight_decay: float = 3e-5,
               nesterov: bool = True, grad_clip: Optional[float] = 12.0
               ) -> ChainedOptimizer:
    return ChainedOptimizer(
        torch.optim.SGD(list(params), lr=0.0, momentum=momentum,
                        weight_decay=weight_decay, nesterov=nesterov),
        learning_rate, grad_clip)


def nnunet_adamw(params: Iterable[torch.Tensor], learning_rate: Schedule,
                 weight_decay: float = 5e-2, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-8, grad_clip: Optional[float] = 1.0
                 ) -> ChainedOptimizer:
    return ChainedOptimizer(
        torch.optim.AdamW(list(params), lr=0.0, betas=(b1, b2), eps=eps,
                          weight_decay=weight_decay),
        learning_rate, grad_clip)


def nnunet_adam(params: Iterable[torch.Tensor], learning_rate: Schedule,
                grad_clip: Optional[float] = 12.0) -> ChainedOptimizer:
    return ChainedOptimizer(torch.optim.Adam(list(params), lr=0.0),
                            learning_rate, grad_clip)
