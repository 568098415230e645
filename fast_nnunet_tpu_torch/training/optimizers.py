"""Optimizers with the update rules of fast_nnunet_tpu/training/optimizers.py
(optax chains), on torch.optim.

``nnunet_sgd`` follows the optax chain in its order: clip the gradients'
global norm to ``grad_clip`` as optax does (g / |g| * clip when |g| > clip —
not ``torch.nn.utils.clip_grad_norm_``, which divides by |g| + 1e-6), then
torch SGD with ``weight_decay`` (g + wd * p), nesterov momentum (optax's
``trace(nesterov=True)``: m = g + mu * m, update g + mu * m) and the learning
rate of the schedule at optax's count (before its increment). Adam / AdamW
follow ``scale_by_adam`` (+ decoupled decay) the same way, ``vanilla_adam``
is ``optax.chain(clip, optax.adam(lr))`` and ``nnunet_adan`` is
``optax.chain(clip, optax.adan(lr, weight_decay=wd))`` (:class:`Adan`, the
optax update rule by hand: torch has no Adan).

The optimizers hold their step count (``count``) and ``layout``, the shape
of the optax chain's state: one entry per link, ``None`` for a stateless
link, "trace", "adam", "adan" or "count" (a learning-rate schedule's step)
for the others, a list for a nested chain. A checkpoint writes the optax
state from it and resumes it (training/checkpoint.py).
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
                 grad_clip: Optional[float], layout: list):
        self.inner = inner
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        self.layout = layout
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


def _schedule_link(learning_rate: Schedule):
    """optax's ``scale_by_learning_rate``: a schedule keeps a count."""
    return "count" if callable(learning_rate) else None


def _clip_link(grad_clip: Optional[float]) -> list:
    return [None] if grad_clip is not None else []


def nnunet_sgd(params: Iterable[torch.Tensor], learning_rate: Schedule,
               momentum: float = 0.99, weight_decay: float = 3e-5,
               nesterov: bool = True, grad_clip: Optional[float] = 12.0
               ) -> ChainedOptimizer:
    return ChainedOptimizer(
        torch.optim.SGD(list(params), lr=0.0, momentum=momentum,
                        weight_decay=weight_decay, nesterov=nesterov),
        learning_rate, grad_clip,
        _clip_link(grad_clip) + [None] * bool(weight_decay)
        + ["trace", _schedule_link(learning_rate)])


def nnunet_adamw(params: Iterable[torch.Tensor], learning_rate: Schedule,
                 weight_decay: float = 5e-2, b1: float = 0.9, b2: float = 0.98,
                 eps: float = 1e-8, grad_clip: Optional[float] = 1.0
                 ) -> ChainedOptimizer:
    return ChainedOptimizer(
        torch.optim.AdamW(list(params), lr=0.0, betas=(b1, b2), eps=eps,
                          weight_decay=weight_decay),
        learning_rate, grad_clip,
        _clip_link(grad_clip) + ["adam"] + [None] * bool(weight_decay)
        + [_schedule_link(learning_rate)])


def nnunet_adam(params: Iterable[torch.Tensor], learning_rate: Schedule,
                grad_clip: Optional[float] = 12.0) -> ChainedOptimizer:
    return ChainedOptimizer(
        torch.optim.Adam(list(params), lr=0.0), learning_rate, grad_clip,
        _clip_link(grad_clip) + ["adam", _schedule_link(learning_rate)])


def vanilla_adam(params: Iterable[torch.Tensor], learning_rate: Schedule,
                 grad_clip: float = 12.0) -> ChainedOptimizer:
    """``optax.chain(clip_by_global_norm(12), optax.adam(lr))``: the update
    of :func:`nnunet_adam`, the state nested one chain deeper."""
    return ChainedOptimizer(
        torch.optim.Adam(list(params), lr=0.0), learning_rate, grad_clip,
        [None, ["adam", _schedule_link(learning_rate)]])


class Adan(torch.optim.Optimizer):
    """optax's ``scale_by_adan`` -> ``add_decayed_weights`` -> learning
    rate (optax 0.2.6, alias.adan): m, v, n are the decayed averages of
    the gradient, of its change and of the squared corrected gradient, each
    bias-corrected at step t; the update is lr * ((m + (1 - b2) v) /
    (sqrt(n + eps_root) + eps) + wd * p). State per parameter: ``m``,
    ``v``, ``n`` and the previous gradient ``g``; the step ``t`` is the
    chain's count."""

    def __init__(self, params, b1: float = 0.98, b2: float = 0.92,
                 b3: float = 0.99, eps: float = 1e-8, eps_root: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=0.0, b1=b1, b2=b2, b3=b3, eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))
        self.t = 0

    @torch.no_grad()
    def step(self):
        t = self.t + 1
        for group in self.param_groups:
            b1, b2, b3 = group["b1"], group["b2"], group["b3"]
            c1, c2, c3 = 1 - b1 ** t, 1 - b2 ** t, 1 - b3 ** t
            for p in group["params"]:
                g = p.grad
                st = self.state[p]
                if not st:
                    for k in ("m", "v", "n", "g"):
                        st[k] = torch.zeros_like(p)
                diff = g - st["g"] if self.t else torch.zeros_like(g)
                st["m"].mul_(b1).add_((1 - b1) * g)
                st["v"].mul_(b2).add_((1 - b2) * diff)
                sq = g + (1 - b2) * diff
                st["n"].mul_(b3).add_((1 - b3) * sq.square())
                u = (st["m"] / c1 + (1 - b2) * (st["v"] / c2)) / (
                    torch.sqrt(st["n"] / c3 + group["eps_root"])
                    + group["eps"])
                p.sub_(group["lr"] * (u + group["weight_decay"] * p))
                st["g"].copy_(g)
        self.t = t


def nnunet_adan(params: Iterable[torch.Tensor], learning_rate: Schedule,
                weight_decay: float = 3e-5, grad_clip: float = 12.0
                ) -> ChainedOptimizer:
    """``optax.chain(clip_by_global_norm(12), optax.adan(lr,
    weight_decay=wd))``, the JAX Adan trainers' optimizer."""
    return ChainedOptimizer(
        Adan(list(params), weight_decay=weight_decay), learning_rate,
        grad_clip, [None, ["adan", None, _schedule_link(learning_rate)]])
