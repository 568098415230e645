"""Train and validation steps — the port of
fast_nnunet_tpu/training/train_step.py as plain functions over a module, an
optimizer and a batch (no jit, no mesh, no sharding; no loss scaling either:
bf16 has float32's range).

Batches are NCDHW: ``data`` (B, C, *patch) and ``targets`` a sequence of one
tensor per deep-supervision level, highest resolution first ((B, *S_l)
integer labels or (B, R[+1], *S_l) region maps), all on the network's device.

Data parallel (``group``, a process group; None: this process alone): each
rank steps on its slice of the global batch, and the step is the JAX step
on the whole batch — the losses take their global terms over the group
(training/losses.py), the gradients are averaged over the ranks after
backward with bucketed all-reduces (parallel/collectives.py
``average_gradients_``), and the returned loss is the global one. Every
rank then makes the same update, so the replicas stay bit-equal.
"""
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..parallel.collectives import (all_reduce_, average_gradients_,
                                    global_mean_)
from ..utils.profiling import phase
from .losses import (dc_and_bce_loss, dc_and_ce_loss, deep_supervision_weights,
                     deep_supervised_loss, hard_tp_fp_fn)


def make_loss_fn(*, has_regions: bool, has_ignore: bool,
                 ignore_label: Optional[int], batch_dice: bool,
                 group=None) -> Callable:
    """(logits, target) -> scalar, as nnUNetTrainer._build_loss."""
    if has_regions:
        def loss_fn(logits, target):
            return dc_and_bce_loss(logits, target, batch_dice=batch_dice,
                                   has_ignore=has_ignore, group=group)
    else:
        def loss_fn(logits, target):
            return dc_and_ce_loss(
                logits, target, batch_dice=batch_dice,
                ignore_label=ignore_label if has_ignore else None,
                group=group)
    return loss_fn


def ds_weights(n_ds_levels: int) -> Tuple[float, ...]:
    return tuple(deep_supervision_weights(n_ds_levels).tolist()) \
        if n_ds_levels > 1 else (1.0,)


def forward_loss(network, loss_fn, weights, data: torch.Tensor,
                 targets: Sequence[torch.Tensor]):
    """(outputs highest resolution first, deep-supervised loss)."""
    n_ds = len(weights)
    outputs = network(data, deep_supervision=n_ds > 1)
    if n_ds == 1:
        outputs = (outputs,)
    return outputs, deep_supervised_loss(loss_fn, outputs, targets, weights)


def make_train_step(network, optimizer, *, has_regions: bool = False,
                    has_ignore: bool = False, ignore_label: Optional[int] = None,
                    batch_dice: bool = False, n_ds_levels: int = 1,
                    loss_fn: Optional[Callable] = None,
                    skip_nonfinite: bool = False,
                    timer=None, group=None) -> Callable:
    """Returns step(data, targets) -> loss (a detached device scalar): one
    forward (the network in training mode: a BatchNorm takes the batch's
    statistics and moves its running averages once), backward and
    optimizer update of ``network`` in place. ``loss_fn`` (logits, target)
    -> scalar replaces the default loss of :func:`make_loss_fn` (a trainer
    variant's loss kind). ``skip_nonfinite``: the Primus trainers' NaN
    watchdog — a step whose loss is not finite makes no update, so the
    parameters, the optimizer's moments and its schedule count stay as
    they were (the JAX step's ``jnp.where(isfinite(loss), new, old)`` over
    the whole state); deciding it costs one host sync per step, and
    ``step.skipped`` counts such steps. ``step.timer`` (a
    ``utils.profiling.PhaseTimer``, or None; settable later) brackets the
    phases "forward_loss", "backward" and "optimizer". With ``group`` the
    watchdog reads the global loss, so every rank skips together (a
    ``loss_fn`` given here must take its global terms over the same
    group)."""
    if loss_fn is None:
        loss_fn = make_loss_fn(has_regions=has_regions, has_ignore=has_ignore,
                               ignore_label=ignore_label,
                               batch_dice=batch_dice, group=group)
    params = [p for p in network.parameters() if p.requires_grad]
    weights = ds_weights(n_ds_levels)

    def step(data: torch.Tensor, targets: Sequence[torch.Tensor]
             ) -> torch.Tensor:
        network.train()
        optimizer.zero_grad()
        with phase(step.timer, "forward_loss"):
            _, loss = forward_loss(network, loss_fn, weights, data, targets)
        with phase(step.timer, "backward"):
            loss.backward()
        loss = loss.detach()
        if group is not None:
            with phase(step.timer, "all_reduce"):
                average_gradients_(params, group)
                loss = global_mean_(loss.clone(), group)
        with phase(step.timer, "optimizer"):
            if skip_nonfinite and not bool(torch.isfinite(loss)):
                optimizer.zero_grad()
                step.skipped += 1
            else:
                optimizer.step()
        return loss

    step.timer = timer
    step.skipped = 0
    return step


def make_val_step(network, *, num_heads: int, has_regions: bool = False,
                  has_ignore: bool = False, ignore_label: Optional[int] = None,
                  batch_dice: bool = False, n_ds_levels: int = 1,
                  group=None) -> Callable:
    """Returns step(data, targets) -> (loss, tp, fp, fn): the tp/fp/fn are
    per-foreground-class sums of the highest-resolution output for the
    online pseudo-Dice (background dropped for labels). The network runs in
    evaluation mode (a BatchNorm normalises with its running averages).
    With ``group`` the loss is the global batch's and tp/fp/fn are summed
    over the ranks."""
    loss_fn = make_loss_fn(has_regions=has_regions, has_ignore=has_ignore,
                           ignore_label=ignore_label, batch_dice=batch_dice,
                           group=group)
    weights = ds_weights(n_ds_levels)

    @torch.no_grad()
    def step(data, targets):
        network.eval()
        outputs, loss = forward_loss(network, loss_fn, weights, data, targets)
        tp, fp, fn = hard_tp_fp_fn(
            outputs[0], targets[0], num_heads,
            ignore_label=ignore_label if has_ignore else None,
            regions=has_regions)
        if not has_regions:
            tp, fp, fn = tp[1:], fp[1:], fn[1:]
        if group is not None:
            loss = global_mean_(loss.clone(), group)
            n = len(tp)
            sums = all_reduce_(torch.cat([tp, fp, fn]), group)
            tp, fp, fn = sums[:n], sums[n:2 * n], sums[2 * n:]
        return loss, tp, fp, fn

    return step

