"""Segmentation losses on NCDHW logits — the port of
fast_nnunet_tpu/training/losses.py (which works channels-last).

Shapes: logits (B, K, *S); a label target is (B, *S) integers, a region
target (B, R, *S) one-hot maps; a loss mask is (B, *S) (1 = include). All
arithmetic is float32, whatever the logits' dtype. Parity targets, as in the
JAX module: MemoryEfficientSoftDiceLoss (per-class sums from a scatter-add
over the labelmap, no one-hot target), RobustCrossEntropyLoss / TopKLoss,
DC_and_CE_loss / DC_and_BCE_loss with the ignore-label masking, and the
deep-supervision weights 1/2^i with the lowest resolution's weight zeroed,
normalised to sum 1. :func:`loss_of_kind` gives the loss variants of the
trainer variants (JAX trainer_variants.py:116-178).
"""
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------- dice sums
def _per_class_sums_from_labels(probs: Tensor, labels: Tensor,
                                num_classes: int,
                                loss_mask: Optional[Tensor]
                                ) -> Tuple[Tensor, Tensor, Tensor]:
    """probs (B, K, N) f32, labels (B, N) int -> (intersect, sum_pred,
    sum_gt), each (B, K); scatter-adds instead of a one-hot target."""
    if loss_mask is not None:
        m = loss_mask.to(probs.dtype)
        probs_m = probs * m[:, None]
        gt_vals = m
    else:
        probs_m = probs
        gt_vals = torch.ones(labels.shape, dtype=probs.dtype,
                             device=probs.device)
    labels = labels.long()
    gathered = probs_m.gather(1, labels[:, None]).squeeze(1)     # (B, N)
    zeros = probs.new_zeros((probs.shape[0], num_classes))
    intersect = zeros.scatter_add(1, labels, gathered)
    sum_gt = zeros.scatter_add(1, labels, gt_vals)
    sum_pred = probs_m.sum(-1)
    return intersect, sum_pred, sum_gt


def _per_class_sums_from_onehot(probs: Tensor, target: Tensor,
                                loss_mask: Optional[Tensor]
                                ) -> Tuple[Tensor, Tensor, Tensor]:
    """probs/target (B, K, N); target may hold overlapping regions."""
    t = target.to(probs.dtype)
    if loss_mask is not None:
        m = loss_mask.to(probs.dtype)[:, None]
        return (probs * t * m).sum(-1), (probs * m).sum(-1), (t * m).sum(-1)
    return (probs * t).sum(-1), probs.sum(-1), t.sum(-1)


def soft_dice_loss(logits: Tensor, target: Tensor,
                   loss_mask: Optional[Tensor] = None,
                   apply_nonlin: str = "softmax", batch_dice: bool = False,
                   do_bg: bool = False, smooth: float = 1e-5) -> Tensor:
    """-mean soft Dice (scalar)."""
    num_classes = logits.shape[1]
    x = logits.float()
    if apply_nonlin == "softmax":
        probs = torch.softmax(x, 1)
    elif apply_nonlin == "sigmoid":
        probs = torch.sigmoid(x)
    elif apply_nonlin is None or apply_nonlin == "none":
        probs = x
    else:
        raise ValueError(apply_nonlin)

    B = logits.shape[0]
    probs_f = probs.reshape(B, num_classes, -1)
    mask_f = loss_mask.reshape(B, -1) if loss_mask is not None else None
    if target.dim() == logits.dim() and target.shape[1] == num_classes:
        intersect, sum_pred, sum_gt = _per_class_sums_from_onehot(
            probs_f, target.reshape(B, num_classes, -1), mask_f)
    else:
        intersect, sum_pred, sum_gt = _per_class_sums_from_labels(
            probs_f, target.reshape(B, -1), num_classes, mask_f)

    if batch_dice:
        intersect, sum_pred, sum_gt = (intersect.sum(0), sum_pred.sum(0),
                                       sum_gt.sum(0))
    if not do_bg:
        intersect, sum_pred, sum_gt = (intersect[..., 1:], sum_pred[..., 1:],
                                       sum_gt[..., 1:])
    dc = (2 * intersect + smooth) / torch.clamp(sum_gt + sum_pred + smooth,
                                                min=1e-8)
    return -dc.mean()


# ---------------------------------------------------------------- cross entropy
def _per_voxel_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """(B, K, *S) logits, (B, *S) int labels -> (B, *S) f32 CE."""
    x = logits.float()
    lse = torch.logsumexp(x, 1)
    picked = x.gather(1, labels.long()[:, None]).squeeze(1)
    return lse - picked


def robust_cross_entropy(logits: Tensor, labels: Tensor,
                         ignore_index: Optional[int] = None) -> Tensor:
    """Mean CE over the voxels that are not ``ignore_index``."""
    if ignore_index is None:
        return _per_voxel_ce(logits, labels).mean()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    ce = _per_voxel_ce(logits, safe)
    denom = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, ce, torch.zeros_like(ce)).sum() / denom


def topk_cross_entropy(logits: Tensor, labels: Tensor, k_percent: float = 10.0,
                       ignore_index: Optional[int] = None,
                       label_smoothing: float = 0.0) -> Tensor:
    """Mean CE over the k% hardest voxels (ignored voxels count 0)."""
    def voxel_ce(lg, lb):
        ce = _per_voxel_ce(lg, lb)
        if label_smoothing > 0.0:
            x = lg.float()
            logp = x - torch.logsumexp(x, 1, keepdim=True)
            ce = (1.0 - label_smoothing) * ce \
                + label_smoothing * (-logp.mean(1))
        return ce

    if ignore_index is not None:
        mask = labels != ignore_index
        safe = torch.where(mask, labels, torch.zeros_like(labels))
        ce = voxel_ce(logits, safe)
        ce = torch.where(mask, ce, torch.zeros_like(ce))
    else:
        ce = voxel_ce(logits, labels)
    flat = ce.reshape(-1)
    n_keep = max(1, int(flat.shape[0] * k_percent / 100))
    return torch.topk(flat, n_keep).values.mean()


def binary_cross_entropy_with_logits(logits: Tensor, target: Tensor,
                                     loss_mask: Optional[Tensor] = None
                                     ) -> Tensor:
    x = logits.float()
    t = target.float()
    per = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    if loss_mask is None:
        return per.mean()
    m = loss_mask.float()[:, None]
    return (per * m).sum() / torch.clamp((m * torch.ones_like(per)).sum(),
                                         min=1e-8)


# ---------------------------------------------------------------- compound losses
def dc_and_ce_loss(logits: Tensor, target: Tensor, *, batch_dice: bool,
                   ignore_label: Optional[int] = None, weight_ce: float = 1.0,
                   weight_dice: float = 1.0, smooth: float = 1e-5) -> Tensor:
    """Label-based training loss: Dice without background, CE over all
    classes; ignore-label voxels are masked from Dice and skipped by CE."""
    if ignore_label is not None:
        mask = target != ignore_label
        target_dice = torch.where(mask, target, torch.zeros_like(target))
        dc = soft_dice_loss(logits, target_dice, loss_mask=mask,
                            batch_dice=batch_dice, do_bg=False, smooth=smooth)
        ce = robust_cross_entropy(logits, target, ignore_index=ignore_label)
        ce = torch.where(mask.sum() > 0, ce, torch.zeros_like(ce))
    else:
        dc = soft_dice_loss(logits, target, batch_dice=batch_dice,
                            do_bg=False, smooth=smooth)
        ce = robust_cross_entropy(logits, target)
    return weight_ce * ce + weight_dice * dc


def dc_and_bce_loss(logits: Tensor, target_regions: Tensor, *,
                    batch_dice: bool, has_ignore: bool = False,
                    weight_ce: float = 1.0, weight_dice: float = 1.0,
                    smooth: float = 1e-5) -> Tensor:
    """Region-based training loss. ``target_regions`` is (B, R[+1], *S);
    with ``has_ignore`` the last channel is the ignore mask (1 = ignore)."""
    if has_ignore:
        mask = 1.0 - target_regions[:, -1].float()
        target = target_regions[:, :-1]
    else:
        mask = None
        target = target_regions
    dc = soft_dice_loss(logits, target, loss_mask=mask, apply_nonlin="sigmoid",
                        batch_dice=batch_dice, do_bg=True, smooth=smooth)
    ce = binary_cross_entropy_with_logits(logits, target, loss_mask=mask)
    return weight_ce * ce + weight_dice * dc


LOSS_KINDS = ("ce", "dice", "topk10", "topk10_ls01", "dc_topk10",
              "dc_ce_nosmooth")


def loss_of_kind(kind: str, *, batch_dice: bool,
                 ignore_label: Optional[int] = None) -> Callable:
    """(logits, label target) -> scalar for a trainer variant's loss kind
    (:data:`LOSS_KINDS`), as the JAX ``_LossOverrideTrainer`` builds it;
    ``ignore_label`` is the label manager's ignore label when the dataset
    has one, else None."""
    ignore = ignore_label
    if kind == "ce":
        return lambda lg, t: robust_cross_entropy(lg, t, ignore_index=ignore)
    if kind == "dice":
        def dice(lg, t):
            if ignore is None:
                return soft_dice_loss(lg, t, batch_dice=batch_dice,
                                      do_bg=False)
            mask = t != ignore
            return soft_dice_loss(lg, torch.where(mask, t, torch.zeros_like(
                t)), loss_mask=mask, batch_dice=batch_dice, do_bg=False)
        return dice
    if kind == "topk10":
        return lambda lg, t: topk_cross_entropy(lg, t, 10.0,
                                                ignore_index=ignore)
    if kind == "topk10_ls01":
        return lambda lg, t: topk_cross_entropy(lg, t, 10.0,
                                                ignore_index=ignore,
                                                label_smoothing=0.1)
    if kind == "dc_topk10":
        return lambda lg, t: (
            soft_dice_loss(lg, t, batch_dice=batch_dice, do_bg=False)
            + topk_cross_entropy(lg, t, 10.0, ignore_index=ignore))
    if kind == "dc_ce_nosmooth":
        return lambda lg, t: dc_and_ce_loss(lg, t, batch_dice=batch_dice,
                                            ignore_label=ignore, smooth=0.0)
    raise ValueError(f"unknown loss kind {kind!r} (one of {LOSS_KINDS})")


# ---------------------------------------------------------------- deep supervision
def deep_supervision_weights(n_outputs: int) -> np.ndarray:
    """1/2^i per resolution, lowest-res weight zeroed, normalized to sum 1."""
    w = np.array([1 / (2 ** i) for i in range(n_outputs)])
    if n_outputs > 1:
        w[-1] = 0
    return w / w.sum()


def deep_supervised_loss(loss_fn: Callable, outputs: Sequence[Tensor],
                         targets: Sequence[Tensor],
                         weights: Optional[Sequence[float]] = None) -> Tensor:
    if weights is None:
        weights = deep_supervision_weights(len(outputs))
    total = 0.0
    for w, o, t in zip(weights, outputs, targets):
        if w != 0.0:
            total = total + w * loss_fn(o, t)
    return total


# ---------------------------------------------------------------- online metrics
def hard_tp_fp_fn(logits: Tensor, target: Tensor, num_classes: int,
                  ignore_label: Optional[int] = None,
                  regions: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class hard tp/fp/fn for the online pseudo-Dice, (K,) or (R,)
    float32 (background included for labels; the caller drops it)."""
    if regions:
        pred = torch.sigmoid(logits.float()) > 0.5
        if ignore_label is not None:
            m = 1.0 - target[:, -1:].float()
            t = target[:, :-1].float()
        else:
            m = torch.ones((logits.shape[0], 1) + tuple(logits.shape[2:]),
                           dtype=torch.float32, device=logits.device)
            t = target.float()
        p = pred.float() * m
        t = t * m
        dims = (0,) + tuple(range(2, t.dim()))
        return ((p * t).sum(dims), (p * (1 - t)).sum(dims),
                ((1 - p) * m * t).sum(dims))

    pred = logits.argmax(1)
    if ignore_label is not None:
        valid = target != ignore_label
        tgt = torch.where(valid, target, torch.zeros_like(target)).long()
    else:
        tgt = target.long()
        valid = torch.ones_like(tgt, dtype=torch.bool)
    pred_f, tgt_f = pred.reshape(-1), tgt.reshape(-1)
    valid_f = valid.reshape(-1).float()
    zeros = torch.zeros(num_classes, dtype=torch.float32,
                        device=logits.device)
    tp = zeros.scatter_add(0, tgt_f, valid_f * (pred_f == tgt_f).float())
    gt_count = zeros.scatter_add(0, tgt_f, valid_f)
    pred_count = zeros.scatter_add(0, pred_f, valid_f)
    return tp, pred_count - tp, gt_count - tp
