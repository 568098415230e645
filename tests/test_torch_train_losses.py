"""The port's training losses and online metrics (NCDHW logits) against
fast_nnunet_tpu/training/losses.py (channels-last) on the same seeded
numpy inputs: soft Dice, robust / top-k / binary cross-entropy, the
compound DC+CE and DC+BCE losses with the ignore label, regions and
batch_dice, the deep-supervision weighting, hard tp/fp/fn and the
distillation KL. rtol 1e-5 (float32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.training import distill as jdistill
from fast_nnunet_tpu.training import losses as jl
from fast_nnunet_tpu_torch.training import distill as pdistill
from fast_nnunet_tpu_torch.training import losses as pl

from .torch_port_common import no_persistent_compile_cache  # noqa: F401

K = 4
SHAPE = (2, 6, 5, 7)    # (B, *S)
IGNORE = 3              # labels 0..2 plus the ignore label
RTOL = 1e-5


def _logits(seed=0, k=K):
    return np.random.RandomState(seed).randn(*SHAPE, k).astype(np.float32) * 2


def _labels(seed=1, k=K, ignore=False):
    lab = np.random.RandomState(seed).randint(0, k - 1 if ignore else k,
                                              SHAPE)
    if ignore:
        lab[:, :2] = IGNORE
    return lab.astype(np.int32)


def _regions(seed=2, r=3, ignore=False):
    rng = np.random.RandomState(seed)
    t = (rng.rand(*SHAPE, r) > 0.6).astype(np.float32)
    if ignore:
        t = np.concatenate([t, (rng.rand(*SHAPE, 1) > 0.8).astype(
            np.float32)], -1)
    return t


def cl(x):
    """channels-last numpy -> NCDHW tensor"""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("do_bg", [False, True])
def test_soft_dice_labels(batch_dice, do_bg):
    x, lab = _logits(), _labels()
    _close(pl.soft_dice_loss(cl(x), t(lab), batch_dice=batch_dice,
                             do_bg=do_bg),
           jl.soft_dice_loss(jnp.asarray(x), jnp.asarray(lab),
                             batch_dice=batch_dice, do_bg=do_bg))


@pytest.mark.parametrize("nonlin", ["sigmoid", "none"])
def test_soft_dice_onehot_with_mask(nonlin):
    x, tgt = _logits(3, 3), _regions(4)
    mask = (np.random.RandomState(5).rand(*SHAPE) > 0.3).astype(np.float32)
    _close(pl.soft_dice_loss(cl(x), cl(tgt), loss_mask=t(mask),
                             apply_nonlin=nonlin, do_bg=True),
           jl.soft_dice_loss(jnp.asarray(x), jnp.asarray(tgt),
                             loss_mask=jnp.asarray(mask),
                             apply_nonlin=nonlin, do_bg=True))


@pytest.mark.parametrize("ignore", [False, True])
def test_robust_cross_entropy(ignore):
    x, lab = _logits(), _labels(ignore=ignore)
    idx = IGNORE if ignore else None
    _close(pl.robust_cross_entropy(cl(x), t(lab), ignore_index=idx),
           jl.robust_cross_entropy(jnp.asarray(x), jnp.asarray(lab),
                                   ignore_index=idx))


@pytest.mark.parametrize("ignore,smoothing", [(False, 0.0), (True, 0.0),
                                              (False, 0.1)])
def test_topk_cross_entropy(ignore, smoothing):
    x, lab = _logits(6), _labels(7, ignore=ignore)
    idx = IGNORE if ignore else None
    _close(pl.topk_cross_entropy(cl(x), t(lab), k_percent=10.0,
                                 ignore_index=idx,
                                 label_smoothing=smoothing),
           jl.topk_cross_entropy(jnp.asarray(x), jnp.asarray(lab), 10.0,
                                 ignore_index=idx,
                                 label_smoothing=smoothing))


@pytest.mark.parametrize("masked", [False, True])
def test_binary_cross_entropy_with_logits(masked):
    x, tgt = _logits(8, 3), _regions(9)
    mask = (np.random.RandomState(10).rand(*SHAPE) > 0.5).astype(
        np.float32) if masked else None
    _close(pl.binary_cross_entropy_with_logits(
        cl(x), cl(tgt), None if mask is None else t(mask)),
        jl.binary_cross_entropy_with_logits(
            jnp.asarray(x), jnp.asarray(tgt),
            None if mask is None else jnp.asarray(mask)))


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("ignore", [False, True])
def test_dc_and_ce_loss(batch_dice, ignore):
    x, lab = _logits(11), _labels(12, ignore=ignore)
    il = IGNORE if ignore else None
    _close(pl.dc_and_ce_loss(cl(x), t(lab), batch_dice=batch_dice,
                             ignore_label=il),
           jl.dc_and_ce_loss(jnp.asarray(x), jnp.asarray(lab),
                             batch_dice=batch_dice, ignore_label=il))


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("ignore", [False, True])
def test_dc_and_bce_loss_regions(batch_dice, ignore):
    x, tgt = _logits(13, 3), _regions(14, ignore=ignore)
    _close(pl.dc_and_bce_loss(cl(x), cl(tgt), batch_dice=batch_dice,
                              has_ignore=ignore),
           jl.dc_and_bce_loss(jnp.asarray(x), jnp.asarray(tgt),
                              batch_dice=batch_dice, has_ignore=ignore))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_deep_supervised_loss(n):
    np.testing.assert_array_equal(pl.deep_supervision_weights(n),
                                  jl.deep_supervision_weights(n))
    xs = [_logits(20 + i)[:, ::2 ** i, ::2 ** i, ::2 ** i] for i in range(n)]
    labs = [_labels(30 + i)[:, ::2 ** i, ::2 ** i, ::2 ** i]
            for i in range(n)]

    def pfn(a, b):
        return pl.dc_and_ce_loss(a, b, batch_dice=False)

    def jfn(a, b):
        return jl.dc_and_ce_loss(a, b, batch_dice=False)

    _close(pl.deep_supervised_loss(pfn, [cl(x) for x in xs],
                                   [t(y) for y in labs]),
           jl.deep_supervised_loss(jfn, [jnp.asarray(x) for x in xs],
                                   [jnp.asarray(y) for y in labs]))


@pytest.mark.parametrize("regions,ignore", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_hard_tp_fp_fn(regions, ignore):
    if regions:
        x, tgt = _logits(40, 3), _regions(41, ignore=ignore)
        pt, jt, k = cl(tgt), jnp.asarray(tgt), 3
    else:
        x, tgt = _logits(40), _labels(41, ignore=ignore)
        pt, jt, k = t(tgt), jnp.asarray(tgt), K
    il = IGNORE if ignore else None
    got = pl.hard_tp_fp_fn(cl(x), pt, k, ignore_label=il, regions=regions)
    want = jl.hard_tp_fp_fn(jnp.asarray(x), jt, k, ignore_label=il,
                            regions=regions)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_distillation_loss(temperature):
    s, te = _logits(50), _logits(51)
    _close(pdistill.distillation_loss(cl(s), cl(te), temperature),
           jdistill.distillation_loss(jnp.asarray(s), jnp.asarray(te),
                                      temperature))


def test_losses_take_bf16_logits_in_float32():
    """bf16 logits are promoted once; the loss equals the float32 loss of
    the rounded logits."""
    x, lab = _logits(60), _labels(61)
    xb = cl(x).to(torch.bfloat16)
    got = pl.dc_and_ce_loss(xb, t(lab), batch_dice=False)
    want = pl.dc_and_ce_loss(xb.float(), t(lab), batch_dice=False)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
