"""The port's trainer variants (training/trainer_variants.py), losses and
optimizers against the JAX package's: every reference trainer spelling
resolves to a port class with the JAX class's epochs, loss kind,
learning rate, weight decay, oversampling, deep supervision, batch size,
DA envelope and training transform, and whose optimizer makes the same
three updates as the JAX class's optax chain (1e-6); each loss kind against
the JAX loss (1e-5); Adam, AdamW, VanillaAdam and Adan against optax; and
their optimizer states across ``.fnnx`` checkpoints both ways (the JAX
package reads the port's state and continues from it, the port resumes
the JAX trainer's)."""
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_nnunet_tpu.run.run_training import \
    find_trainer_class as jax_find_trainer
from fast_nnunet_tpu.training import checkpoint as jckpt
from fast_nnunet_tpu.training import losses as jlosses
from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu_torch.models import factory as pfactory
from fast_nnunet_tpu_torch.models.unet import (from_flax_layout,
                                               jax_param_paths,
                                               params_from_jax,
                                               params_to_jax, to_flax_layout,
                                               tree_get)
from fast_nnunet_tpu_torch.run.run_training import find_trainer_class
from fast_nnunet_tpu_torch.training import checkpoint as pckpt
from fast_nnunet_tpu_torch.training import losses as plosses
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched

from .test_reference_spellings import REFERENCE_TRAINER_NAMES
from .test_torch_train_e2e import _plans
from .torch_port_common import (ARCH, K,  # noqa: F401 (fixture)
                                no_persistent_compile_cache, plain_params)

DATASET_JSON = {"channel_names": {"0": "CT"}, "file_ending": ".nii.gz",
                "labels": {"background": 0, "a": 1, "b": 2}}
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}


def _pair(name):
    plans = _plans([1.0, 1.0, 1.0])
    jt = jax_find_trainer(name)(copy.deepcopy(plans), "3d_fullres", 0,
                                DATASET_JSON)
    pt = find_trainer_class(name)(copy.deepcopy(plans), "3d_fullres", 0,
                                  DATASET_JSON, device="cpu")
    for t in (jt, pt):
        t.num_epochs = 4 if t.num_epochs > 100 else t.num_epochs
        t.num_iterations_per_epoch = 2
    return jt, pt


def _updates(jax_opt, port_factory, steps=3, scale=2.0, seed=0):
    """The parameters after ``steps`` updates with the same seeded
    gradients (a parameter tree of SHAPES), JAX and port."""
    rng = np.random.RandomState(seed)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jax_opt.init(jp)
    for g in grads:
        upd, state = jax_opt.update(
            {k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = port_factory(list(tp.values()))
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return ({k: np.asarray(v) for k, v in jp.items()},
            {k: p.detach().numpy() for k, p in tp.items()})


def test_every_name_is_tested():
    src = open(__file__.replace("test_torch_trainer_variants",
                                "test_reference_spellings")).read()
    listed = re.findall(r'^    "(\w+)",$', src, re.M)
    assert sorted(listed) == sorted(REFERENCE_TRAINER_NAMES)
    assert len(REFERENCE_TRAINER_NAMES) == 66


@pytest.mark.parametrize("name", REFERENCE_TRAINER_NAMES)
def test_reference_spelling_resolves_like_jax(name):
    jt, pt = _pair(name)
    assert type(pt).__name__.lower() == type(jt).__name__.lower()
    for attr in ("num_epochs", "initial_lr", "weight_decay",
                 "oversample_foreground_percent",
                 "probabilistic_oversampling", "enable_deep_supervision"):
        assert getattr(pt, attr) == getattr(jt, attr), attr
    assert pt.configuration_manager.batch_size == \
        jt.configuration_manager.batch_size
    assert pt.loss_kind == getattr(jt, "loss_kind", "dc_ce")
    patch = jt.configuration_manager.patch_size
    jenv = jt._configure_rotation_dummyDA_mirroring_and_initial_patch_size(
        patch)
    penv = pt._configure_rotation_dummyDA_mirroring_and_initial_patch_size(
        patch)
    assert repr(penv) == repr(jenv)
    rotation, dummy_2d, _, mirror = jenv
    args = (patch, rotation, mirror, dummy_2d, pt.label_manager,
            pt._get_deep_supervision_scales())
    jaug = jt._make_training_transform(*args[:4], jt.label_manager, args[5])
    paug = pt._make_training_transform(*args)
    assert type(paug).__name__ == type(jaug).__name__
    for attr in ("mirror_axes", "dummy_2d", "spatial_data_order",
                 "data_order", "seg_order", "patch_size"):
        assert getattr(paug, attr, None) == getattr(jaug, attr, None), attr
    assert pt.inference_allowed_mirroring_axes == \
        jt.inference_allowed_mirroring_axes
    # the optimizer: three updates of a small tree
    total = pt.num_epochs * pt.num_iterations_per_epoch

    def port_factory(ps):
        pt.network = torch.nn.ParameterList(ps)
        return pt.configure_optimizer(total)

    want, got = _updates(jt.configure_optimizer(total), port_factory)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name}: {k}")


def test_unknown_trainer_raises_and_lists_the_ported():
    with pytest.raises(NotImplementedError, match="NNUNetTrainerBN"):
        find_trainer_class("nnUNetTrainerDoesNotExist")


def test_primus_network_is_not_built():
    """Every Primus trainer builds a ``Primus`` with its class's dims at the
    plans' patch (built on the meta device: L has 0.3 G parameters), and
    its ``_init_args`` carry the JAX trainer's ``primus_arch``."""
    from fast_nnunet_tpu_torch.models.primus import Primus
    names = [n for n in REFERENCE_TRAINER_NAMES if "Primus" in n] + [
        "_Primus_S_96_BS1", "_Primus_B_96_BS1", "_Primus_M_96_BS1",
        "_Primus_L_48_BS1"]
    assert len(names) == 10
    for name in names:
        jt, pt = _pair(name)
        pt.num_input_channels = 1
        with torch.device("meta"):
            net = pt.build_network_architecture()
        assert isinstance(net, Primus), name
        assert (net.embed_dim, net.depth, net.num_heads) == (
            jt.embed_dim, jt.depth, jt.num_heads), name
        assert net.patch_size == tuple(jt.configuration_manager.patch_size)
        assert net.patch_embed_size == tuple(jt.patch_embed_size)
        assert net.num_classes == pt.label_manager.num_segmentation_heads
        assert net.trainable
        assert pt._init_args()["primus_arch"] == \
            jt._init_args()["primus_arch"], name


# ---------------------------------------------------------------- losses
def _logits_and_labels(seed, ignore):
    """K heads; labels in [0, K), the ignore label K on a slab."""
    rng = np.random.RandomState(seed)
    lg = rng.randn(2, 4, 6, 8, K).astype(np.float32) * 2
    lab = rng.randint(0, K, (2, 4, 6, 8)).astype(np.int32)
    if ignore is not None:
        lab[:, :1] = ignore
    return lg, lab


def _jax_loss(kind, lg, lab, ignore, batch_dice):
    """The JAX ``_LossOverrideTrainer`` base losses."""
    lg, lab = jnp.asarray(lg), jnp.asarray(lab)
    if kind == "ce":
        return jlosses.robust_cross_entropy(lg, lab, ignore_index=ignore)
    if kind == "dice":
        if ignore is not None:
            mask = lab != ignore
            return jlosses.soft_dice_loss(lg, jnp.where(mask, lab, 0),
                                          loss_mask=mask,
                                          batch_dice=batch_dice, do_bg=False)
        return jlosses.soft_dice_loss(lg, lab, batch_dice=batch_dice,
                                      do_bg=False)
    if kind == "topk10":
        return jlosses.topk_cross_entropy(lg, lab, 10.0, ignore_index=ignore)
    if kind == "topk10_ls01":
        return jlosses.topk_cross_entropy(lg, lab, 10.0, ignore_index=ignore,
                                          label_smoothing=0.1)
    if kind == "dc_topk10":
        return jlosses.soft_dice_loss(lg, lab, batch_dice=batch_dice,
                                      do_bg=False) + \
            jlosses.topk_cross_entropy(lg, lab, 10.0, ignore_index=ignore)
    return jlosses.dc_and_ce_loss(lg, lab, batch_dice=batch_dice,
                                  ignore_label=ignore, smooth=0.0)


# dc_topk10's dice takes the ignore label as a class index in the JAX
# package, so it is held without one
@pytest.mark.parametrize("kind,ignore", [
    (k, i) for k in plosses.LOSS_KINDS for i in (None, K)
    if not (k == "dc_topk10" and i is not None)])
@pytest.mark.parametrize("batch_dice", [False, True])
def test_loss_kind_matches_jax(kind, ignore, batch_dice):
    lg, lab = _logits_and_labels(3, ignore)
    want = float(_jax_loss(kind, lg, lab, ignore, batch_dice))
    fn = plosses.loss_of_kind(kind, batch_dice=batch_dice,
                              ignore_label=ignore)
    got = float(fn(torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(lg, -1, 1))), torch.from_numpy(lab.astype(np.int64))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- optimizers
OPTIMIZERS = {
    "adam": (lambda: jopt.nnunet_adam(jsched.poly_lr_jax(3e-4, 10)),
             lambda ps: popt.nnunet_adam(ps, psched.poly_lr(3e-4, 10))),
    "adamw": (lambda: jopt.nnunet_adamw(jsched.poly_lr_jax(3e-4, 10)),
              lambda ps: popt.nnunet_adamw(ps, psched.poly_lr(3e-4, 10))),
    "vanilla_adam": (
        lambda: optax.chain(optax.clip_by_global_norm(12.0),
                            optax.adam(jsched.poly_lr_jax(1e-2, 10))),
        lambda ps: popt.vanilla_adam(ps, psched.poly_lr(1e-2, 10))),
    "adan": (
        lambda: optax.chain(optax.clip_by_global_norm(12.0),
                            optax.adan(jsched.poly_lr_jax(1e-2, 10),
                                       weight_decay=3e-5)),
        lambda ps: popt.nnunet_adan(ps, psched.poly_lr(1e-2, 10))),
}


@pytest.mark.parametrize("scale", [5.0, 0.01])   # clip active / not
@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(kind, scale):
    jmake, pmake = OPTIMIZERS[kind]
    want, got = _updates(jmake(), pmake, steps=4, scale=scale)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def _net():
    net = pfactory.get_network_from_plans("PlainConvUNet", ARCH, (), 1, K,
                                          compute_dtype=torch.float32,
                                          trainable=True)
    return params_from_jax(net, plain_params(4))


def _grads(net, seed):
    """Seeded gradients of every parameter as a flax tree and set on the
    port's parameters."""
    rng = np.random.RandomState(seed)
    tree = {}
    for path, p, kind in jax_param_paths(net):
        g = (rng.randn(*p.shape) * 0.3).astype(np.float32)
        p.grad = torch.from_numpy(g.copy())   # the port clips in place
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = to_flax_layout(kind, g)
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_step(jax_opt, params, state, grads):
    upd, state = jax_opt.update(grads, state, params)
    return optax.apply_updates(params, upd), state


def _assert_close(net, jparams):
    flat = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams)))
    for path, v in jax.tree_util.tree_leaves_with_path(params_to_jax(net)):
        np.testing.assert_allclose(v, flat[path], rtol=1e-6, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_jax_reads_port_optimizer_checkpoint(kind, tmp_path):
    """Two port updates, the state written as ``.fnnx``, read by the JAX
    package into its chain's state; the next update agrees."""
    jmake, pmake = OPTIMIZERS[kind]
    net = _net()
    opt = pmake(list(net.parameters()))
    for s in range(2):
        _grads(net, s)
        opt.step()
    fname = str(tmp_path / "p.fnnx")
    pckpt.save_checkpoint(
        fname, network_weights=params_to_jax(net),
        optimizer_state=pckpt.optimizer_state_to_jax(opt, net),
        extras={"train_step": opt.count})
    ck = jckpt.load_checkpoint(fname)
    jax_opt = jmake()
    params = jax.tree_util.tree_map(jnp.asarray, ck["network_weights"])
    state = jckpt.restore_params(jax_opt.init(params), ck["optimizer_state"])
    grads = _grads(net, 2)
    opt.step()
    params, _ = _jax_step(jax_opt, params, state, grads)
    _assert_close(net, params)


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_port_resumes_jax_optimizer_checkpoint(kind, tmp_path):
    """Two JAX updates saved by the JAX package's ``save_checkpoint``, the
    port resumes weights and optimizer state; the next update agrees."""
    jmake, pmake = OPTIMIZERS[kind]
    net = _net()
    jax_opt = jmake()
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(net))
    state = jax_opt.init(params)
    for s in range(2):
        params, state = _jax_step(jax_opt, params, state, _grads(net, s))
    fname = str(tmp_path / "j.fnnx")
    jckpt.save_checkpoint(fname, network_weights=params,
                          optimizer_state=state, backend="pickle")
    ck = pckpt.load_checkpoint(fname)
    params_from_jax(net, ck["network_weights"])
    opt = pmake(list(net.parameters()))
    pckpt.optimizer_state_from_jax(opt, net, ck["optimizer_state"])
    assert opt.count == 2
    for path, p, lk in jax_param_paths(net):
        assert from_flax_layout(lk, tree_get(
            jax.tree_util.tree_map(np.asarray, params), path)).shape == \
            tuple(p.shape)
    grads = _grads(net, 2)
    opt.step()
    params, _ = _jax_step(jax_opt, params, state, grads)
    _assert_close(net, params)
