"""BatchNorm networks in the port (models/blocks.py ``BatchStatsNorm``,
``NNUNetTrainerBN``) against the JAX package's: the train step (batch
statistics, running averages moved once per step with the unbiased
variance) and the validation step (running averages) against JAX's
``mutable=["batch_stats"]`` step, losses within 1e-4 and parameters and
running averages within 1e-5; the evaluation-mode forward against JAX's
plain apply; the factory's refusal of BatchNorm under remat; checkpoints
with ``batch_stats`` both ways; and ``NNUNetTrainerBN`` end to end on the
CPU (train, final validation, predictor with the running averages, a
distillation from the BatchNorm teacher)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.training import checkpoint as jckpt
from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu.training import train_step as jstep
from fast_nnunet_tpu_torch.models import factory as pfactory
from fast_nnunet_tpu_torch.models.blocks import BatchStatsNorm
from fast_nnunet_tpu_torch.models.unet import params_from_jax, params_to_jax
from fast_nnunet_tpu_torch.training import checkpoint as pckpt
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched
from fast_nnunet_tpu_torch.training import train_step as pstep

from .test_torch_resenc import RESENC
from .test_torch_train_e2e import DS, env, short  # noqa: F401 (fixtures)
from .torch_port_common import (ARCH, K, ncdhw,  # noqa: F401 (fixture)
                                no_persistent_compile_cache)

PATCH = (16, 16, 16)
N_DS = 2
TOL = 1e-5
NETS = {"PlainConvUNet": ARCH, "ResidualEncoderUNet": RESENC}


def _bn(arch):
    return dict(arch, norm_op="torch.nn.modules.batchnorm.BatchNorm3d")


def bn_tree(cls, seed):
    """Seeded JAX-initialised variables of the BatchNorm ``cls`` with
    running averages away from (0, 1)."""
    jnet = jax_net(cls, _bn(NETS[cls]), (), 1, K)
    v = jax.tree_util.tree_map(np.asarray, jnet.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, *PATCH, 1))))
    rng = np.random.RandomState(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) * (a + 0.5)).astype(np.float32),
        v["batch_stats"])
    return v


def _port(cls, tree, **kw):
    net = pfactory.get_network_from_plans(cls, _bn(NETS[cls]), (), 1, K,
                                          compute_dtype=torch.float32, **kw)
    return params_from_jax(net, tree)


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *PATCH, 1).astype(np.float32)
    lab = rng.randint(0, K, (2, *PATCH)).astype(np.int32)
    x[..., 0] += lab
    jt = (lab, lab[:, ::2, ::2, ::2])
    return (x, jt, ncdhw(x),
            tuple(torch.from_numpy(t.astype(np.int64)) for t in jt))


def _assert_trees_close(a, b, tol=TOL):
    fb = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, b)))
    fa = jax.tree_util.tree_leaves_with_path(a)
    assert len(fa) == len(fb)
    for path, v in fa:
        np.testing.assert_allclose(v, fb[path], atol=tol, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("cls", sorted(NETS))
def test_bn_train_and_val_steps_match_jax(cls):
    tree = bn_tree(cls, 3)
    jnet = jax_net(cls, _bn(NETS[cls]), (), 1, K, dtype=jnp.float32)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, tree), opt_j)
    jtrain = jax.jit(jstep.make_train_step(jnet, opt_j, n_ds_levels=N_DS,
                                           compute_dtype=jnp.float32))
    jval = jax.jit(jstep.make_val_step(jnet, num_heads=K, n_ds_levels=N_DS,
                                       compute_dtype=jnp.float32))
    net = _port(cls, tree, trainable=True)
    opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10))
    ptrain = pstep.make_train_step(net, opt, n_ds_levels=N_DS)
    pval = pstep.make_val_step(net, num_heads=K, n_ds_levels=N_DS)
    for s in range(2):
        x, jt, px, pt = _batch(s)
        state, jloss = jtrain(state, jnp.asarray(x),
                              tuple(map(jnp.asarray, jt)))
        np.testing.assert_allclose(float(ptrain(px, pt)), float(jloss),
                                   rtol=1e-4)
    back = params_to_jax(net)
    assert sorted(back) == ["batch_stats", "params"]
    _assert_trees_close(back, state.params)
    x, jt, px, pt = _batch(7)
    jl, *jm = jval(state.params, jnp.asarray(x), tuple(map(jnp.asarray, jt)))
    pl, *pm = pval(px, pt)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-4)
    for a, b in zip(pm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    _assert_trees_close(params_to_jax(net), state.params)  # val moved none


def test_running_averages_move_exactly_once_per_step():
    """One train step: each BatchNorm sees one forward, and its running
    averages become 0.9 ra + 0.1 (batch mean, unbiased batch variance) of
    the input it saw, as torch's BatchNorm3d and the JAX module do."""
    cls = "ResidualEncoderUNet"
    tree = bn_tree(cls, 5)
    net = _port(cls, tree, trainable=True)
    norms = [m for m in net.modules() if isinstance(m, BatchStatsNorm)]
    seen = {id(m): [] for m in norms}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen[id(mod)].append(inp[0].detach().clone()))
        for m in norms]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10))
    _, _, px, pt = _batch(1)
    pstep.make_train_step(net, opt, n_ds_levels=N_DS)(px, pt)
    for h in hooks:
        h.remove()
    for m, (rm, rv) in zip(norms, before):
        assert len(seen[id(m)]) == 1
        x = seen[id(m)][0].double()
        dims = (0, 2, 3, 4)
        n = x.numel() // x.shape[1]
        mean = x.mean(dims)
        var = x.var(dims, correction=0) * n / (n - 1)
        torch.testing.assert_close(m.running_mean.double(),
                                   0.9 * rm.double() + 0.1 * mean,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(m.running_var.double(),
                                   0.9 * rv.double() + 0.1 * var,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls", sorted(NETS))
def test_eval_forward_uses_running_averages_like_jax(cls):
    tree = bn_tree(cls, 2)
    jnet = jax_net(cls, _bn(NETS[cls]), (), 1, K, dtype=jnp.float32)
    x = np.random.RandomState(4).randn(1, *PATCH, 1).astype(np.float32)
    ref = np.asarray(jnet.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(x)))
    net = _port(cls, tree).eval()
    with torch.no_grad():
        got = np.moveaxis(net(ncdhw(x)).numpy(), 1, -1)
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    before = params_to_jax(net)["batch_stats"]
    _assert_trees_close(before, tree["batch_stats"], tol=0)


def test_factory_builds_batchnorm_without_remat_only():
    kw = _bn(ARCH)
    net = pfactory.get_network_from_plans("PlainConvUNet", kw, (), 1, K)
    assert any(isinstance(m, BatchStatsNorm) for m in net.modules())
    with pytest.raises(ValueError, match="remat"):
        pfactory.get_network_from_plans("PlainConvUNet", kw, (), 1, K,
                                        remat=True)


def test_jax_reads_port_bn_checkpoint_and_port_reads_jax(tmp_path):
    cls = "ResidualEncoderUNet"
    tree = bn_tree(cls, 8)
    net = _port(cls, tree, trainable=True)
    opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10))
    step = pstep.make_train_step(net, opt, n_ds_levels=N_DS)
    _, _, px, pt = _batch(3)
    step(px, pt)
    fname = str(tmp_path / "bn.fnnx")
    pckpt.save_checkpoint(
        fname, network_weights=params_to_jax(net),
        optimizer_state=pckpt.optimizer_state_to_jax(opt, net),
        extras={"train_step": opt.count})
    ck = jckpt.load_checkpoint(fname)
    jnet = jax_net(cls, _bn(NETS[cls]), (), 1, K, dtype=jnp.float32)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, tree), opt_j)
    params = jckpt.restore_params(state.params, ck["network_weights"])
    opt_state = jckpt.restore_params(state.opt_state, ck["optimizer_state"])
    _assert_trees_close(params_to_jax(net), params, tol=0)
    # and back: the JAX tree into a fresh port network
    net2 = _port(cls, jax.tree_util.tree_map(np.asarray, params),
                 trainable=True)
    _assert_trees_close(params_to_jax(net2), params, tol=0)
    assert int(opt_state[-1]["count"] if isinstance(opt_state[-1], dict)
               else opt_state[-1].count) == 1


def test_bn_trainer_end_to_end_on_cpu(env, short):  # noqa: F811
    """``-tr nnUNetTrainerBN``: a BatchNorm network without remat, its
    running averages in the checkpoint, the final validation and
    ``NNUNetPredictor`` on the model folder normalising with them."""
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu_torch.run.run_training import run_training
    from fast_nnunet_tpu_torch.training.checkpoint import load_checkpoint
    trainer = run_training(DS, "3d_fullres", 0, "nnUNetTrainerBN",
                           device="cpu")
    assert type(trainer).__name__ == "NNUNetTrainerBN"
    assert trainer._use_remat() is False
    ck = load_checkpoint(os.path.join(trainer.output_folder,
                                      "checkpoint_final.fnnx"))
    stats = ck["network_weights"]["batch_stats"]
    var = stats["encoder"]["stage_0"]["block_0"]["norm"]["var"]
    assert not np.allclose(var, 1.0)   # moved by the training steps
    assert os.path.isfile(os.path.join(trainer.output_folder, "validation",
                                       "summary.json"))
    pred = NNUNetPredictor(device="cpu", use_mirroring=False,
                           compute_dtype=torch.float32)
    pred.initialize_from_trained_model_folder(trainer.output_folder_base, 0)
    (net,) = pred.engine.load_params(pred.list_of_parameters)
    assert any(isinstance(m, BatchStatsNorm) for m in net.modules())
    assert not net.training
    np.testing.assert_allclose(net.encoder.stages["stage_0"].blocks[
        "block_0"].norm.running_var.numpy(), var)
    data = np.random.RandomState(0).randn(1, 20, 22, 18).astype(np.float32)
    logits = pred.predict_logits_from_preprocessed_data(data)
    assert tuple(logits.shape[1:]) == (20, 22, 18) and \
        np.isfinite(np.asarray(logits)).all()
    # a BatchNorm teacher distils: its fold is rebuilt with BatchNorm
    from fast_nnunet_tpu_torch.run.distillation_train import \
        run_distillation_training
    student = run_distillation_training(
        DS, fold=1, teacher_folder=trainer.output_folder_base,
        teacher_folds=[0], num_epochs=1, device="cpu")
    (teacher,) = student.teachers
    assert any(isinstance(m, BatchStatsNorm) for m in teacher.modules())
    assert not teacher.training
    assert np.isfinite(student.logger.logging["train_distill_losses"][0])
