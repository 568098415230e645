"""The port's train, validation and distillation steps against the JAX
package's jitted steps (fast_nnunet_tpu/training/{train_step,distill}.py):
the same seeded weights (params_from_jax) and batch, float32 compute, the
one-pass InstanceNorm (its 16^3 full-resolution statistics through kernel
A's plain version on the CPU), deep supervision, SGD nesterov with clip 12
and a poly learning rate. Loss, updated parameters and tp/fp/fn agree
within 1e-5 (float32 convolutions summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.training import distill as jdistill
from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu.training import train_step as jstep
from fast_nnunet_tpu_torch.models import factory as pfactory
from fast_nnunet_tpu_torch.models.students import build_student_arch_kwargs
from fast_nnunet_tpu_torch.models.unet import params_from_jax, params_to_jax
from fast_nnunet_tpu_torch.training import distill as pdistill
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched
from fast_nnunet_tpu_torch.training import train_step as pstep

from .torch_port_common import (ARCH, K,  # noqa: F401  (fixture)
                                no_persistent_compile_cache, plain_params)

PATCH = (16, 16, 16)
N_DS = 2       # 3 stages: two deep-supervision levels (16^3, 8^3)
STEPS = 2
TOL = 1e-5


def _batch(seed: int, in_ch: int = 1, regions: bool = False):
    """Channels-last JAX batch and its NCDHW port twin."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *PATCH, in_ch).astype(np.float32)
    lab = rng.randint(0, K, (2, *PATCH)).astype(np.int32)
    lab[:, 4:10, 4:10, 4:10] = 1
    x[..., 0] += lab
    half = lab[:, ::2, ::2, ::2]
    jt = (lab, half)
    pt = tuple(torch.from_numpy(t.astype(np.int64)) for t in jt)
    return x, jt, torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, 1))), pt


def _port_net(arch, tree, k=K):
    net = pfactory.get_network_from_plans(
        "PlainConvUNet", arch, (), 1, k, compute_dtype=torch.float32,
        norm_onepass=True, trainable=True)
    return params_from_jax(net, tree)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_trees_close(port_tree, jax_tree, tol=TOL):
    flat_p = jax.tree_util.tree_leaves_with_path(port_tree)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jax_tree)))
    assert len(flat_p) == len(flat_j)
    for path, v in flat_p:
        np.testing.assert_allclose(v, flat_j[path], atol=tol, rtol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_and_val_step_match_jax():
    tree = plain_params(7)
    jnet = jax_net("PlainConvUNet", ARCH, (), 1, K, dtype=jnp.float32,
                   norm_onepass=True)
    sched_j = jsched.poly_lr_jax(1e-2, 10)
    opt_j = jopt.nnunet_sgd(sched_j)
    state = jstep.create_train_state(_jax_tree(tree), opt_j)
    jtrain = jax.jit(jstep.make_train_step(jnet, opt_j, n_ds_levels=N_DS,
                                           compute_dtype=jnp.float32))
    jval = jax.jit(jstep.make_val_step(jnet, num_heads=K, n_ds_levels=N_DS,
                                       compute_dtype=jnp.float32))

    net = _port_net(ARCH, tree)
    opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10))
    ptrain = pstep.make_train_step(net, opt, n_ds_levels=N_DS)
    pval = pstep.make_val_step(net, num_heads=K, n_ds_levels=N_DS)

    for s in range(STEPS):
        x, jt, px, pt = _batch(s)
        state, jloss = jtrain(state, jnp.asarray(x), tuple(map(jnp.asarray,
                                                               jt)))
        ploss = ptrain(px, pt)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=TOL)
    _assert_trees_close(params_to_jax(net), state.params)

    x, jt, px, pt = _batch(9)
    jl, jtp, jfp, jfn = jval(state.params, jnp.asarray(x),
                             tuple(map(jnp.asarray, jt)))
    pl, ptp, pfp, pfn = pval(px, pt)
    np.testing.assert_allclose(float(pl), float(jl), rtol=TOL)
    for a, b in ((ptp, jtp), (pfp, jfp), (pfn, jfn)):
        assert a.shape == (K - 1,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_distill_step_matches_jax():
    """Two teacher folds averaged, student r = 2, alpha 0.3, T 3.0."""
    student_arch = build_student_arch_kwargs(ARCH, 2)
    s_tree = plain_params(3, arch=student_arch)
    t_trees = [plain_params(10 + f) for f in range(2)]
    alpha, temp = 0.3, 3.0

    snet_j = jax_net("PlainConvUNet", student_arch, (), 1, K,
                     dtype=jnp.float32, norm_onepass=True)
    tnet_j = jax_net("PlainConvUNet", ARCH, (), 1, K, dtype=jnp.float32,
                     norm_onepass=True)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(_jax_tree(s_tree), opt_j)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                     *[_jax_tree(t) for t in t_trees])
    jdstep = jax.jit(jdistill.make_distill_train_step(
        snet_j, tnet_j, opt_j, alpha=alpha, temperature=temp,
        n_ds_levels=N_DS, n_teachers=2, compute_dtype=jnp.float32))

    snet = _port_net(student_arch, s_tree)
    teachers = []
    for t in t_trees:
        tn = pfactory.get_network_from_plans(
            "PlainConvUNet", ARCH, (), 1, K, compute_dtype=torch.float32,
            norm_onepass=True)
        teachers.append(params_from_jax(tn, t))
    opt = popt.nnunet_sgd(snet.parameters(), psched.poly_lr(1e-2, 10))
    pdstep = pdistill.make_distill_train_step(
        snet, teachers, opt, alpha=alpha, temperature=temp, n_ds_levels=N_DS)

    for s in range(STEPS):
        x, jt, px, pt = _batch(20 + s)
        state, jtot, jseg, jd = jdstep(state, stacked, jnp.asarray(x),
                                       tuple(map(jnp.asarray, jt)))
        ptot, pseg, pd = pdstep(px, pt)
        for a, b in ((ptot, jtot), (pseg, jseg), (pd, jd)):
            np.testing.assert_allclose(float(a), float(b), rtol=TOL,
                                       atol=1e-7)
    _assert_trees_close(params_to_jax(snet), state.params)


@pytest.mark.parametrize("n_teachers", [1, 3])
def test_teacher_ensemble_is_the_fold_mean(n_teachers):
    """ensemble_teacher_logits: the float32 mean of the folds' logits, in
    fold order, with no gradient."""
    nets = []
    for f in range(n_teachers):
        tn = pfactory.get_network_from_plans(
            "PlainConvUNet", ARCH, (), 1, K, compute_dtype=torch.float32,
            norm_onepass=True)
        nets.append(params_from_jax(tn, plain_params(30 + f)))
    x = torch.from_numpy(np.random.RandomState(4).randn(
        1, 1, *PATCH).astype(np.float32)).requires_grad_()
    got = pdistill.ensemble_teacher_logits(nets, x)
    with torch.no_grad():
        outs = [n(x) for n in nets]
    want = outs[0]
    for o in outs[1:]:
        want = want + o
    assert not got.requires_grad and got.dtype == torch.float32
    torch.testing.assert_close(got, want / n_teachers, rtol=0, atol=0)
