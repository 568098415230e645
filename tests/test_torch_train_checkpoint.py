"""``.fnnx`` training checkpoints across the two packages: the JAX package's
``load_checkpoint`` + ``restore_params`` read what the port writes (weights
and the optax SGD state, momentum trace included), the port resumes from
what the JAX trainer writes, and a resumed port step equals the
uninterrupted one bit for bit."""
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
from fast_nnunet_tpu_torch.models.unet import (params_from_jax,
                                               params_to_jax, tree_to_jax)
from fast_nnunet_tpu_torch.training import checkpoint as pckpt
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched
from fast_nnunet_tpu_torch.training import train_step as pstep

from .torch_port_common import (ARCH, K,  # noqa: F401  (fixture)
                                no_persistent_compile_cache, plain_params)

PATCH = (16, 16, 16)


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *PATCH, 1).astype(np.float32)
    lab = rng.randint(0, K, (2, *PATCH)).astype(np.int32)
    return (x, (lab, lab[:, ::2, ::2, ::2]),
            torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
            (torch.from_numpy(lab.astype(np.int64)),
             torch.from_numpy(lab[:, ::2, ::2, ::2].astype(np.int64))))


def _port(tree, grad_clip=12.0, weight_decay=3e-5):
    net = pfactory.get_network_from_plans(
        "PlainConvUNet", ARCH, (), 1, K, compute_dtype=torch.float32,
        norm_onepass=True, trainable=True)
    params_from_jax(net, tree)
    opt = popt.nnunet_sgd(net.parameters(), psched.poly_lr(1e-2, 10),
                          weight_decay=weight_decay, grad_clip=grad_clip)
    return net, opt, pstep.make_train_step(net, opt, n_ds_levels=2)


def _save_port(fname, net, opt):
    pckpt.save_checkpoint(
        fname, network_weights=params_to_jax(net),
        optimizer_state=pckpt.optimizer_state_to_jax(opt, net),
        current_epoch=3,
        logging={"train_losses": [1.0, 0.5]}, best_ema=0.25,
        init_args={"fold": 0}, inference_allowed_mirroring_axes=(0, 1, 2),
        extras={"train_step": opt.count})


def _assert_tree_equal(a, b):
    fa = jax.tree_util.tree_leaves_with_path(a)
    fb = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, b)))
    assert len(fa) == len(fb)
    for path, v in fa:
        np.testing.assert_array_equal(np.asarray(v), fb[path],
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("clip,decay", [(12.0, 3e-5), (None, 0.0)])
def test_jax_reads_port_checkpoint(tmp_path, clip, decay):
    """The optax chain state's shape follows the chain's links: with clip
    and decay the trace is link 2, without them link 0."""
    net, opt, step = _port(plain_params(1), clip, decay)
    for s in range(2):
        _, _, px, pt = _batch(s)
        step(px, pt)
    fname = str(tmp_path / "port.fnnx")
    _save_port(fname, net, opt)

    ckpt = jckpt.load_checkpoint(fname)
    template = jax.tree_util.tree_map(jnp.asarray, plain_params(0))
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10),
                            weight_decay=decay, grad_clip=clip)
    params = jckpt.restore_params(template, ckpt["network_weights"])
    opt_state = jckpt.restore_params(opt_j.init(template),
                                     ckpt["optimizer_state"])
    _assert_tree_equal(params_to_jax(net), params)
    trace = [s for s in opt_state if hasattr(s, "trace")][0].trace
    momentum = tree_to_jax(net, lambda p: opt.inner.state[p][
        "momentum_buffer"])
    _assert_tree_equal(momentum, trace)
    assert any(np.abs(np.asarray(v)).max() > 0
               for v in jax.tree_util.tree_leaves(trace))
    assert int(opt_state[-1].count) == 2 == ckpt["train_step"]
    assert ckpt["current_epoch"] == 3 and ckpt["_best_ema"] == 0.25


def test_port_resumes_jax_checkpoint(tmp_path):
    """Two JAX train steps, saved by the JAX writer; the port loads weights,
    momentum and count, and its third step matches JAX's third within
    1e-5."""
    tree = plain_params(2)
    jnet = jax_net("PlainConvUNet", ARCH, (), 1, K, dtype=jnp.float32,
                   norm_onepass=True)
    opt_j = jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 10))
    state = jstep.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, tree), opt_j)
    jtrain = jax.jit(jstep.make_train_step(jnet, opt_j, n_ds_levels=2,
                                           compute_dtype=jnp.float32))
    for s in range(2):
        x, jt, _, _ = _batch(10 + s)
        state, _ = jtrain(state, jnp.asarray(x), tuple(map(jnp.asarray, jt)))
    fname = str(tmp_path / "jax.fnnx")
    jckpt.save_checkpoint(fname, network_weights=state.params,
                          optimizer_state=jax.device_get(state.opt_state),
                          current_epoch=1,
                          extras={"train_step": int(state.step)})

    net, opt, step = _port(plain_params(0))
    ckpt = pckpt.load_checkpoint(fname)
    params_from_jax(net, ckpt["network_weights"])
    pckpt.optimizer_state_from_jax(opt, net, ckpt["optimizer_state"])
    assert opt.count == 2
    _assert_tree_equal(params_to_jax(net), state.params)
    _assert_tree_equal(tree_to_jax(net, lambda p: opt.inner.state[p][
        "momentum_buffer"]), state.opt_state[2].trace)

    x, jt, px, pt = _batch(12)
    state, jloss = jtrain(state, jnp.asarray(x), tuple(map(jnp.asarray, jt)))
    ploss = step(px, pt)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    for path, v in jax.tree_util.tree_leaves_with_path(params_to_jax(net)):
        want = dict(jax.tree_util.tree_leaves_with_path(
            jax.tree_util.tree_map(np.asarray, state.params)))[path]
        np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-5)


def test_resumed_step_equals_uninterrupted(tmp_path):
    tree = plain_params(3)
    net_a, opt_a, step_a = _port(tree)
    for s in range(3):
        step_a(*_batch(20 + s)[2:])

    net_b, opt_b, step_b = _port(tree)
    for s in range(2):
        step_b(*_batch(20 + s)[2:])
    fname = str(tmp_path / "mid.fnnx")
    _save_port(fname, net_b, opt_b)

    net_c, opt_c, step_c = _port(plain_params(4))
    ckpt = pckpt.load_checkpoint(fname)
    params_from_jax(net_c, ckpt["network_weights"])
    pckpt.optimizer_state_from_jax(opt_c, net_c, ckpt["optimizer_state"])
    step_c(*_batch(22)[2:])
    assert opt_c.count == opt_a.count == 3
    for a, c in zip(net_a.parameters(), net_c.parameters()):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_fresh_optimizer_writes_zero_trace(tmp_path):
    """Before the first step the momentum is written as zeros (optax's
    initial trace), with count 0."""
    net, opt, _ = _port(plain_params(5))
    state = pckpt.optimizer_state_to_jax(opt, net)
    assert set(state) == {"0", "1", "2", "3"} and state["0"] == {}
    assert int(state["3"]["count"]) == 0
    assert all(float(np.abs(v).max()) == 0
               for v in jax.tree_util.tree_leaves(state["2"]["trace"]))
