"""The port's optimizers and schedules against the JAX package's optax
chains (fast_nnunet_tpu/training/{optimizers,schedules}.py): the same
parameters and gradient sequence, three steps, float32. SGD follows
clip -> weight decay -> nesterov trace -> learning rate at optax's count;
the clip scales by 12 / |g| exactly as optax does."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fast_nnunet_tpu.training import optimizers as jopt
from fast_nnunet_tpu.training import schedules as jsched
from fast_nnunet_tpu_torch.training import optimizers as popt
from fast_nnunet_tpu_torch.training import schedules as psched

from .torch_port_common import no_persistent_compile_cache  # noqa: F401

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}


def _run(port_factory, jax_opt, grad_scale, steps=3, seed=0,
         unreached=()):
    """``unreached`` keys get no gradient in the port (``p.grad is None``)
    and zeros in JAX, as jax.grad gives for a parameter the loss skips."""
    rng = np.random.RandomState(seed)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * grad_scale).astype(np.float32)
              * (k not in unreached) for k, s in SHAPES.items()}
             for _ in range(steps)]

    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jax_opt.init(jp)
    for g in grads:
        upd, state = jax_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = port_factory(list(tp.values()))
    for g in grads:
        for k, p in tp.items():
            p.grad = None if k in unreached else torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.count == steps
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("grad_scale", [10.0, 0.05])
def test_nnunet_sgd_poly_matches_optax(grad_scale):
    """grad_scale 10: |g| ~ 40 > 12, the clip is active on every step."""
    _run(lambda ps: popt.nnunet_sgd(ps, psched.poly_lr(1e-2, 5)),
         jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 5)), grad_scale)


def test_unreached_parameter_decays_like_optax():
    """A deep-supervision head of weight 0 gets no gradient; optax still
    applies weight decay and momentum to it, and so does the port."""
    _run(lambda ps: popt.nnunet_sgd(ps, psched.poly_lr(1e-2, 5),
                                    weight_decay=0.1),
         jopt.nnunet_sgd(jsched.poly_lr_jax(1e-2, 5), weight_decay=0.1),
         10.0, unreached=("b",))


def test_sgd_without_clip_or_decay_matches_optax():
    _run(lambda ps: popt.nnunet_sgd(ps, 0.1, weight_decay=0.0,
                                    grad_clip=None, nesterov=False),
         jopt.nnunet_sgd(0.1, weight_decay=0.0, grad_clip=None,
                         nesterov=False), 1.0)


@pytest.mark.parametrize("grad_scale", [3.0, 0.01])
def test_adam_and_adamw_match_optax(grad_scale):
    _run(lambda ps: popt.nnunet_adam(ps, 1e-3),
         jopt.nnunet_adam(1e-3), grad_scale)
    _run(lambda ps: popt.nnunet_adamw(ps, 3e-4),
         jopt.nnunet_adamw(3e-4), grad_scale)


def test_clip_by_global_norm_is_optax_formula():
    rng = np.random.RandomState(3)
    g = [rng.randn(4, 3).astype(np.float32) * 9,
         rng.randn(7).astype(np.float32) * 9]
    want, _ = optax.clip_by_global_norm(12.0).update(
        [jnp.asarray(x) for x in g], optax.EmptyState())
    got = [torch.from_numpy(x.copy()) for x in g]
    norm = popt.clip_by_global_norm_(got, 12.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(
        [jnp.asarray(x) for x in g])), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        assert not np.allclose(a.numpy(), g[0] if a.shape == (4, 3) else g[1])


@pytest.mark.parametrize("name", ["poly", "warmup_poly", "warmup_cosine"])
def test_schedules_match_jax(name):
    steps = [0, 1, 4, 9, 10, 37, 99, 100, 150]
    if name == "poly":
        p, j = psched.poly_lr(1e-2, 100), jsched.poly_lr(1e-2, 100)
    elif name == "warmup_poly":
        p = psched.linear_warmup_poly(1e-3, 100, 10)
        j = jsched.linear_warmup_poly(1e-3, 100, 10)
    else:
        p = psched.linear_warmup_cosine(1e-3, 100, 10)
        j = jsched.linear_warmup_cosine(1e-3, 100, 10)
    # the JAX warm-up schedules compute in float32, the port's in float64
    np.testing.assert_allclose([p(s) for s in steps],
                               [float(j(s)) for s in steps], rtol=1e-6,
                               atol=1e-9)


def test_learning_rate_at_optax_count():
    """The first update uses the schedule at count 0, the n-th at n - 1."""
    lrs = []
    sched = psched.poly_lr(1.0, 4)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = popt.nnunet_sgd([p], lambda c: lrs.append(c) or sched(c),
                          grad_clip=None)
    for _ in range(3):
        p.grad = torch.ones(1)
        opt.step()
    assert lrs == [0, 1, 2]
    assert jax.device_get(jsched.poly_lr_jax(1.0, 4)(0)) == sched(0)
