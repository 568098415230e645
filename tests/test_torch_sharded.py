"""Slab-parallel sharded inference in the port (inference/sharded.py) — the
counterparts of tests/test_sharded.py, on D = 2, 3 and 4 gloo ranks spawned
on the CPU (tests/torch_parallel_ranks.py), float32.

Against the port's single-card sweeps: rows outside the slab-boundary halo
are bit-equal, halo rows agree >= 0.99, and ``halo_exact`` is bit-identical
everywhere — the multi-hop case (owned rows < patch) included; the s2d
variant with its even-rounded ownership (kernels C and B through their plain
versions here), and the plain sweep with kernel D's plain version. Against
the JAX package: the port's multi-rank masks agree >= 0.999 with
``predict_segmentation_multichip{,_s2d}`` on a D-device CPU mesh given the
same seeded weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_nnunet_tpu.inference.engine import \
    SlidingWindowEngine as JaxEngine
from fast_nnunet_tpu.inference.sharded import (
    predict_segmentation_multichip, predict_segmentation_multichip_s2d)
from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.models.s2d import make_s2d_engine_net as jax_s2d_net
from fast_nnunet_tpu.ops.sliding_window import \
    compute_steps_for_sliding_window
from fast_nnunet_tpu_torch.models.s2d import random_plain_params
from fast_nnunet_tpu_torch.parallel import distributed as pdist

from . import torch_parallel_ranks as ranks
from .torch_port_common import no_persistent_compile_cache  # noqa: F401

K, PATCH = ranks.K, ranks.SHARD_PATCH
VOL = np.random.RandomState(0).rand(1, 40, 12, 12).astype(np.float32)
SMALL = np.random.RandomState(1).rand(1, 10, 9, 9).astype(np.float32)
TREES = {"plain": random_plain_params(ranks.SHARD_ARCH, 1, K, 0),
         "s2d": random_plain_params(ranks.S2D_ARCH, 1, K, 2)}
TREES["fused"] = TREES["plain"]
# (name, kind, tile batch, volume, halo_exact)
JOBS = [("plain", "plain", 4, VOL, False), ("plain_exact", "plain", 4, VOL, True),
        ("small", "plain", 2, SMALL, False),
        ("small_exact", "plain", 2, SMALL, True),
        ("fused", "fused", 4, VOL, False),
        ("s2d", "s2d", 4, VOL, False), ("s2d_exact", "s2d", 4, VOL, True)]


def _halo_rows(D, x_extent, even=False):
    """Rows that receive a neighbour's overhang: past each slab boundary,
    up to the end of the last tile starting left of it (the single sweep's
    grid; s2d: even-floored starts and even ownership)."""
    x_tight = max(x_extent, PATCH[0])
    starts = compute_steps_for_sliding_window((x_tight,), PATCH[:1], 0.5)[0]
    owned = -(-x_tight // D)
    if even:
        starts = [s - s % 2 for s in starts]
        owned += owned % 2
    rows = np.zeros(x_extent, bool)
    for d in range(1, D):
        boundary = d * owned
        spill = max((s + PATCH[0] for s in starts if s < boundary), default=0)
        rows[boundary:min(spill, x_extent)] = True
    return rows


@pytest.fixture(scope="module", params=[2, 3, 4])
def sweeps(request):
    """D ranks' masks of every job, and the single-card references."""
    D = request.param
    jobs = [(n, kind, tb, TREES[kind], vol, ex)
            for n, kind, tb, vol, ex in JOBS]
    masks = pdist.spawn(ranks.sharded_masks, D, device="cpu",
                        args=(jobs,))
    assert all(m is None for r in masks[1:] for m in r.values())
    single = {}
    for n, kind, tb, vol, _ in JOBS:
        eng, params = ranks.sharded_engine(kind, tb, TREES[kind])
        single[n] = eng.predict_segmentation_sweep_s2d(params, vol) \
            if kind == "s2d" else eng.predict_segmentation_sweep(params, vol)
    return D, masks[0], single


@pytest.mark.parametrize("job", ["plain", "small", "fused", "s2d"])
def test_non_halo_rows_bit_equal_halo_rows_agree(sweeps, job):
    D, multi, single = sweeps
    vol = SMALL if job == "small" else VOL
    seg, ref = multi[job], single[job]
    assert seg.shape == vol.shape[1:] and seg.dtype == np.uint8
    assert len(np.unique(ref)) == K
    halo = _halo_rows(D, vol.shape[1], even=job == "s2d")
    np.testing.assert_array_equal(seg[~halo], ref[~halo])
    if halo.any():
        assert (seg[halo] == ref[halo]).mean() >= 0.99
    assert (seg == ref).mean() >= 0.999


@pytest.mark.parametrize("job", ["plain_exact", "small_exact", "s2d_exact"])
def test_halo_exact_is_bit_identical(sweeps, job):
    """The wavefront: every row, halo included, equals the single sweep
    (small_exact: owned rows < patch, the overhang relayed over ranks)."""
    D, multi, single = sweeps
    np.testing.assert_array_equal(multi[job], single[job.split("_")[0]])


def _jax_mesh(D):
    return jax.sharding.Mesh(np.array(jax.devices()[:D]), ("space",))


def test_multigpu_matches_jax_multichip(sweeps):
    D, multi, _ = sweeps
    net = jax_net("PlainConvUNet", ranks.SHARD_ARCH, (), 1, K)
    eng = JaxEngine(net, PATCH, K, shape_bucket=4, compute_dtype=jnp.float32,
                    tile_batch=4)
    params = jax.tree_util.tree_map(jnp.asarray, TREES["plain"])
    for name, exact in (("plain", False), ("plain_exact", True)):
        want = predict_segmentation_multichip(eng, params, VOL, _jax_mesh(D),
                                              halo_exact=exact)
        assert (multi[name] == want).mean() >= 0.999, name


def test_multigpu_s2d_matches_jax_multichip_s2d(sweeps):
    D, multi, _ = sweeps
    net = jax_net("PlainConvUNet", ranks.S2D_ARCH, (), 1, K,
                  dtype=jnp.float32)
    s2d = jax_s2d_net(net, ranks.S2D_ARCH, K, dtype=jnp.float32)
    eng = JaxEngine(s2d, PATCH, K, shape_bucket=4, compute_dtype=jnp.float32,
                    sweep_acc_dtype=jnp.float32, tile_batch=4,
                    use_s2d_sweep=True)
    params = s2d.convert_params(jax.tree_util.tree_map(jnp.asarray,
                                                       TREES["s2d"]))
    want = predict_segmentation_multichip_s2d(eng, params, VOL, _jax_mesh(D))
    assert (multi["s2d"] == want).mean() >= 0.999


def test_space_groups_of_a_mesh():
    """A 2 x 2 (data, space) mesh of 4 ranks: each data row runs its own
    2-rank slab sweep over its space group; both rows' masks equal the
    single sweep outside the halo."""
    out = pdist.spawn(ranks.mesh_space_masks, 4, device="cpu",
                      args=(TREES["plain"], VOL))
    assert out[0]["groups"] == [[0, 1], [2, 3]]
    eng, params = ranks.sharded_engine("plain", 4, TREES["plain"])
    ref = eng.predict_segmentation_sweep(params, VOL)
    halo = _halo_rows(2, VOL.shape[1])
    for r in out:
        if r["position"][1] == 0:
            np.testing.assert_array_equal(r["mask"][~halo], ref[~halo])
        else:
            assert r["mask"] is None
