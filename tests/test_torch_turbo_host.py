"""The port's TurboPipeline host route (CPU, fp32, kernels through their
plain versions) against the JAX package's, and against itself: the
streamed lazy route and the fused host route each >= 0.999 with JAX's (the
JAX side runs the same host library, the port's build, through its own
ctypes binding); streamed bit-equal to fused with air skip off, for two
folds and on an all-air CT; air skipping confined to air; the host
revert voxel-identical to the device revert; the 6-bit pack byte-equal to
JAX's; float input on the device route."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from fast_nnunet_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from fast_nnunet_tpu.inference.turbo import TurboConfig as JaxConfig
from fast_nnunet_tpu.inference.turbo import TurboPipeline as JaxPipeline
from fast_nnunet_tpu.inference.turbo import _unpack_mask6 as jax_unpack
from fast_nnunet_tpu_torch.inference import turbo as turbo_module
from fast_nnunet_tpu_torch.inference.engine import (PhaseTimer,
                                                    SlidingWindowEngine)
from fast_nnunet_tpu_torch.inference.turbo import (TurboConfig, TurboPipeline,
                                                   _unpack_mask6, pack_mask6)
from fast_nnunet_tpu_torch.ops import _build

from .torch_port_common import (K, PATCH,  # noqa: F401  (fixture)
                                no_persistent_compile_cache, s2d_pair)

#: the port's own crop bucket, before small_crop_bucket patches it
PIPELINE_CROP_BUCKET = turbo_module.CROP_BUCKET
CFG = dict(patch_size=(16, 8, 8), target_spacing=(1.0, 1.1, 1.05),
           mean=127.475, std=318.463, lower_bound=-1024.0, upper_bound=3071.0,
           num_classes=K)


@pytest.fixture(scope="module")
def nets():
    jnet, tnet, tree = s2d_pair(seed=0)
    _, _, tree2 = s2d_pair(seed=1)
    jeng = JaxEngine(jnet, PATCH, K, tile_step_size=0.5, shape_bucket=4,
                     compute_dtype=jnp.float32, sweep_acc_dtype=jnp.float32,
                     tile_batch=2, use_s2d_sweep=True)
    teng = SlidingWindowEngine(tnet, PATCH, K, shape_bucket=4,
                               compute_dtype=torch.float32,
                               sweep_acc_dtype=torch.float32, tile_batch=2,
                               device="cpu")
    return jeng, teng, tree, tree2


@pytest.fixture(autouse=True)
def small_crop_bucket(monkeypatch):
    """The port's crop extents round up to 4 voxels, as the JAX pipeline's
    in ``_jpipe``: the small test volumes then have off-bucket crop
    boxes."""
    monkeypatch.setattr(turbo_module, "CROP_BUCKET", 4)


@pytest.fixture
def jax_hostops(monkeypatch):
    """The JAX package's hostops module pointed at the port's built library
    for this test only: its module state is patched and restored, so a
    later JAX test in the same worker sees the state it had."""
    from fast_nnunet_tpu.utils import hostops as jh
    path = _build.host_library()._name
    monkeypatch.setattr(jh, "_CANDIDATES", (path,))
    monkeypatch.setattr(jh, "_LIB", None)
    monkeypatch.setattr(jh, "_TRIED", False)
    assert jh.available() and jh.has_box()
    return jh


def _vol():
    # >= 2 x-chunks; an off-bucket body box exercises the crop reinsertion
    rng = np.random.RandomState(21)
    vol = np.full((30, 44, 26), -1000, np.int16)
    vol[5:25, 7:39, 5:21] = (rng.rand(20, 32, 16) * 500 - 100).astype(
        np.int16)
    return vol, (1.0, 1.0, 1.0)


def _air_vol():
    # a body in one corner: far chunks and tile batches are all air
    vol = np.full((44, 40, 36), -1024, np.int16)
    vol[3:16, 4:18, 2:15] = 400 + (np.random.RandomState(7).rand(
        13, 14, 13) * 100).astype(np.int16)
    return vol, (1.0, 1.0, 1.0)


def _pipe(teng, **kw):
    kw.setdefault("host_preprocess", True)
    return TurboPipeline(teng, TurboConfig(**CFG), **kw)


def _jpipe(jeng, **kw):
    p = JaxPipeline(jeng, JaxConfig(**CFG), host_preprocess=True, **kw)
    p.crop_bucket = 4
    return p


def test_streamed_lazy_route_matches_jax(nets, jax_hostops, monkeypatch):
    jeng, teng, tree, _ = nets
    vol, spacing = _vol()
    monkeypatch.setenv("FNN_TURBO_STREAM", "1")
    jp = _jpipe(jeng)
    ref = jp.predict_volume(jax.tree_util.tree_map(jnp.asarray, tree), vol,
                            spacing)
    assert any(k[0] == "stream" for k in jp._jit_cache if isinstance(k, tuple))
    pipe = _pipe(teng)
    teng.timer = timer = PhaseTimer()
    try:
        got = pipe.predict_volume(tree, vol, spacing)
    finally:
        teng.timer = None
    assert pipe.route == "streamed"
    assert got.shape == vol.shape and got.dtype == np.uint8
    assert (got == ref).mean() >= 0.999
    # the host work shows as the tracer's host-only phases (no air flags:
    # air skipping is off)
    totals = timer.totals()
    assert {k for k in totals if k.startswith("host:host_")} == {
        "host:host_preprocess", "host:host_revert"}


def test_fused_host_route_matches_jax(nets, jax_hostops, monkeypatch):
    jeng, teng, tree, _ = nets
    vol, spacing = _vol()
    monkeypatch.setenv("FNN_TURBO_STREAM", "0")
    ref = _jpipe(jeng).predict_volume(
        jax.tree_util.tree_map(jnp.asarray, tree), vol, spacing)
    pipe = _pipe(teng)
    got = pipe.predict_volume(tree, vol, spacing)
    assert pipe.route == "host"
    assert (got == ref).mean() >= 0.999


def _all_air_vol():
    # no voxel above the clip floor: the crop box is the minimal one
    return np.full((30, 44, 26), -1024, np.int16), (1.0, 1.0, 1.0)


@pytest.mark.parametrize("make_vol,folds", [(_vol, 1), (_vol, 2),
                                            (_all_air_vol, 1)],
                         ids=["body-1", "body-2", "all_air-1"])
def test_streamed_bit_equals_fused_host_route(nets, monkeypatch, make_vol,
                                              folds):
    _, teng, tree, tree2 = nets
    params = tree if folds == 1 else [tree, tree2]
    vol, spacing = make_vol()
    monkeypatch.setenv("FNN_TURBO_STREAM", "1")
    pipe = _pipe(teng)
    seg_stream = pipe.predict_volume(params, vol, spacing)
    assert pipe.route == "streamed"
    monkeypatch.setenv("FNN_TURBO_STREAM", "0")
    fused = _pipe(teng)
    seg_fused = fused.predict_volume(params, vol, spacing)
    assert fused.route == "host"
    np.testing.assert_array_equal(seg_stream, seg_fused)


def test_one_x_start_takes_the_fused_host_route(nets, jax_hostops):
    """A target grid one patch deep along the chunk axis has one x start
    and does not stream: the host route falls back to the fused one, as
    JAX's does, and the masks agree."""
    jeng, teng, tree, _ = nets
    vol, spacing = _vol()
    vol = np.ascontiguousarray(vol[:, 10:18])  # engine x: image axis 1
    pipe = _pipe(teng)
    got = pipe.predict_volume(tree, vol, spacing)
    assert pipe.route == "host"
    assert teng.s2d_sweep_plan(pipe._geometry(vol[None], spacing)[1])[1][0] \
        == [0]
    ref = _jpipe(jeng).predict_volume(
        jax.tree_util.tree_map(jnp.asarray, tree), vol, spacing)
    assert got.shape == vol.shape and (got == ref).mean() >= 0.999


def test_unpacked_rows_when_labels_exceed_six_bits(nets, monkeypatch):
    """With more than 64 classes the rows travel as uint8 (pack_mask off)
    on both host routes, and the masks are those of the packed run."""
    _, teng, tree, _ = nets
    vol, spacing = _vol()
    packed = _pipe(teng).predict_volume(tree, vol, spacing)
    for stream in ("1", "0"):
        monkeypatch.setenv("FNN_TURBO_STREAM", stream)
        pipe = _pipe(teng)
        pipe.pack_mask = False
        np.testing.assert_array_equal(
            pipe.predict_volume(tree, vol, spacing), packed)


def test_streamed_air_skip_differs_only_in_air(nets, monkeypatch):
    """Air skipping on both host routes (the streamed one tests the strips
    it holds, the fused one the device volume): any disagreement with the
    unskipped mask lies in air, and the two routes agree."""
    _, teng, tree, _ = nets
    vol, spacing = _air_vol()
    base = _pipe(teng).predict_volume(tree, vol, spacing)
    pipe = _pipe(teng, air_skip=True)
    skip = pipe.predict_volume(tree, vol, spacing)
    assert pipe.route == "streamed"
    diff = skip != base
    assert diff.any(), "the far all-air region must have been skipped"
    body = ndimage.binary_erosion(vol > -1024 + 300, iterations=3)
    assert not (diff & body).any()
    assert diff.mean() < 0.02 or (vol[diff] == -1024).all()
    monkeypatch.setenv("FNN_TURBO_STREAM", "0")
    np.testing.assert_array_equal(
        _pipe(teng, air_skip=True).predict_volume(tree, vol, spacing), skip)


def test_host_air_flags_equal_device_air_flags(nets, monkeypatch):
    """The streamed route's host flags (from the strips) against
    turbo.air_flags on the fused route's device volume, chunk by chunk."""
    _, teng, tree, _ = nets
    vol, spacing = _air_vol()
    seen = {}
    real = TurboPipeline._air_valid

    def record(self, x0, steps):
        seen["device"] = real(self, x0, steps)
        return seen["device"]
    monkeypatch.setattr(TurboPipeline, "_air_valid", record)
    from fast_nnunet_tpu_torch.inference import engine as engine_module
    real_acc = engine_module.S2DChunks.accumulate

    def acc(self, vol_, x0, valid_c=None):
        seen.setdefault("host", []).append(valid_c)
        return real_acc(self, vol_, x0, valid_c)
    monkeypatch.setattr(engine_module.S2DChunks, "accumulate", acc)
    _pipe(teng, air_skip=True).predict_volume(tree, vol, spacing)
    host = np.stack(seen.pop("host"))
    monkeypatch.setenv("FNN_TURBO_STREAM", "0")
    _pipe(teng, air_skip=True).predict_volume(tree, vol, spacing)
    np.testing.assert_array_equal(host, seen["device"])
    assert 0 < host.sum() < host.size


def test_rejected_strip_box_falls_back_to_the_fused_host_route(
        nets, monkeypatch):
    """A strip box the host library would reject sends the call to the
    fused host route (JAX has a bare assert there), with the same mask."""
    from fast_nnunet_tpu_torch.utils import hostops
    _, teng, tree, _ = nets
    vol, spacing = _vol()
    pipe = _pipe(teng)
    ref = pipe.predict_volume(tree, vol, spacing)
    assert pipe.route == "streamed"
    real = hostops.box_ok

    def whole_grid_only(shape, box):
        return real(shape, box) and list(box[1::2]) == list(shape) and \
            not any(box[0::2])
    monkeypatch.setattr(hostops, "box_ok", whole_grid_only)
    got = pipe.predict_volume(tree, vol, spacing)
    assert pipe.route == "host"
    np.testing.assert_array_equal(got, ref)


def test_host_revert_equals_device_revert(nets):
    _, teng, tree, _ = nets
    vol = np.random.RandomState(3).randint(-1024, 600, (30, 26, 22)).astype(
        np.int16)
    spacing = (1.0, 1.0, 1.5)
    dev = _pipe(teng, host_preprocess=False).predict_volume(tree, vol,
                                                            spacing)
    pipe = _pipe(teng, host_preprocess=False, host_revert=True)
    host = pipe.predict_volume(tree, vol, spacing)
    assert pipe.route == "device"
    np.testing.assert_array_equal(host, dev)


@pytest.mark.parametrize("n", [4096, 4095, 4094, 4093])
def test_pack_mask6_bytes_equal_jax(n):
    s = np.random.RandomState(n).randint(0, 64, n).astype(np.uint8)
    got = pack_mask6(torch.from_numpy(s)).numpy()
    flat = jnp.asarray(s)
    if n % 4:  # JAX's pack (inference/turbo.py), as written there
        flat = jnp.concatenate([flat, jnp.zeros(((-n) % 4,), jnp.uint8)])
    q = flat.reshape(-1, 4)
    ref = np.asarray(jnp.stack([q[:, 0] | (q[:, 1] << 6),
                                (q[:, 1] >> 2) | (q[:, 2] << 4),
                                (q[:, 2] >> 4) | (q[:, 3] << 2)], axis=-1))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(_unpack_mask6(got, (n,)), s)
    np.testing.assert_array_equal(jax_unpack(got, (n,)), s)


def test_float_input_takes_the_device_route(nets):
    _, teng, tree, _ = nets
    vol = _vol()[0].astype(np.float32)
    pipe = _pipe(teng)
    got = pipe.predict_volume(tree, vol, (1.0, 1.0, 1.0))
    assert pipe.route == "device"
    np.testing.assert_array_equal(
        got, _pipe(teng, host_preprocess=False).predict_volume(
            tree, vol, (1.0, 1.0, 1.0)))



def test_host_and_device_routes_agree_at_jax_pinned_setting(jax_hostops,
                                                            monkeypatch):
    """tests/test_hostops.py's host/device check at its own setting (f32
    network of that arch and patch, flax-initialised from PRNGKey(0), that
    volume and seed, ``host_revert=True`` on the device route), on the
    port's routes: agreement > 0.995, as JAX pins for its own. JAX's two
    routes run the same host library here and must clear it too."""
    from fast_nnunet_tpu.models.factory import get_network_from_plans
    from fast_nnunet_tpu.models.s2d import make_s2d_engine_net as jax_s2d
    from fast_nnunet_tpu_torch.models.s2d import (make_s2d_engine_net,
                                                  params_from_jax)
    monkeypatch.setattr(turbo_module, "CROP_BUCKET", PIPELINE_CROP_BUCKET)
    k, patch = 4, (8, 8, 16)
    arch = {"n_stages": 3, "features_per_stage": [8, 16, 32],
            "kernel_sizes": [[3, 3, 3]] * 3,
            "strides": [[1, 1, 1]] + [[2, 2, 2]] * 2,
            "n_conv_per_stage": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
            "nonlin": "torch.nn.LeakyReLU"}
    net = get_network_from_plans("PlainConvUNet", arch, (), 1, k,
                                 dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, *patch, 1)),
                      deep_supervision=False)
    s2d = jax_s2d(net, arch, k, dtype=jnp.float32)
    sp = s2d.convert_params(params)
    tree = jax.tree_util.tree_map(np.asarray, sp)
    cfg = dict(patch_size=(16, 8, 8), target_spacing=(1.0, 1.2, 1.1),
               mean=40.0, std=100.0, lower_bound=-60.0, upper_bound=400.0,
               num_classes=k)
    rng = np.random.RandomState(7)
    vol = np.full((30, 26, 22), -1000, np.int16)
    vol[6:24, 5:21, 4:18] = (rng.rand(18, 16, 14) * 400 - 60).astype(np.int16)
    spacing = (1.0, 1.0, 1.5)

    tnet = make_s2d_engine_net(arch, k, 1, compute_dtype=torch.float32)
    params_from_jax(tnet, tree)
    teng = SlidingWindowEngine(tnet, patch, k, tile_step_size=0.5,
                               shape_bucket=4, compute_dtype=torch.float32,
                               sweep_acc_dtype=torch.float32, tile_batch=2,
                               device="cpu")
    seg_dev = TurboPipeline(teng, TurboConfig(**cfg), host_preprocess=False,
                            host_revert=True).predict_volume(tree, vol,
                                                             spacing)
    pipe = TurboPipeline(teng, TurboConfig(**cfg), host_preprocess=True)
    seg_host = pipe.predict_volume(tree, vol, spacing)
    assert pipe.route == "streamed"
    assert seg_host.shape == vol.shape and seg_host.dtype == np.uint8
    agree = float((seg_dev == seg_host).mean())
    assert agree > 0.995, f"host/device route agreement {agree}"

    jeng = JaxEngine(s2d, patch, k, tile_step_size=0.5, shape_bucket=4,
                     compute_dtype=jnp.float32, sweep_acc_dtype=jnp.float32,
                     tile_batch=2, use_s2d_sweep=True)
    jdev = JaxPipeline(jeng, JaxConfig(**cfg), host_preprocess=False,
                       host_revert=True).predict_volume(sp, vol, spacing)
    jhost = JaxPipeline(jeng, JaxConfig(**cfg),
                        host_preprocess=True).predict_volume(sp, vol, spacing)
    assert float((jdev == jhost).mean()) > 0.995
    assert (seg_host == jhost).mean() >= 0.999
    assert (seg_dev == jdev).mean() >= 0.999
