"""The port's Primus (models/primus.py) and its trainers
(training/primus_trainers.py) against the JAX package's, on the same seeded
numpy inputs and flax-initialised weights, on the CPU:
- the axial RoPE angles equal JAX's (head dims 66, 72, 96);
- the forward in float32 within 1e-5 of the logits' scale, isotropic (embed
  96, depth 2, 3 heads, patch 16^3, 8^3 tokens) and anisotropic (patch
  (16, 8, 8), 4^3 tokens); in bfloat16 within 1e-2 of the scale in the mean
  (5e-2 at most) with the argmax on >= 98% of voxels, the ResEnc tests'
  tolerance (each side rounds its activations to bf16 in its own order);
- gradients of a loss against ``jax.grad`` within 1e-4 of each leaf's
  largest;
- the S / B / M / L parameter trees at a 96^3 patch against
  ``jax.eval_shape`` of the flax init (shapes only, the port built on the
  meta device), and the carrier both ways;
- the divisibility raise and the deep-supervision 1-tuple;
- three steps of the Primus trainer (AdamW b2 0.98, clip 1, warmup-poly)
  against the JAX trainer's jitted step within 1e-5, one of them on a NaN
  batch that leaves the parameters, the AdamW moments and the schedule
  count as they were, as in JAX;
- a tiny Primus trainer through ``run_training`` on the CPU: the JAX
  predictor reads its checkpoint, the port's predictor rebuilds a Primus
  from a checkpoint the JAX package wrote, and in float32 both predictors
  write the same masks from each;
- the exporter refuses a Primus checkpoint, as the JAX one cannot export
  it."""
import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from fast_nnunet_tpu.models import primus as jprimus
from fast_nnunet_tpu.training import primus_trainers as jtrainers
from fast_nnunet_tpu.training import train_step as jstep
from fast_nnunet_tpu_torch.models import primus as pprimus
from fast_nnunet_tpu_torch.models.unet import params_from_jax, params_to_jax
from fast_nnunet_tpu_torch.training import checkpoint as pckpt
from fast_nnunet_tpu_torch.training import primus_trainers as ptrainers

from .test_torch_train_e2e import DS, _plans, env  # noqa: F401 (fixture)
from .torch_port_common import no_persistent_compile_cache  # noqa: F401

TINY = dict(embed_dim=96, depth=2, num_heads=3)
CONFIGS = {"iso": ((16, 16, 16), (8, 8, 8)), "aniso": ((16, 8, 8), (4, 4, 4))}
IN_CH, K = 2, 3
_CACHE = {}


def _pair(name, dtype="float32"):
    """(jax Primus, its flax params, jitted apply, port Primus with those
    params) for a CONFIGS entry; the JAX init and jit are cached."""
    key = (name, dtype)
    if key not in _CACHE:
        patch, pe = CONFIGS[name]
        jn = jprimus.Primus(input_channels=IN_CH, patch_embed_size=pe,
                            num_classes=K, patch_size=patch,
                            dtype=getattr(jnp, dtype), **TINY)
        params = jax.device_get(jax.jit(jn.init)(
            jax.random.PRNGKey(1), jnp.zeros((1, *patch, IN_CH))))
        params = _perturbed(params, seed=2)
        tn = pprimus.Primus(IN_CH, patch_embed_size=pe, num_classes=K,
                            patch_size=patch, compute_dtype=getattr(
                                torch, dtype), **TINY)
        params_from_jax(tn, params)
        _CACHE[key] = (jn, params, jax.jit(jn.apply), tn)
    return _CACHE[key]


def _perturbed(params, seed):
    """LayerScale, temperatures and norm affines moved off their constant
    initial values, so that a transposed or misplaced one shows."""
    rng = np.random.RandomState(seed)

    def go(path, v):
        name = path[-1].key
        v = np.asarray(v)
        if name in ("ls1", "ls2", "attn_temperature", "scale") or (
                name == "bias" and v.ndim == 1):
            v = v + 0.1 * rng.randn(*v.shape).astype(np.float32)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(go, params)


def _input(patch, seed=0, batch=2):
    x = np.random.RandomState(seed).randn(batch, *patch, IN_CH)
    return x.astype(np.float32)


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("grid,hd", [((2, 3, 4), 66), ((3, 3, 3), 72),
                                     ((4, 2, 5), 96)])
def test_rope_angles_match_jax(grid, hd):
    got = pprimus.make_3d_rope(grid, hd)
    want = jprimus.make_3d_rope(grid, hd)
    assert got.shape == want.shape == (int(np.prod(grid)), hd // 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_f32_matches_jax(name):
    jn, params, apply, tn = _pair(name)
    x = _input(CONFIGS[name][0])
    ref = np.asarray(apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tn(_ncdhw(x))
    assert got.dtype == torch.float32
    got = np.moveaxis(got.numpy(), 1, -1)
    assert got.shape == ref.shape == (2, *CONFIGS[name][0], K)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_forward_bf16_matches_jax():
    jn, params, apply, tn = _pair("iso", "bfloat16")
    x = _input(CONFIGS["iso"][0], seed=1)
    ref = np.asarray(apply(params, jnp.asarray(x))).astype(np.float32)
    with torch.no_grad():
        got = np.moveaxis(tn(_ncdhw(x)).numpy(), 1, -1)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).mean() <= 1e-2 * scale
    assert np.abs(got - ref).max() <= 5e-2 * scale
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.98


def test_gradients_match_jax():
    jn, params, apply, _ = _pair("aniso")
    patch = CONFIGS["aniso"][0]
    x = _input(patch, seed=3)
    w = np.random.RandomState(4).randn(2, *patch, K).astype(np.float32)

    def loss(p):
        return jnp.mean(jn.apply(p, jnp.asarray(x)) ** 2 * w)
    gj = jax.device_get(jax.jit(jax.grad(loss))(params))
    tn = pprimus.Primus(IN_CH, patch_embed_size=CONFIGS["aniso"][1],
                        num_classes=K, patch_size=patch,
                        compute_dtype=torch.float32, trainable=True, **TINY)
    params_from_jax(tn, params)
    out = tn(_ncdhw(x))
    (out ** 2 * _ncdhw(w)).mean().backward()
    from fast_nnunet_tpu_torch.models.unet import tree_to_jax
    gp = tree_to_jax(tn, lambda p: p.grad)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(gj))
    flat_p = jax.tree_util.tree_leaves_with_path(gp)
    assert len(flat_p) == len(flat_j)
    for path, g in flat_p:
        ref = np.asarray(flat_j[path])
        assert np.abs(g - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-12, \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("cls", ["S", "B", "M", "L"])
def test_parameter_trees_match_jax_shapes(cls):
    tr = getattr(jtrainers, f"nnUNet_Primus_{cls}_Trainer")
    dims = dict(embed_dim=tr.embed_dim, depth=tr.depth,
                num_heads=tr.num_heads)
    assert dims == {k: getattr(getattr(ptrainers,
                                       f"nnUNet_Primus_{cls}_Trainer"), k)
                    for k in dims}
    jn = jprimus.Primus(input_channels=1, patch_embed_size=(8, 8, 8),
                        num_classes=4, patch_size=(96, 96, 96), **dims)
    shapes = jax.eval_shape(jn.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 96, 96, 1)))
    want = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_leaves_with_path(shapes)}
    with torch.device("meta"):
        tn = pprimus.Primus(1, patch_embed_size=(8, 8, 8), num_classes=4,
                            patch_size=(96, 96, 96), **dims)
    from fast_nnunet_tpu_torch.models.unet import jax_param_paths
    got = {}
    for path, t, kind in jax_param_paths(tn):
        shape = tuple(t.shape)
        if kind in ("conv", "transpconv", "dense"):   # the flax layout
            n = len(shape) - 2
            shape = (*shape[2:], shape[1], shape[0]) if kind == "conv" \
                else (*shape[2:], shape[0], shape[1]) \
                if kind == "transpconv" else shape[::-1]
            assert n >= 0
        got["".join(f"['{k}']" for k in path)] = shape
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == \
        sum(p.numel() for p in tn.parameters())
    hidden = {"S": 1024, "B": 2112, "M": 2304, "L": 2816}[cls]
    assert pprimus.swiglu_hidden(dims["embed_dim"]) == hidden


def test_carrier_round_trip_and_init():
    _, params, _, tn = _pair("aniso")
    back = params_to_jax(tn)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, v in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(flat_b[path], v)
    fresh = pprimus.init_primus_(copy.deepcopy(tn), 0)
    tree = params_to_jax(fresh)["params"]
    assert np.all(tree["block_0"]["ls1"] == np.float32(0.1))
    assert np.all(tree["block_1"]["attn"]["attn_temperature"] == 10.0)
    assert np.all(tree["norm"]["scale"] == 1.0)
    pos = tree["pos_embed"]
    assert np.abs(pos).max() <= 0.04 and 0.01 < pos.std() < 0.03
    qkv = tree["block_0"]["attn"]["qkv"]["kernel"]    # lecun normal
    assert abs(qkv.std() * np.sqrt(96) - 1.0) < 0.1
    assert np.abs(qkv).max() <= 2 / .87962566103423978 / np.sqrt(96) + 1e-6


def test_divisibility_raise_and_deep_supervision_tuple():
    with pytest.raises(ValueError, match="divisible"):
        pprimus.Primus(1, patch_embed_size=(8, 8, 8), num_classes=2,
                       patch_size=(16, 12, 16), **TINY)
    jn = jprimus.Primus(input_channels=1, patch_embed_size=(8, 8, 8),
                        num_classes=2, patch_size=(16, 12, 16), **TINY)
    with pytest.raises(AssertionError, match="divisible"):
        jn.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 12, 16, 1)))
    _, _, _, tn = _pair("aniso")
    x = _ncdhw(_input(CONFIGS["aniso"][0], batch=1))
    with torch.no_grad():
        ds = tn(x, deep_supervision=True)
        plain = tn(x)
    assert isinstance(ds, tuple) and len(ds) == 1
    torch.testing.assert_close(ds[0], plain, rtol=0, atol=0)


def test_drop_path_acts_only_with_a_generator():
    """Stochastic depth is off in every deterministic call (the trainers'
    and the predictor's); with a generator a dropped sample's branch is
    zero and a kept one rescaled."""
    _, _, _, tn = _pair("aniso")
    blk = tn.blocks[1]
    assert blk.drop_path_rate == pytest.approx(0.2)
    x = torch.ones(64, 3, 4)
    assert blk._drop_path(x, None) is x
    g = torch.Generator().manual_seed(0)
    y = blk._drop_path(x, g)
    kept = y[:, 0, 0]
    assert set(kept.unique().tolist()) <= {0.0, 1 / 0.8}
    assert 0 < (kept == 0).sum() < 64
    xin = _ncdhw(_input(CONFIGS["aniso"][0], batch=1))
    with torch.no_grad():
        plain = tn(xin)
        torch.testing.assert_close(tn(xin, generator=None), plain)
        dropped = [tn(xin, generator=torch.Generator().manual_seed(s))
                   for s in range(8)]
    assert any(not torch.equal(d, plain) for d in dropped)


# ------------------------------------------------------------- trainers
class _JaxTiny(jtrainers.AbstractPrimusTrainer):
    embed_dim, depth, num_heads = 96, 2, 3


class TinyPrimusTrainer(ptrainers.AbstractPrimusTrainer):
    embed_dim, depth, num_heads = 96, 2, 3


DATASET_JSON = {"channel_names": {"0": "CT"}, "file_ending": ".nii.gz",
                "labels": {"background": 0, "a": 1, "b": 2}}


def _trainers():
    plans = _plans([1.0, 1.0, 1.0])
    jt = _JaxTiny(copy.deepcopy(plans), "3d_fullres", 0, DATASET_JSON)
    pt = TinyPrimusTrainer(copy.deepcopy(plans), "3d_fullres", 0,
                           DATASET_JSON, device="cpu")
    for t in (jt, pt):
        t.num_epochs, t.num_iterations_per_epoch = 4, 2
        t.warmup_epochs = 1
    jt.compute_dtype, pt.compute_dtype = jnp.float32, torch.float32
    jt.initialize()
    pt.initialize()
    return jt, pt


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_steps_match_jax_and_skip_a_nan_batch():
    """Loss and parameters after each step within 1e-5 of JAX's, the AdamW
    moments within 1e-4 of each leaf's largest (the gradients' tolerance). Adam divides each gradient
    element by its RMS plus eps 1e-8, so an element whose gradient is
    within float noise of zero (|g| < 10 eps, where the two sides' sums
    in different orders differ by tens of percent) moves in a direction
    the noise gives; such elements (a few per thousand, at most 1%) are
    held to the update's own range, 2 lr per such step, instead."""
    jt, pt = _trainers()
    assert pt.enable_deep_supervision is False and pt.initial_lr == 3e-4
    assert pt._init_args()["primus_arch"] == jt._init_args()["primus_arch"]
    params = _perturbed(jax.device_get(jt.train_state.params), seed=5)
    jt.train_state = jstep.TrainState(
        step=jt.train_state.step,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=jt.train_state.opt_state)
    params_from_jax(pt.network, params)
    rng = np.random.RandomState(6)
    slack, n_noisy = {}, 0

    def opt_leaves(state):
        return _leaves(serialization.to_state_dict(jax.device_get(state)))
    for s in range(4):
        x = rng.randn(2, 16, 16, 16, 1).astype(np.float32)
        lab = rng.randint(0, 3, (2, 16, 16, 16)).astype(np.int32)
        x[..., 0] += lab
        if s == 2:
            x[:] = np.nan
        before = (_leaves(params_to_jax(pt.network)),
                  _leaves(pckpt.optimizer_state_to_jax(pt.optimizer,
                                                       pt.network)))
        mu0 = opt_leaves(jt.train_state.opt_state)
        lr = pt.optimizer.lr()
        jt.train_state, jl = jt._jit_train_step(
            jt.train_state, jnp.asarray(x), (jnp.asarray(lab),))
        pl = pt.train_step(_ncdhw(x), (torch.from_numpy(lab).long(),))
        if s == 2:
            assert not np.isfinite(float(jl)) and not np.isfinite(float(pl))
        else:
            np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
        got_p = _leaves(params_to_jax(pt.network))
        got_o = _leaves(pckpt.optimizer_state_to_jax(pt.optimizer,
                                                     pt.network))
        want_p = _leaves(jax.device_get(jt.train_state.params))
        want_o = opt_leaves(jt.train_state.opt_state)
        assert got_p.keys() == want_p.keys() and got_o.keys() == want_o.keys()
        for k in want_o:
            scale = np.abs(want_o[k]).max()
            assert np.abs(got_o[k] - want_o[k]).max() <= 1e-4 * scale, \
                (k, s)
            if s != 2 and "['mu']" in k:   # JAX's clipped gradient
                g = (want_o[k] - 0.9 * mu0[k]) / 0.1
                pk = k[k.index("['params']"):]
                noisy = np.abs(g) < 1e-7
                n_noisy += int(noisy.sum())
                slack[pk] = slack.get(pk, 0.0) + noisy * 2 * lr
        for k in want_p:
            d = np.abs(got_p[k] - want_p[k])
            bound = 1e-5 + 1e-5 * np.abs(want_p[k]) + slack.get(k, 0.0)
            assert (d <= bound).all(), (k, s, d.max())
        if s == 2:   # the NaN step changed nothing, on either side
            for a, b in zip(before, (got_p, got_o)):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n_params = sum(p.numel() for p in pt.network.parameters())
    assert n_noisy <= 1e-2 * n_params * 3, n_noisy   # 3 finite steps
    assert pt.optimizer.count == 3 and pt.train_step.skipped == 1
    assert pt._train_step_count() == int(jt.train_state.step) == 4


def test_primus_names_resolve_with_their_settings():
    from fast_nnunet_tpu.run.run_training import \
        find_trainer_class as jfind
    from fast_nnunet_tpu_torch.run.run_training import find_trainer_class
    plans = _plans([1.0, 1.0, 1.0])
    for name in ("_Primus_S_96_BS1", "_Primus_B_96_BS1", "_Primus_M_96_BS1",
                 "_Primus_L_48_BS1", "nnUNet_Primus_M_Trainer_BS8_2e4",
                 "nnUNet_Trainer_BS8"):
        jt = jfind(name)(copy.deepcopy(plans), "3d_fullres", 0, DATASET_JSON)
        pt = find_trainer_class(name)(copy.deepcopy(plans), "3d_fullres", 0,
                                      DATASET_JSON, device="cpu")
        assert type(pt).__name__ == type(jt).__name__
        assert pt.configuration_manager.batch_size == \
            jt.configuration_manager.batch_size
        assert pt.configuration_manager.patch_size == \
            jt.configuration_manager.patch_size
        assert pt.initial_lr == jt.initial_lr
        assert pt._init_args() == jt._init_args()


# ------------------------------------------------------------- end to end
def _jax_predictor_f32(model_folder, fold):
    """The JAX predictor on a Primus checkpoint with a float32 Primus and a
    float32 sliding window (its own build is bfloat16), mirroring off."""
    from fast_nnunet_tpu.inference.predictor import NNUNetPredictor
    jp = NNUNetPredictor(use_mirroring=False)
    jp.initialize_from_trained_model_folder(model_folder, use_folds=(fold,))
    assert isinstance(jp.network, jprimus.Primus)
    jp.manual_initialization(
        jp.network.clone(dtype=jnp.float32), jp.plans_manager,
        jp.configuration_manager, jp.list_of_parameters, jp.dataset_json,
        jp.trainer_name, jp.allowed_mirroring_axes)
    jp.engine.compute_dtype = jnp.float32
    return jp


def test_trainer_checkpoints_and_predictors_match_jax(env, tmp_path,
                                                      monkeypatch):
    from fast_nnunet_tpu.imageio.nifti import NiftiIO as JIO
    from fast_nnunet_tpu.training import checkpoint as jckpt
    from fast_nnunet_tpu_torch.export.export_model import \
        export_model_folder_to_artifact
    from fast_nnunet_tpu_torch.inference.predictor import NNUNetPredictor
    from fast_nnunet_tpu_torch.run.run_training import run_training
    for k, v in (("FNNT_ITERS_PER_EPOCH", "2"),
                 ("FNNT_VAL_ITERS_PER_EPOCH", "1"), ("FNNT_NUM_EPOCHS", "1"),
                 ("nnUNet_n_proc_DA", "2")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(ptrainers, "TinyPrimusTrainer", TinyPrimusTrainer,
                        raising=False)
    trainer = run_training(DS, "3d_fullres", 0,
                           trainer_name="TinyPrimusTrainer", device="cpu")
    assert isinstance(trainer.network, pprimus.Primus)
    model = trainer.output_folder_base
    ckpt = jckpt.load_checkpoint(os.path.join(model, "fold_0",
                                              "checkpoint_final.fnnx"))
    assert ckpt["init_args"]["primus_arch"] == {
        "embed_dim": 96, "depth": 2, "num_heads": 3,
        "patch_embed_size": [8, 8, 8]}
    assert ckpt["optimizer_state"]["1"]["mu"]["params"]["block_0"]["ls1"] \
        .shape == (96,)

    # a checkpoint the JAX package writes, from its own init, as fold 1
    jn = jprimus.Primus(input_channels=1, patch_embed_size=(8, 8, 8),
                        num_classes=3, patch_size=(16, 16, 16), **TINY)
    jparams = _perturbed(jax.device_get(jn.init(
        jax.random.PRNGKey(7), jnp.zeros((1, 16, 16, 16, 1)))), seed=8)
    os.makedirs(os.path.join(model, "fold_1"))
    jckpt.save_checkpoint(
        os.path.join(model, "fold_1", "checkpoint_final.fnnx"),
        network_weights=jparams, init_args=dict(ckpt["init_args"], fold=1),
        trainer_name="TinyPrimusTrainer")

    ts = str(tmp_path / "imagesTs")
    os.makedirs(ts)
    shutil.copy(os.path.join(env["raw"], DS, "imagesTr",
                             "case_000_0000.nii.gz"),
                os.path.join(ts, "ts_000_0000.nii.gz"))
    for fold in (0, 1):
        tp = NNUNetPredictor(use_mirroring=False, device="cpu",
                             compute_dtype=torch.float32)
        tp.initialize_from_trained_model_folder(model, use_folds=(fold,))
        assert isinstance(tp.network, pprimus.Primus)
        assert tp.network.depth == 2 and tp.network.patch_size == (16,) * 3
        out, jout = (str(tmp_path / f"{n}{fold}") for n in ("p", "j"))
        tp.predict_from_files(ts, out)
        jp = _jax_predictor_f32(model, fold)
        jp.predict_from_files(ts, jout)
        got, _ = JIO().read_seg(os.path.join(out, "ts_000.nii.gz"))
        ref, _ = JIO().read_seg(os.path.join(jout, "ts_000.nii.gz"))
        assert len(np.unique(ref)) > 1 or fold == 0
        np.testing.assert_array_equal(got, ref)

    with pytest.raises(NotImplementedError, match="Primus"):
        export_model_folder_to_artifact(model, 0, str(tmp_path / "export"),
                                        device="cpu")
    from fast_nnunet_tpu.export.export_model import \
        export_model_folder_to_artifact as jexport
    with pytest.raises(Exception):   # the plans' CNN cannot take the tree
        jexport(model, 0, str(tmp_path / "jexport"))
