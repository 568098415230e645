"""Reference ``.pth`` weights into the port's networks
(``utils/torch_import.py``) against the JAX package's importer: the
committed torch parity fixture's state_dict reproduces the torch logits
(atol 3e-4, the port's network tolerance) and its transposed-conv output;
key translation equals JAX's for every pattern and prefix; seeded
reference-named state_dicts of a plain 3D, a residual-encoder and a 2D
network give JAX's import + forward (atol 3e-4); ``skip_seg_layers``
leaves the heads; ``load_pretrained_weights`` takes a ``.pth``."""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fast_nnunet_tpu.models.factory import get_network_from_plans as jax_net
from fast_nnunet_tpu.utils import torch_import as jti
from fast_nnunet_tpu_torch.models import factory as pfactory
from fast_nnunet_tpu_torch.models.unet import jax_param_paths
from fast_nnunet_tpu_torch.utils import torch_import as pti

from .torch_port_common import no_persistent_compile_cache  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_parity.npz")
ATOL = 3e-4
K = 3
FIXTURE_ARCH = {"n_stages": 3, "features_per_stage": [4, 8, 16],
                "kernel_sizes": [[3, 3, 3]] * 3,
                "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
                "n_conv_per_stage": [2, 2, 2],
                "n_conv_per_stage_decoder": [2, 2],
                "nonlin": "torch.nn.LeakyReLU",
                "norm_op": "torch.nn.InstanceNorm3d"}
RESENC = {"n_stages": 3, "features_per_stage": [8, 16, 32],
          "kernel_sizes": [[1, 3, 3], [3, 3, 3], [3, 3, 3]],
          "strides": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
          "n_blocks_per_stage": [1, 2, 2], "n_conv_per_stage": [1, 2, 2],
          "n_conv_per_stage_decoder": [1, 1], "nonlin": "torch.nn.LeakyReLU"}
ARCH2D = {"n_stages": 3, "features_per_stage": [8, 16, 32],
          "kernel_sizes": [[3, 3]] * 3, "strides": [[1, 1], [2, 2], [2, 1]],
          "n_conv_per_stage": [2, 2, 2], "n_blocks_per_stage": [1, 2, 2],
          "n_conv_per_stage_decoder": [2, 1],
          "conv_op": "torch.nn.modules.conv.Conv2d",
          "nonlin": "torch.nn.LeakyReLU"}


def _port(cls, arch, k=K):
    return pfactory.get_network_from_plans(cls, arch, (), 1, k,
                                           compute_dtype=torch.float32)


def _template(jnet, patch):
    """The JAX network's parameter tree as zeros, from shapes alone (no
    op-by-op init on the CPU)."""
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *patch, 1)),
        deep_supervision=False))
    return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes)


def _fixture():
    data = np.load(FIXTURE)
    return data, {k[3:]: data[k] for k in data.files if k.startswith("sd.")}


def test_parity_fixture_reproduces_torch_logits():
    data, sd = _fixture()
    net = _port("PlainConvUNet", FIXTURE_ARCH)
    _, report = pti.import_torch_weights(net, sd)
    assert len(report["converted"]) == len(sd) == len(jax_param_paths(net))
    assert not (report["unmatched"] or report["shape_mismatch"]
                or report["missing_in_template"])
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(data["__input__"])).numpy()
    np.testing.assert_allclose(got, data["__torch_logits__"], atol=ATOL,
                               rtol=0)


def test_parity_fixture_transposed_conv():
    """The fixture's ConvTranspose3d tensor loaded through the importer
    into the port's transposed conv gives torch's recorded output."""
    data, _ = _fixture()
    net = _port("PlainConvUNet", dict(
        FIXTURE_ARCH, n_stages=2, features_per_stage=[3, 4],
        kernel_sizes=[[3, 3, 3]] * 2, strides=[[1, 1, 1], [2, 2, 2]],
        n_conv_per_stage=[1, 1], n_conv_per_stage_decoder=[1]))
    _, report = pti.import_torch_weights(net, {
        "decoder.transpconvs.0.weight": data["__tc_weight__"],
        "decoder.transpconvs.0.bias": data["__tc_bias__"]})
    assert len(report["converted"]) == 2
    with torch.no_grad():
        out = net.decoder.mods["transpconv_0"](
            torch.from_numpy(data["__tc_input__"])).numpy()
    np.testing.assert_allclose(out, data["__tc_output__"], atol=1e-5)


KEYS = [
    "encoder.stages.0.convs.1.conv.weight",
    "encoder.stages.2.convs.0.norm.weight",
    "encoder.stages.3.1.convs.0.conv.bias",
    "decoder.stages.1.convs.0.norm.bias",
    "encoder.stem.convs.0.norm.bias",
    "encoder.stem.convs.0.conv.weight",
    "encoder.stages.1.blocks.0.conv1.conv.weight",
    "encoder.stages.1.0.blocks.1.conv2.norm.weight",
    "encoder.stages.1.blocks.0.norm2.bias",
    "encoder.stages.1.blocks.0.conv1.weight",
    "encoder.stages.1.blocks.0.skip.0.weight",
    "encoder.stages.2.blocks.0.downsample_skip.1.bias",
    "decoder.transpconvs.1.weight",
    "decoder.transpconvs.0.bias",
    "decoder.seg_layers.0.bias",
    "decoder.seg_layers.4.weight",
    "decoder.encoder.stages.0.convs.0.conv.weight",
    "encoder.stages.0.convs.0.norm.running_mean",
    "some.unknown.thing",
]


@pytest.mark.parametrize("prefix", ["", "module.", "_orig_mod."])
def test_translate_torch_key_equals_jax(prefix):
    for key in KEYS:
        assert pti.translate_torch_key(prefix + key) == \
            jti.translate_torch_key(prefix + key), key


@pytest.mark.parametrize("cls,arch,patch", [
    ("PlainConvUNet", FIXTURE_ARCH, (16, 16, 16)),
    ("ResidualEncoderUNet", RESENC, (16, 16, 16)),
    ("PlainConvUNet", ARCH2D, (32, 32)),
    ("ResidualEncoderUNet", ARCH2D, (32, 32)),
], ids=["plain3d", "resenc3d", "plain2d", "resenc2d"])
def test_import_and_forward_match_jax(cls, arch, patch):
    """A seeded reference-named state_dict: JAX's import_torch_weights +
    forward against the port's import + forward, and the five report lists
    equal."""
    net = _port(cls, arch)
    sd = chip_smoke.reference_state_dict(torch, net, seed=4)
    sd["encoder.stages.0.convs.0.norm.running_mean"] = torch.zeros(1)
    sd["decoder.not_a_module.weight"] = torch.zeros(1)
    _, report = pti.import_torch_weights(net, sd)
    jnet = jax_net(cls, arch, (), 1, K, dtype=jnp.float32)
    params, jreport = jti.import_torch_weights(_template(jnet, patch), sd)
    assert report == jreport
    assert len(report["converted"]) == len(jax_param_paths(net))
    assert report["unmatched"] == ["decoder.not_a_module.weight"]
    x = np.random.RandomState(5).randn(2, *patch, 1).astype(np.float32)
    ref = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(
            np.moveaxis(x, -1, 1).copy())).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, atol=ATOL,
                               rtol=0)


def test_shape_mismatch_report_equals_jax():
    net = _port("PlainConvUNet", FIXTURE_ARCH)
    sd = chip_smoke.reference_state_dict(torch, net, seed=1)
    sd["decoder.transpconvs.0.weight"] = torch.zeros(16, 7, 2, 2, 2)
    sd["encoder.stages.0.convs.0.conv.weight"] = torch.zeros(4, 2, 3, 3, 3)
    _, report = pti.import_torch_weights(net, sd)
    jnet = jax_net("PlainConvUNet", FIXTURE_ARCH, (), 1, K, dtype=jnp.float32)
    _, jreport = jti.import_torch_weights(_template(jnet, (8, 8, 8)), sd)
    assert report["shape_mismatch"] == jreport["shape_mismatch"]
    assert len(report["shape_mismatch"]) == 2


def test_skip_seg_layers():
    net = _port("PlainConvUNet", FIXTURE_ARCH)
    before = {n: p.clone() for n, p in net.named_parameters()}
    _, sd = _fixture()
    _, report = pti.import_torch_weights(net, sd, skip_seg_layers=True)
    assert len(report["skipped_seg"]) == 4
    assert len(report["converted"]) == len(sd) - 4
    for name, p in net.named_parameters():
        same = torch.equal(p, before[name])
        assert same == ("seg_head" in name), name


def test_load_pretrained_weights_from_pth(tmp_path, capsys):
    """A reference trainer checkpoint (``network_weights`` and metadata) is
    read with weights_only=True; one whose log holds a numpy scalar is
    read in full after a warning. Seg heads stay."""
    from fast_nnunet_tpu_torch.run.run_training import load_pretrained_weights
    net = _port("PlainConvUNet", FIXTURE_ARCH)
    heads = {n: p.clone() for n, p in net.named_parameters()
             if "seg_head" in n}
    sd = chip_smoke.reference_state_dict(torch, net, seed=7)
    trainer = types.SimpleNamespace(was_initialized=True, network=net)
    for i, extra in enumerate(({}, {"logging": {"ema": [np.float64(0.5)]}})):
        path = str(tmp_path / f"checkpoint_{i}.pth")
        torch.save({"network_weights": sd, "trainer_name": "nnUNetTrainer",
                    "init_args": {"fold": 0}, **extra}, path)
        report = load_pretrained_weights(trainer, path)
        out = capsys.readouterr().out
        assert ("weights_only" in out) == bool(extra)
        assert len(report["converted"]) == len(sd) - 4
        assert len(report["skipped_seg"]) == 4
    w = net.encoder.stages["stage_0"].blocks["block_0"].conv.weight
    torch.testing.assert_close(w, sd["encoder.stages.0.convs.0.conv.weight"],
                               rtol=0, atol=0)
    for n, p in net.named_parameters():
        if n in heads:
            assert torch.equal(p, heads[n])
    bare = str(tmp_path / "bare.pth")
    torch.save(sd, bare)
    assert pti.load_torch_network_weights(bare).keys() == sd.keys()
