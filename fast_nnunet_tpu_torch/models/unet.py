"""The plain U-Net (PlainConvUNet, and width-reduced the LiteNNUNetStudent)
as an ``nn.Module`` — the port of fast_nnunet_tpu/models/unet.py.

Forward contract: input (B, C_in, X, Y, Z) in NCDHW with the JAX package's
spatial order; output float32 logits (B, K, X, Y, Z) of the full-resolution
seg head, or, with ``deep_supervision=True``, a tuple of every decoder
stage's logits, highest resolution first. Every seg head is a parameter
whether or not deep supervision is asked for, so a JAX checkpoint loads 1:1;
without it only the full-resolution head runs (the JAX module computes all
heads and returns the first: same result).

Weights come from the JAX package's flax trees through
:func:`params_from_jax` (the conv / transposed-conv conventions that
models/s2d.py pins, the transposed-conv flip included) or from a ``.fnnx``
checkpoint through :func:`restore`; :func:`params_to_jax` is the inverse
(the training checkpoint writer uses it). ``ResidualEncoderUNet`` is not
ported.

Two forms: the inference form (default) holds its conv weights in the
compute dtype and no gradients; ``trainable=True`` holds float32 master
parameters with gradients, cast to the compute dtype inside the forward (as
flax with ``dtype=bf16`` and float32 params). Training builds also take
``norm_onepass=True`` (models/blocks.py) and ``remat`` with the JAX rule:
any truthy value checkpoints every encoder stack; ``True`` every decoder
stack too, ``"light"`` only the full-resolution decoder stack,
``"encoder"`` none of them.
"""
import math
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..training.checkpoint import load_checkpoint
from .blocks import (Conv3d, ConvTranspose3d, InstanceNorm,
                     StackedConvBlocks)
from .s2d import _conv_weight, _set, _transpconv_weight


def as_tuples(x, n_stages: int, dim: int) -> Tuple[Tuple[int, ...], ...]:
    """Normalize kernel_sizes/strides specs (int | seq[int] | seq[seq[int]])
    — a copy of the JAX package's ``_as_tuples``."""
    if isinstance(x, int):
        return tuple((x,) * dim for _ in range(n_stages))
    x = list(x)
    if all(isinstance(i, int) for i in x):
        if len(x) == n_stages:
            return tuple((int(i),) * dim for i in x)
        raise ValueError(f"Cannot interpret spec {x} for {n_stages} stages "
                         f"/ dim {dim}")
    return tuple(tuple(int(j) for j in i) for i in x)


class PlainConvEncoder(nn.Module):
    def __init__(self, input_channels: int, n_stages: int,
                 features_per_stage: Sequence[int], kernel_sizes, strides,
                 n_conv_per_stage: Sequence[int], conv_bias: bool = True,
                 norm_eps: float = 1e-5, nonlin_negative_slope: float = 0.01,
                 norm_onepass: bool = False, remat=False):
        super().__init__()
        f = [int(v) for v in features_per_stage]
        self.stages = nn.ModuleDict({
            f"stage_{s}": StackedConvBlocks(
                n_conv_per_stage[s], input_channels if s == 0 else f[s - 1],
                f[s], kernel_sizes[s], strides[s], conv_bias, norm_eps,
                nonlin_negative_slope, norm_onepass, bool(remat))
            for s in range(int(n_stages))})

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        skips = []
        for stage in self.stages.values():
            x = stage(x)
            skips.append(x)
        return tuple(skips)


class UNetDecoder(nn.Module):
    """Transposed-conv upsampling + skip concat + conv stacks + one seg head
    per stage (children ``transpconv_{d}``, ``stage_{d}``, ``seg_head_{d}``
    as in the flax tree)."""

    def __init__(self, num_classes: int, features_per_stage: Sequence[int],
                 kernel_sizes, strides, n_conv_per_stage_decoder: Sequence[int],
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01,
                 norm_onepass: bool = False, remat=False):
        super().__init__()
        f = [int(v) for v in features_per_stage]
        n = len(f)
        self.n_stages_encoder = n
        mods = nn.ModuleDict()
        for s in range(1, n):
            d = s - 1
            st = tuple(strides[-s])
            cout = f[-(s + 1)]
            mods[f"transpconv_{d}"] = ConvTranspose3d(f[-s], cout, st, st,
                                                      bias=conv_bias)
            mods[f"stage_{d}"] = StackedConvBlocks(
                n_conv_per_stage_decoder[d], 2 * cout, cout,
                kernel_sizes[-(s + 1)], (1,) * len(st), conv_bias, norm_eps,
                nonlin_negative_slope, norm_onepass,
                remat is True or (remat == "light" and s == n - 1))
            mods[f"seg_head_{d}"] = Conv3d(cout, num_classes, 1, bias=True)
        self.mods = mods

    def forward(self, skips: Sequence[torch.Tensor],
                deep_supervision: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        n = self.n_stages_encoder
        x = skips[-1]
        seg_outputs = []
        for s in range(1, n):
            d = s - 1
            x = self.mods[f"transpconv_{d}"](x)
            x = torch.cat([x, skips[-(s + 1)].to(x.dtype)], 1)
            x = self.mods[f"stage_{d}"](x)
            if deep_supervision or s == n - 1:
                seg_outputs.append(self.mods[f"seg_head_{d}"](x).float())
        if deep_supervision:
            return tuple(seg_outputs[::-1])
        return seg_outputs[-1]


REMAT_MODES = (False, True, "encoder", "light")


class PlainConvUNet(nn.Module):
    """The nnU-Net workhorse. ``compute_dtype`` is the dtype of the
    convolutions (the flax module's ``dtype``); inputs are cast to it.
    ``norm_onepass``, ``remat`` and ``trainable`` select the training form
    (module docstring)."""

    def __init__(self, input_channels: int, n_stages: int,
                 features_per_stage: Sequence[int], kernel_sizes, strides,
                 n_conv_per_stage: Sequence[int], num_classes: int,
                 n_conv_per_stage_decoder: Sequence[int],
                 conv_bias: bool = True, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01, dim: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm_onepass: bool = False, remat=False,
                 trainable: bool = False):
        super().__init__()
        if dim != 3:
            raise NotImplementedError("only 3D networks are ported")
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{remat!r}")
        if not isinstance(remat, str):
            remat = bool(remat)
        ks = as_tuples(kernel_sizes, n_stages, dim)
        st = as_tuples(strides, n_stages, dim)
        self.input_channels = int(input_channels)
        self.num_classes = int(num_classes)
        self.compute_dtype = compute_dtype
        self.trainable = bool(trainable)
        self.encoder = PlainConvEncoder(
            input_channels, n_stages, features_per_stage, ks, st,
            n_conv_per_stage, conv_bias, norm_eps, nonlin_negative_slope,
            norm_onepass, remat)
        self.decoder = UNetDecoder(
            num_classes, features_per_stage, ks, st, n_conv_per_stage_decoder,
            conv_bias, norm_eps, nonlin_negative_slope, norm_onepass, remat)
        self.requires_grad_(self.trainable)
        if not self.trainable:
            for m in self.modules():
                if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                    m.to(compute_dtype)

    def forward(self, x: torch.Tensor, deep_supervision: bool = False):
        return self.decoder(self.encoder(x.to(self.compute_dtype)),
                            deep_supervision=deep_supervision)


# ----------------------------------------------------------- weight carrier
def _load_conv(mod: nn.Module, t: dict, path: str, dt: torch.dtype,
               transposed: bool = False) -> None:
    w = _transpconv_weight(t["kernel"]) if transposed \
        else _conv_weight(t["kernel"])
    _set(mod.weight, w, path + "/kernel", dt)
    if mod.bias is not None:
        _set(mod.bias, t.get("bias", np.zeros(mod.bias.shape[0], np.float32)),
             path + "/bias", dt)
    elif "bias" in t:
        raise ValueError(f"{path}: tree has a bias, the module has none")


def _load_stack(stack: StackedConvBlocks, t: dict, path: str,
                dt: torch.dtype) -> None:
    _same_keys(stack.blocks, t, path)
    for name, blk in stack.blocks.items():
        _load_conv(blk.conv, t[name]["conv"], f"{path}/{name}/conv", dt)
        norm: InstanceNorm = blk.norm
        _set(norm.weight, t[name]["norm"]["scale"],
             f"{path}/{name}/norm/scale", torch.float32)
        _set(norm.bias, t[name]["norm"]["bias"], f"{path}/{name}/norm/bias",
             torch.float32)


def _same_keys(mods, t: dict, path: str) -> None:
    if set(mods.keys()) != set(t.keys()):
        raise ValueError(f"{path}: tree keys {sorted(t)} != module keys "
                         f"{sorted(mods.keys())}")


def params_from_jax(net: PlainConvUNet, tree: dict) -> PlainConvUNet:
    """Load a JAX-package PlainConvUNet tree (``{"params": {"encoder": ...,
    "decoder": ...}}`` of numpy arrays, every seg head included) into
    ``net``. Convolution and transposed-convolution weights are stored in
    the compute dtype (float32 in a ``trainable`` network), norm parameters
    in float32; a tree whose structure or shapes differ from the module
    raises."""
    p = tree["params"] if "params" in tree else tree
    dt = torch.float32 if net.trainable else net.compute_dtype
    _same_keys(net.encoder.stages, p["encoder"], "encoder")
    for name, stage in net.encoder.stages.items():
        _load_stack(stage, p["encoder"][name], f"encoder/{name}", dt)
    _same_keys(net.decoder.mods, p["decoder"], "decoder")
    for name, mod in net.decoder.mods.items():
        t, path = p["decoder"][name], f"decoder/{name}"
        if isinstance(mod, StackedConvBlocks):
            _load_stack(mod, t, path, dt)
        else:
            _load_conv(mod, t, path, dt,
                       transposed=isinstance(mod, nn.ConvTranspose3d))
    return net


def jax_param_paths(net: PlainConvUNet) -> List[Tuple[tuple, nn.Parameter,
                                                    str]]:
    """(flax tree path, parameter, layout kind) for every parameter of
    ``net``; the kind is "conv", "transpconv" or "vector" (see
    :func:`to_flax_layout`)."""
    out = []

    def conv(mod, path, kind):
        out.append((path + ("kernel",), mod.weight, kind))
        if mod.bias is not None:
            out.append((path + ("bias",), mod.bias, "vector"))

    def stack(st, path):
        for name, blk in st.blocks.items():
            conv(blk.conv, path + (name, "conv"), "conv")
            out.append((path + (name, "norm", "scale"), blk.norm.weight,
                        "vector"))
            out.append((path + (name, "norm", "bias"), blk.norm.bias,
                        "vector"))

    for name, st in net.encoder.stages.items():
        stack(st, ("params", "encoder", name))
    for name, mod in net.decoder.mods.items():
        path = ("params", "decoder", name)
        if isinstance(mod, StackedConvBlocks):
            stack(mod, path)
        else:
            conv(mod, path, "transpconv"
                 if isinstance(mod, nn.ConvTranspose3d) else "conv")
    return out


def to_flax_layout(kind: str, w: np.ndarray) -> np.ndarray:
    """torch layout -> flax layout: conv (O, I, *k) -> (*k, I, O);
    transposed conv (I, O, *k) -> (*k, I, O) mirrored (flax applies its
    transposed kernels mirrored); vectors unchanged."""
    if kind == "conv":
        w = np.transpose(w, (2, 3, 4, 1, 0))
    elif kind == "transpconv":
        w = np.transpose(w, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1]
    return np.ascontiguousarray(w)


def from_flax_layout(kind: str, w: np.ndarray) -> np.ndarray:
    """The inverse of :func:`to_flax_layout`."""
    if kind == "conv":
        return _conv_weight(w)
    if kind == "transpconv":
        return _transpconv_weight(w)
    return np.asarray(w)


def tree_to_jax(net: PlainConvUNet, value: Callable) -> dict:
    """A flax-shaped tree of float32 numpy arrays holding ``value(param)``
    (a tensor in the parameter's torch layout) for every parameter."""
    tree: dict = {}
    for path, prm, kind in jax_param_paths(net):
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        t = value(prm).detach().to(device="cpu", dtype=torch.float32)
        d[path[-1]] = to_flax_layout(kind, t.numpy())
    return tree


def tree_get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def params_to_jax(net: PlainConvUNet) -> dict:
    """The inverse of :func:`params_from_jax`: ``net``'s weights as a
    JAX-package PlainConvUNet tree (``{"params": {"encoder": ...,
    "decoder": ...}}``, nested dicts of float32 numpy arrays, flax kernel
    layouts)."""
    return tree_to_jax(net, lambda p: p)


def init_he_normal_(net: PlainConvUNet, seed: int,
                    negative_slope: float = 1e-2) -> PlainConvUNet:
    """Fresh weights as the JAX package initialises them (he_normal_init):
    kernels normal with std sqrt(2 / ((1 + a^2) fan_in)), fan_in = input
    channels x kernel volume; biases 0; norm scales 1. Seeded with a
    ``torch.Generator`` on the CPU, so the draw does not depend on the
    device."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for path, prm, kind in jax_param_paths(net):
            if path[-1] == "kernel":
                cin = prm.shape[0] if kind == "transpconv" else prm.shape[1]
                fan_in = cin * math.prod(prm.shape[2:])
                std = math.sqrt(2.0 / (1.0 + negative_slope ** 2) / fan_in)
                w = torch.randn(prm.shape, generator=gen) * std
            elif path[-2] == "norm" and path[-1] == "scale":
                w = torch.ones(prm.shape)
            else:
                w = torch.zeros(prm.shape)
            prm.copy_(w.to(prm.dtype))
    return net


def params_from_jax_partial(net: PlainConvUNet, tree: dict
                            ) -> Tuple[int, int]:
    """Tolerant load (the JAX ``restore_params_partial``): every parameter
    whose flax path exists in ``tree`` with the same shape is copied, the
    rest keep their values. Returns (n_loaded, n_total)."""
    if "params" not in tree:
        tree = {"params": tree}
    items = jax_param_paths(net)
    n_loaded = 0
    for path, prm, kind in items:
        try:
            w = from_flax_layout(kind, tree_get(tree, path))
        except (KeyError, TypeError):
            continue
        if tuple(w.shape) == tuple(prm.shape):
            prm.data = torch.tensor(np.asarray(w, np.float32),
                                    device=prm.device, dtype=prm.dtype)
            n_loaded += 1
    return n_loaded, len(items)


def restore(net: PlainConvUNet, checkpoint: str) -> dict:
    """Load a ``.fnnx`` checkpoint's ``network_weights`` into ``net``
    (numpy-only unpickler, training/checkpoint.py); returns the checkpoint
    dict."""
    ckpt = load_checkpoint(checkpoint)
    params_from_jax(net, ckpt["network_weights"])
    return ckpt
