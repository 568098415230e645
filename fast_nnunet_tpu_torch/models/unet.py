"""The U-Nets as ``nn.Module``s — the port of fast_nnunet_tpu/models/unet.py:
``PlainConvUNet`` (and, width-reduced, the LiteNNUNetStudent) and
``ResidualEncoderUNet`` (nnU-Net's ResEnc M/L/XL presets, and reduced, the
LiteResEncStudent).

Forward contract: input (B, C_in, X, Y, Z) in NCDHW with the JAX package's
spatial order; output float32 logits (B, K, X, Y, Z) of the full-resolution
seg head, or, with ``deep_supervision=True``, a tuple of every decoder
stage's logits, highest resolution first. Every seg head is a parameter
whether or not deep supervision is asked for, so a JAX checkpoint loads 1:1;
without it only the full-resolution head runs (the JAX module computes all
heads and returns the first: same result).

The residual encoder is a stem (one conv -> norm -> leaky ReLU at stride
1) and ``n_blocks_per_stage[s]`` ``BasicResBlockD`` per stage, the first
carrying the stage's stride; its skips feed the same ``UNetDecoder``.

Weights come from the JAX package's flax trees through
:func:`params_from_jax` (the conv / transposed-conv conventions that
models/s2d.py pins, the transposed-conv flip included) or from a ``.fnnx``
checkpoint through :func:`restore`; :func:`params_to_jax` is the inverse
(the training checkpoint writer uses it). One list per network,
:func:`jax_param_paths` (flax path, tensor, layout kind), drives both and
:func:`init_he_normal_` and :func:`params_from_jax_partial`; a BatchNorm
network adds the ``batch_stats`` collection (``{mean, var}`` per norm)
beside ``params``.

Two forms: the inference form (default) holds its conv weights in the
compute dtype and no gradients; ``trainable=True`` holds float32 master
parameters with gradients, cast to the compute dtype inside the forward (as
flax with ``dtype=bf16`` and float32 params). Training builds also take
``norm="instance1p"`` (models/blocks.py) and ``remat`` with the JAX rule:
any truthy value checkpoints every encoder stack (every residual block, not
the stem); ``True`` every decoder stack too, ``"light"`` only the
full-resolution decoder stack, ``"encoder"`` none of them.
"""
import math
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..training.checkpoint import load_checkpoint
from .blocks import (BasicResBlockD, BatchStatsNorm, ConvDropoutNormReLU,
                     ConvTranspose3d, Conv3d, StackedConvBlocks)
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
                 norm: str = "instance", remat=False):
        super().__init__()
        f = [int(v) for v in features_per_stage]
        self.stages = nn.ModuleDict({
            f"stage_{s}": StackedConvBlocks(
                n_conv_per_stage[s], input_channels if s == 0 else f[s - 1],
                f[s], kernel_sizes[s], strides[s], conv_bias, norm_eps,
                nonlin_negative_slope, norm, bool(remat))
            for s in range(int(n_stages))})

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        skips = []
        for stage in self.stages.values():
            x = stage(x)
            skips.append(x)
        return tuple(skips)


class ResidualEncoder(nn.Module):
    """``stem`` then ``BasicResBlockD`` children ``stage_{s}_block_{b}`` (the
    flax names); with ``remat`` each block is recomputed in the backward,
    the stem is not (JAX unet.py:97)."""

    def __init__(self, input_channels: int, n_stages: int,
                 features_per_stage: Sequence[int], kernel_sizes, strides,
                 n_blocks_per_stage: Sequence[int], conv_bias: bool = True,
                 norm_eps: float = 1e-5, nonlin_negative_slope: float = 0.01,
                 norm: str = "instance", remat=False):
        super().__init__()
        f = [int(v) for v in features_per_stage]
        ones = (1,) * len(kernel_sizes[0])
        self.stem = ConvDropoutNormReLU(input_channels, f[0], kernel_sizes[0],
                                        ones, conv_bias, norm_eps,
                                        nonlin_negative_slope, norm)
        self.blocks = nn.ModuleDict()
        self.stage_ends = []    # index of each stage's last block
        cin = f[0]
        for s in range(int(n_stages)):
            for b in range(int(n_blocks_per_stage[s])):
                self.blocks[f"stage_{s}_block_{b}"] = BasicResBlockD(
                    cin, f[s], kernel_sizes[s], strides[s] if b == 0 else ones,
                    conv_bias, norm_eps, nonlin_negative_slope, norm)
                cin = f[s]
            self.stage_ends.append(len(self.blocks) - 1)
        self.remat = bool(remat)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x)
        skips = []
        ends = set(self.stage_ends)
        for i, blk in enumerate(self.blocks.values()):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
            if i in ends:
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
                 norm: str = "instance", remat=False):
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
                nonlin_negative_slope, norm,
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


class _UNet(nn.Module):
    """What both U-Nets share: the input cast to ``compute_dtype`` (the
    flax module's ``dtype``), the decoder, and the two forms (module
    docstring): ``trainable`` float32 master parameters with gradients, or
    the inference form's conv weights in the compute dtype."""

    def __init__(self, input_channels: int, n_stages: int,
                 features_per_stage: Sequence[int], kernel_sizes, strides,
                 num_classes: int, n_conv_per_stage_decoder: Sequence[int],
                 make_encoder: Callable, conv_bias: bool = True,
                 norm_eps: float = 1e-5, nonlin_negative_slope: float = 0.01,
                 dim: int = 3, compute_dtype: torch.dtype = torch.bfloat16,
                 norm: str = "instance", remat=False,
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
        self.encoder = make_encoder(ks, st, dict(
            conv_bias=conv_bias, norm_eps=norm_eps,
            nonlin_negative_slope=nonlin_negative_slope, norm=norm,
            remat=remat))
        self.decoder = UNetDecoder(
            num_classes, features_per_stage, ks, st, n_conv_per_stage_decoder,
            conv_bias, norm_eps, nonlin_negative_slope, norm, remat)
        self.requires_grad_(self.trainable)
        if not self.trainable:
            for m in self.modules():
                if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                    m.to(compute_dtype)

    def forward(self, x: torch.Tensor, deep_supervision: bool = False):
        return self.decoder(self.encoder(x.to(self.compute_dtype)),
                            deep_supervision=deep_supervision)


class PlainConvUNet(_UNet):
    """The nnU-Net workhorse. ``norm``, ``remat`` and ``trainable`` select
    the training form (module docstring)."""

    def __init__(self, input_channels: int, n_stages: int,
                 features_per_stage: Sequence[int], kernel_sizes, strides,
                 n_conv_per_stage: Sequence[int], num_classes: int,
                 n_conv_per_stage_decoder: Sequence[int], **kw):
        super().__init__(
            input_channels, n_stages, features_per_stage, kernel_sizes,
            strides, num_classes, n_conv_per_stage_decoder,
            lambda ks, st, common: PlainConvEncoder(
                input_channels, n_stages, features_per_stage, ks, st,
                n_conv_per_stage, **common), **kw)


class ResidualEncoderUNet(_UNet):
    """nnU-Net's residual-encoder U-Net (JAX unet.py:247-287): a
    :class:`ResidualEncoder` under the plain decoder."""

    def __init__(self, input_channels: int, n_stages: int,
                 features_per_stage: Sequence[int], kernel_sizes, strides,
                 n_blocks_per_stage: Sequence[int], num_classes: int,
                 n_conv_per_stage_decoder: Sequence[int], **kw):
        super().__init__(
            input_channels, n_stages, features_per_stage, kernel_sizes,
            strides, num_classes, n_conv_per_stage_decoder,
            lambda ks, st, common: ResidualEncoder(
                input_channels, n_stages, features_per_stage, ks, st,
                n_blocks_per_stage, **common), **kw)


def remat_modules(net: nn.Module) -> List[nn.Module]:
    """The modules whose forward a training step recomputes in the
    backward: checkpointed conv stacks and, under a remat residual encoder,
    every residual block."""
    mods = [m for m in net.modules()
            if isinstance(m, StackedConvBlocks) and m.remat]
    enc = net.encoder
    if isinstance(enc, ResidualEncoder) and enc.remat:
        mods += list(enc.blocks.values())
    return mods


# ----------------------------------------------------------- weight carrier
def jax_param_paths(net: nn.Module) -> List[Tuple[tuple, torch.Tensor, str]]:
    """(flax tree path, tensor, layout kind) for every parameter of
    ``net`` (collection ``params``) and every running average of its
    BatchNorms (collection ``batch_stats``), in module order; the kind is
    "conv", "transpconv" or "vector" (see :func:`to_flax_layout`). The one
    description of a network's tree that the loaders, the writers and the
    initialiser read."""
    out = []

    def conv(mod, path, kind="conv"):
        out.append((("params",) + path + ("kernel",), mod.weight, kind))
        if mod.bias is not None:
            out.append((("params",) + path + ("bias",), mod.bias, "vector"))

    def norm(mod, path):
        out.append((("params",) + path + ("scale",), mod.weight, "vector"))
        out.append((("params",) + path + ("bias",), mod.bias, "vector"))
        if isinstance(mod, BatchStatsNorm):
            out.append((("batch_stats",) + path + ("mean",),
                        mod.running_mean, "vector"))
            out.append((("batch_stats",) + path + ("var",),
                        mod.running_var, "vector"))

    def unit(blk, path):
        for name, mod in blk.named_children():
            (conv if isinstance(mod, nn.Conv3d) else norm)(mod, path + (name,))

    def stack(st, path):
        for name, blk in st.blocks.items():
            unit(blk, path + (name,))

    enc = net.encoder
    if isinstance(enc, ResidualEncoder):
        unit(enc.stem, ("encoder", "stem"))
        for name, blk in enc.blocks.items():
            unit(blk, ("encoder", name))
    else:
        for name, st in enc.stages.items():
            stack(st, ("encoder", name))
    for name, mod in net.decoder.mods.items():
        path = ("decoder", name)
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


def tree_to_jax(net: nn.Module, value: Callable,
                collections: Sequence[str] = ("params",)) -> dict:
    """A flax-shaped tree of float32 numpy arrays holding ``value(tensor)``
    (a tensor in the torch layout) for every entry of ``collections``."""
    tree: dict = {}
    for path, prm, kind in jax_param_paths(net):
        if path[0] not in collections:
            continue
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        t = value(prm).detach().to(device="cpu", dtype=torch.float32,
                                   copy=True)   # no view of live weights
        d[path[-1]] = to_flax_layout(kind, t.numpy())
    return tree


def tree_get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _leaf_paths(tree, prefix=()) -> List[tuple]:
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k, v in tree.items() for p in _leaf_paths(v, prefix + (k,))]


def _with_collections(tree: dict) -> dict:
    """A bare ``params`` tree gets its ``{"params": ...}`` wrapper."""
    return tree if "params" in tree else {"params": tree}


def params_from_jax(net: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX-package U-Net tree (``{"params": {"encoder": ...,
    "decoder": ...}[, "batch_stats": ...]}`` of numpy arrays, every seg
    head included) into ``net``, each tensor in the dtype the module holds
    it in. A tree whose structure or shapes differ from the module raises
    (a conv bias missing from the tree loads as zeros)."""
    tree = _with_collections(tree)
    items = jax_param_paths(net)
    want = {path for path, _, _ in items}
    have = set(_leaf_paths(tree))
    missing = want - have
    optional = {p for p in missing
                if p[-1] == "bias" and p[:-1] + ("kernel",) in have}
    if have - want or missing - optional:
        raise ValueError(
            "tree and module differ: only in the tree "
            f"{sorted('/'.join(p) for p in have - want)[:4]}, only in the "
            f"module {sorted('/'.join(p) for p in missing - optional)[:4]}")
    for path, t, kind in items:
        v = np.zeros(t.shape, np.float32) if path in optional \
            else from_flax_layout(kind, tree_get(tree, path))
        _set(t, v, "/".join(path), t.dtype)
    return net


def params_to_jax(net: nn.Module) -> dict:
    """The inverse of :func:`params_from_jax`: ``net``'s weights (and a
    BatchNorm network's running averages) as a JAX-package tree, nested
    dicts of float32 numpy arrays in flax kernel layouts."""
    return tree_to_jax(net, lambda p: p, ("params", "batch_stats"))


def init_he_normal_(net: nn.Module, seed: int,
                    negative_slope: float = 1e-2) -> nn.Module:
    """Fresh weights as the JAX package initialises them (he_normal_init):
    kernels normal with std sqrt(2 / ((1 + a^2) fan_in)), fan_in = input
    channels x kernel volume; biases and running means 0; norm scales and
    running variances 1. Seeded with a ``torch.Generator`` on the CPU, so
    the draw does not depend on the device."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for path, prm, kind in jax_param_paths(net):
            if path[-1] == "kernel":
                cin = prm.shape[0] if kind == "transpconv" else prm.shape[1]
                fan_in = cin * math.prod(prm.shape[2:])
                std = math.sqrt(2.0 / (1.0 + negative_slope ** 2) / fan_in)
                w = torch.randn(prm.shape, generator=gen) * std
            elif path[-1] in ("scale", "var"):
                w = torch.ones(prm.shape)
            else:
                w = torch.zeros(prm.shape)
            prm.copy_(w.to(prm.dtype))
    return net


def params_from_jax_partial(net: nn.Module, tree: dict) -> Tuple[int, int]:
    """Tolerant load (the JAX ``restore_params_partial``): every entry
    whose flax path exists in ``tree`` with the same shape is copied, the
    rest keep their values. Returns (n_loaded, n_total)."""
    tree = _with_collections(tree)
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


def restore(net: nn.Module, checkpoint: str) -> dict:
    """Load a ``.fnnx`` checkpoint's ``network_weights`` into ``net``
    (numpy-only unpickler, training/checkpoint.py); returns the checkpoint
    dict."""
    ckpt = load_checkpoint(checkpoint)
    params_from_jax(net, ckpt["network_weights"])
    return ckpt
