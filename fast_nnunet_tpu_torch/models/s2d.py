"""Space-to-depth (s2d) inference form of PlainConvUNet — the port of
fast_nnunet_tpu/models/s2d.py.

The transform is exact (same function, re-parameterized): the outermost
octave runs one level down, with 2x2x2 voxel blocks folded into channels.

- full-res stride-1 3^3 conv -> half-res stride-1 3^3 conv, 8Ci -> 8Co
- full-res stride-2 3^3 conv -> half-res 2^3 conv, 8Ci -> Co, input padded
  (1, 0) per axis
- k=2 s=2 transposed conv    -> half-res 1^3 conv, Ci -> 8Co
- 1^3 seg head               -> per-offset (F, K) products (block-diagonal)
- InstanceNorm over full-res voxels == norm over (half-res voxels x 8
  offsets) per logical channel

Layout: tensors are NCDHW (torch's), with the JAX package's spatial order
(X, Y, Z) as (D, H, W). s2d channels are offset-major: channel o*C + c holds
logical channel c at offset o = (dx*2 + dy)*2 + dz.

Parameters come from the JAX package's trees: :func:`convert_params` (a copy
of the numpy transform) turns a plain PlainConvUNet flax tree into the s2d
tree, and :func:`params_from_jax` loads such a tree into the module. flax
kernels are (*k, I, O); torch's are (O, I, *k) for convolutions and
(I, O, *k), spatially flipped, for transposed convolutions.

InstanceNorm statistics of every activation with >= 4096 spatial voxels come
from kernel A (ops/stats.py) — the gate fast_nnunet_tpu applies to its
Pallas stats path, which the port always takes.
"""
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stats import spatial_sum_sumsq

_OFFSETS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]

#: InstanceNorm moments come from kernel A at or above this many voxels
STATS_MIN_VOXELS = 4096


def _olin(o) -> int:
    return (o[0] * 2 + o[1]) * 2 + o[2]


# ------------------------------------------------------------------ layout ops
def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, X, Y, Z) -> (B, 8C, X/2, Y/2, Z/2), offset-major channels."""
    B, C, X, Y, Z = x.shape
    x = x.reshape(B, C, X // 2, 2, Y // 2, 2, Z // 2, 2)
    x = x.permute(0, 3, 5, 7, 1, 2, 4, 6)
    return x.reshape(B, 8 * C, X // 2, Y // 2, Z // 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of space_to_depth."""
    B, C8, X2, Y2, Z2 = x.shape
    C = C8 // 8
    x = x.reshape(B, 2, 2, 2, C, X2, Y2, Z2)
    x = x.permute(0, 4, 5, 1, 6, 2, 7, 3)
    return x.reshape(B, C, 2 * X2, 2 * Y2, 2 * Z2)


def concat_grouped(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Concat two s2d tensors along the LOGICAL channel axis (within each
    offset group)."""
    sp = a.shape[2:]
    a8 = a.reshape(a.shape[0], 8, a.shape[1] // 8, *sp)
    b8 = b.reshape(b.shape[0], 8, b.shape[1] // 8, *sp)
    return torch.cat([a8, b8], 2).reshape(a.shape[0], a.shape[1] + b.shape[1],
                                          *sp)


# ------------------------------------------------- kernel transforms (numpy)
def expand_kernel_stride1(W: np.ndarray) -> np.ndarray:
    """(3,3,3,Ci,Co) full-res stride-1 -> (3,3,3,8Ci,8Co) half-res stride-1.
    y[2P+o] = sum_t x[2P+o+t-1] W[t]; o+t-1 = 2d + o2 maps each (o, t) to
    s2d tap d+1 and input offset group o2."""
    W = np.asarray(W)
    Ci, Co = W.shape[3], W.shape[4]
    out = np.zeros((3, 3, 3, 8, Ci, 8, Co), W.dtype)
    for o in _OFFSETS:
        for t in np.ndindex(3, 3, 3):
            u = np.array(t) - 1 + np.array(o)
            d, o2 = u // 2, u % 2
            out[d[0] + 1, d[1] + 1, d[2] + 1, _olin(o2), :, _olin(o), :] = W[t]
    return out.reshape(3, 3, 3, 8 * Ci, 8 * Co)


def expand_kernel_downsample(W: np.ndarray) -> np.ndarray:
    """(3,3,3,Ci,Co) full-res stride-2 -> (2,2,2,8Ci,Co) half-res stride-1
    with per-axis padding (1, 0). y[P] = sum_t x[2P+t-1] W[t]."""
    W = np.asarray(W)
    Ci, Co = W.shape[3], W.shape[4]
    out = np.zeros((2, 2, 2, 8, Ci, Co), W.dtype)
    for t in np.ndindex(3, 3, 3):
        u = np.array(t) - 1
        d, o2 = u // 2, u % 2
        out[d[0] + 1, d[1] + 1, d[2] + 1, _olin(o2), :, :] = W[t]
    return out.reshape(2, 2, 2, 8 * Ci, Co)


def expand_kernel_transpconv(K: np.ndarray) -> np.ndarray:
    """(2,2,2,Ci,Co) k=2 s=2 flax transposed conv -> (1,1,1,Ci,8Co) half-res
    conv; flax applies the kernel mirrored: out[2P+o] uses tap K[1-o]."""
    K = np.asarray(K)
    Ci, Co = K.shape[3], K.shape[4]
    out = np.zeros((1, 1, 1, Ci, 8, Co), K.dtype)
    for o in _OFFSETS:
        out[0, 0, 0, :, _olin(o), :] = K[1 - o[0], 1 - o[1], 1 - o[2]]
    return out.reshape(1, 1, 1, Ci, 8 * Co)


def tile_bias(b: np.ndarray) -> np.ndarray:
    """Per-logical-channel bias -> per-(offset, channel) bias."""
    return np.tile(np.asarray(b), 8)


def expand_seg_head(W: np.ndarray) -> np.ndarray:
    """(1,1,1,F,K) 1^3 seg head -> block-diagonal (8F, 8K) matrix on the flat
    offset-major activations."""
    W = np.asarray(W)
    F_, K = W.shape[3], W.shape[4]
    out = np.zeros((8 * F_, 8 * K), W.dtype)
    for o in range(8):
        out[o * F_:(o + 1) * F_, o * K:(o + 1) * K] = W[0, 0, 0]
    return out


# ------------------------------------------------------------ instance norm
def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float, groups: int = 1,
                  stats_min_voxels: int = STATS_MIN_VOXELS) -> torch.Tensor:
    """InstanceNorm over the spatial dims of an NCDHW tensor. With groups=8
    the channels are (offset, logical) pairs and the statistics pool over
    the offsets too — full-resolution InstanceNorm in the s2d layout.
    ``scale``/``bias`` are per logical channel. At >= stats_min_voxels
    spatial voxels the moments come from kernel A (one pass, f32); below it
    from the two-pass mean/var of fast_nnunet_tpu's default path."""
    B, C8 = x.shape[0], x.shape[1]
    c = C8 // groups
    n_spatial = math.prod(x.shape[2:])
    if n_spatial >= stats_min_voxels:
        s, q = spatial_sum_sumsq(x)                          # (B, C8) f32
        n = n_spatial * groups
        mean = s.reshape(B, groups, c).sum(1) / n
        var = torch.clamp(q.reshape(B, groups, c).sum(1) / n - mean * mean,
                          min=0.0)
    else:
        x32 = x.float().reshape(B, C8, -1)
        mean_c = x32.mean(-1)
        var_c = x32.var(-1, correction=0)
        if groups == 1:
            mean, var = mean_c, var_c
        else:
            mean = mean_c.reshape(B, groups, c).mean(1)
            var = ((var_c + mean_c * mean_c).reshape(B, groups, c).mean(1)
                   - mean * mean)
    shape = (B, C8) + (1,) * (x.dim() - 2)
    m = mean.repeat(1, groups).reshape(shape)
    r = torch.rsqrt(var + eps).repeat(1, groups).reshape(shape)
    sc = scale.float().repeat(groups).reshape((1, C8) + (1,) * (x.dim() - 2))
    bi = bias.float().repeat(groups).reshape(sc.shape)
    y = x.to(torch.float32, copy=True)
    y.sub_(m).mul_(r).mul_(sc).add_(bi)
    return y.to(x.dtype)


# ------------------------------------------------------------------ modules
class _Norm(nn.Module):
    """Affine InstanceNorm parameters of one block (per logical channel,
    kept in float32 like the JAX package's params)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)


class _Block(nn.Module):
    """conv -> InstanceNorm -> LeakyReLU; ``pre_pad`` is the s2d
    downsample's asymmetric (1, 0) padding, applied with F.pad before a
    VALID conv (Conv3d only pads symmetrically)."""

    def __init__(self, cin: int, cout: int, kernel, stride, padding,
                 groups: int, eps: float, slope: float,
                 pre_pad: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, tuple(kernel), tuple(stride),
                              tuple(padding), bias=True)
        self.conv.requires_grad_(False)
        self.norm = _Norm(cout // groups)
        self.groups, self.eps, self.slope = groups, eps, slope
        self.pre_pad = pre_pad
        self.stats_min_voxels = STATS_MIN_VOXELS

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_pad is not None:
            x = F.pad(x, self.pre_pad)
        x = self.conv(x)
        x = instance_norm(x, self.norm.weight, self.norm.bias, self.eps,
                          self.groups, self.stats_min_voxels)
        return F.leaky_relu_(x, self.slope)


class _SegHead(nn.Module):
    """Expanded block-diagonal 1^3 seg head: weight (8F, 8K), bias (8K,)."""

    def __init__(self, f8: int, c8: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(f8, c8), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c8), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.einsum("bc...,ck->bk...", x, self.weight.to(x.dtype))
        return y + self.bias.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))


class S2DPlainConvUNet(nn.Module):
    """Inference-time s2d re-parameterization of a trained PlainConvUNet
    (counterpart of fast_nnunet_tpu.models.s2d.S2DPlainConvUNet). Weights
    arrive through :func:`params_from_jax`."""

    def __init__(self, n_stages: int, features_per_stage: Sequence[int],
                 n_conv_per_stage: Sequence[int],
                 n_conv_per_stage_decoder: Sequence[int],
                 num_classes: int, strides: Sequence[Sequence[int]],
                 kernel_sizes: Sequence[Sequence[int]],
                 input_channels: int = 1, norm_eps: float = 1e-5,
                 nonlin_negative_slope: float = 0.01,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_stages = n_stages
        self.features = [int(f) for f in features_per_stage]
        self.n_conv = [int(n) for n in n_conv_per_stage]
        self.n_conv_dec = [int(n) for n in n_conv_per_stage_decoder]
        self.num_classes = int(num_classes)
        self.strides = [tuple(int(v) for v in s) for s in strides]
        self.kernels = [tuple(int(v) for v in k) for k in kernel_sizes]
        self.input_channels = int(input_channels)
        self.compute_dtype = compute_dtype
        f, eps, slope = self.features, norm_eps, nonlin_negative_slope

        def same(k):
            return tuple(v // 2 for v in k)

        enc = nn.ModuleDict()
        stage0 = nn.ModuleDict()
        cin = 8 * self.input_channels
        for i in range(self.n_conv[0]):
            stage0[f"block_{i}"] = _Block(cin, 8 * f[0], (3, 3, 3), (1, 1, 1),
                                          (1, 1, 1), 8, eps, slope)
            cin = 8 * f[0]
        enc["stage_0"] = stage0
        for s in range(1, n_stages):
            stage = nn.ModuleDict()
            for i in range(self.n_conv[s]):
                if s == 1 and i == 0:
                    blk = _Block(8 * f[0], f[1], (2, 2, 2), (1, 1, 1),
                                 (0, 0, 0), 1, eps, slope,
                                 pre_pad=(1, 0, 1, 0, 1, 0))
                else:
                    blk = _Block(f[s - 1] if i == 0 else f[s], f[s],
                                 self.kernels[s],
                                 self.strides[s] if (i == 0 and s > 1)
                                 else (1, 1, 1),
                                 same(self.kernels[s]), 1, eps, slope)
                stage[f"block_{i}"] = blk
            enc[f"stage_{s}"] = stage
        self.encoder = enc

        dec = nn.ModuleDict()
        last = n_stages - 2
        for s in range(1, n_stages):
            d = s - 1
            cin, cout = f[-s], f[-(s + 1)]
            stage = nn.ModuleDict()
            if d < last:
                st = self.strides[-s]
                dec[f"transpconv_{d}"] = nn.ConvTranspose3d(
                    cin, cout, st, st, bias=True)
                for i in range(self.n_conv_dec[d]):
                    stage[f"block_{i}"] = _Block(
                        2 * cout if i == 0 else cout, cout,
                        self.kernels[-(s + 1)], (1, 1, 1),
                        same(self.kernels[-(s + 1)]), 1, eps, slope)
            else:
                dec[f"transpconv_{d}"] = nn.Conv3d(cin, 8 * cout, 1, bias=True)
                for i in range(self.n_conv_dec[d]):
                    stage[f"block_{i}"] = _Block(
                        16 * cout if i == 0 else 8 * cout, 8 * cout,
                        (3, 3, 3), (1, 1, 1), (1, 1, 1), 8, eps, slope)
                dec[f"seg_head_{d}"] = _SegHead(8 * cout, 8 * self.num_classes)
            dec[f"stage_{d}"] = stage
        self.decoder = dec
        self.requires_grad_(False)

    @staticmethod
    def supports(arch_kwargs: dict) -> bool:
        """True when the outer octave matches the transformable pattern."""
        try:
            ks = [tuple(k) for k in arch_kwargs["kernel_sizes"]]
            st = [tuple(s) for s in arch_kwargs["strides"]]
        except (KeyError, TypeError):
            return False
        return (len(st) >= 2 and len(ks[0]) == 3 and ks[0] == (3, 3, 3)
                and ks[1] == (3, 3, 3) and st[0] == (1, 1, 1)
                and st[1] == (2, 2, 2))

    # ---------------------------------------------------------- params convert
    def convert_params(self, params) -> dict:
        """Plain PlainConvUNet flax tree (nested numpy dicts) -> s2d tree;
        a copy of the JAX package's host-side transform."""
        p = params["params"]
        enc, dec = p["encoder"], p["decoder"]
        out_enc, out_dec = {}, {}
        for s in range(self.n_stages):
            stage = dict(enc[f"stage_{s}"])
            if s == 0:
                stage = {f"block_{i}": _convert_block(
                    stage[f"block_{i}"], expand_kernel_stride1, tile=True)
                    for i in range(self.n_conv[0])}
            elif s == 1:
                stage["block_0"] = _convert_block(
                    stage["block_0"], expand_kernel_downsample, tile=False)
            out_enc[f"stage_{s}"] = stage
        last = self.n_stages - 2
        for name, val in dec.items():
            if name == f"transpconv_{last}":
                val = dict(val)
                val["kernel"] = expand_kernel_transpconv(val["kernel"])
                if "bias" in val:
                    val["bias"] = tile_bias(val["bias"])
            elif name == f"stage_{last}":
                val = {f"block_{i}": _convert_block(
                    val[f"block_{i}"], expand_kernel_stride1, tile=True)
                    for i in range(self.n_conv_dec[last])}
            elif name == f"seg_head_{last}":
                val = dict(val)
                val["kernel"] = expand_seg_head(val["kernel"])
                if "bias" in val:
                    val["bias"] = tile_bias(val["bias"])
            out_dec[name] = val
        return {"params": {"encoder": out_enc, "decoder": out_dec}}

    # ------------------------------------------------------------------ forward
    def forward(self, x: torch.Tensor, return_features: bool = False,
                s2d_output: bool = False) -> torch.Tensor:
        """x (B, C, X, Y, Z), even spatial dims. Returns full-res logits
        (B, K, X, Y, Z); ``s2d_output`` the half-res offset-major logits
        (B, 8K, X/2, Y/2, Z/2); ``return_features`` the pre-seg-head s2d
        activations (B, 8F, X/2, Y/2, Z/2) that the sweep feeds kernel C."""
        if any(d % 2 for d in x.shape[2:]):
            raise ValueError(f"s2d needs even spatial dims, got {tuple(x.shape)}")
        enc, dec = self.encoder, self.decoder
        x = space_to_depth(x.to(self.compute_dtype))
        for blk in enc["stage_0"].values():
            x = blk(x)
        skip0 = x
        skips = [None]
        for s in range(1, self.n_stages):
            for blk in enc[f"stage_{s}"].values():
                x = blk(x)
            skips.append(x)
        last = self.n_stages - 2
        for s in range(1, self.n_stages):
            d = s - 1
            x = dec[f"transpconv_{d}"](x)
            if d < last:
                x = torch.cat([x, skips[-(s + 1)]], 1)
            else:
                x = concat_grouped(x, skip0)
            for blk in dec[f"stage_{d}"].values():
                x = blk(x)
        if return_features:
            return x
        seg = dec[f"seg_head_{last}"](x)
        return seg if s2d_output else depth_to_space(seg)

    def seg_head_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight (8F, 8K), bias (8K,)) of the expanded seg head, in the
        compute dtype (the values the head is applied with)."""
        hd = self.decoder[f"seg_head_{self.n_stages - 2}"]
        return hd.weight, hd.bias

    def set_stats_min_voxels(self, n: int) -> None:
        """Move the kernel-A gate (tests use it to drive both moment paths
        at small sizes)."""
        for m in self.modules():
            if isinstance(m, _Block):
                m.stats_min_voxels = int(n)


def _convert_block(blk, kernel_fn, tile: bool):
    conv = dict(blk["conv"])
    conv["kernel"] = kernel_fn(conv["kernel"])
    if tile and "bias" in conv:
        conv["bias"] = tile_bias(conv["bias"])
    return {"conv": conv, "norm": blk["norm"]}


# ----------------------------------------------------------- weight carrier
def _conv_weight(k: np.ndarray) -> np.ndarray:
    """flax conv kernel (kx, ky, kz, I, O) -> torch Conv3d (O, I, kx, ky, kz)
    (both are correlations)."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (4, 3, 0, 1, 2)))


def _transpconv_weight(k: np.ndarray) -> np.ndarray:
    """flax conv_transpose kernel (kx, ky, kz, I, O), which lax applies
    mirrored -> torch ConvTranspose3d (I, O, kx, ky, kz), unmirrored: undo the
    spatial flip fast_nnunet_tpu/utils/torch_import.py applies."""
    k = np.asarray(k)[::-1, ::-1, ::-1]
    return np.ascontiguousarray(np.transpose(k, (3, 4, 0, 1, 2)))


def _set(param: torch.Tensor, value: np.ndarray, path: str,
         dtype: torch.dtype) -> None:
    value = np.asarray(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{path}: tree shape {value.shape} != module shape "
                         f"{tuple(param.shape)}")
    param.data = torch.as_tensor(value.astype(np.float32)).to(
        device=param.device, dtype=dtype)


def params_from_jax(net: S2DPlainConvUNet, tree: dict) -> S2DPlainConvUNet:
    """Load a JAX-package s2d parameter tree (``{"params": {"encoder": ...,
    "decoder": ...}}`` of nested numpy arrays, as ``convert_params``
    returns) into ``net``. Conv, transposed-conv and seg-head weights are
    stored in the compute dtype (what the JAX apply casts them to), norm
    parameters in float32. Missing conv biases load as zeros; deep-
    supervision heads other than the full-res one are ignored."""
    p = tree["params"] if "params" in tree else tree
    dt = net.compute_dtype

    def load_block(blk: _Block, t: dict, path: str):
        _set(blk.conv.weight, _conv_weight(t["conv"]["kernel"]),
             path + "/conv/kernel", dt)
        cb = t["conv"].get("bias", np.zeros(blk.conv.out_channels, np.float32))
        _set(blk.conv.bias, cb, path + "/conv/bias", dt)
        _set(blk.norm.weight, t["norm"]["scale"], path + "/norm/scale",
             torch.float32)
        _set(blk.norm.bias, t["norm"]["bias"], path + "/norm/bias",
             torch.float32)

    for side in ("encoder", "decoder"):
        mods, sub = getattr(net, side), p[side]
        for name, mod in mods.items():
            path = f"{side}/{name}"
            t = sub[name]
            if name.startswith("stage_"):
                for bname, blk in mod.items():
                    load_block(blk, t[bname], f"{path}/{bname}")
            elif isinstance(mod, nn.ConvTranspose3d):
                _set(mod.weight, _transpconv_weight(t["kernel"]),
                     path + "/kernel", dt)
                _set(mod.bias, t.get("bias", np.zeros(mod.out_channels)),
                     path + "/bias", dt)
            elif isinstance(mod, nn.Conv3d):
                _set(mod.weight, _conv_weight(t["kernel"]), path + "/kernel",
                     dt)
                _set(mod.bias, t.get("bias", np.zeros(mod.out_channels)),
                     path + "/bias", dt)
            else:  # _SegHead
                _set(mod.weight, t["kernel"], path + "/kernel", dt)
                _set(mod.bias, t.get("bias", np.zeros(mod.bias.shape[0])),
                     path + "/bias", dt)
    return net


def make_s2d_engine_net(arch_kwargs: dict, num_classes: int,
                        input_channels: int = 1,
                        compute_dtype: torch.dtype = torch.bfloat16
                        ) -> Optional[S2DPlainConvUNet]:
    """The s2d network for a PlainConvUNet's arch kwargs, or None when the
    outer octave does not match the transformable pattern."""
    if not S2DPlainConvUNet.supports(arch_kwargs):
        return None
    norm_kw = arch_kwargs.get("norm_op_kwargs") or {}
    nonlin_kw = arch_kwargs.get("nonlin_kwargs") or {}
    return S2DPlainConvUNet(
        n_stages=arch_kwargs["n_stages"],
        features_per_stage=arch_kwargs["features_per_stage"],
        n_conv_per_stage=arch_kwargs["n_conv_per_stage"],
        n_conv_per_stage_decoder=arch_kwargs["n_conv_per_stage_decoder"],
        num_classes=num_classes, strides=arch_kwargs["strides"],
        kernel_sizes=arch_kwargs["kernel_sizes"],
        input_channels=input_channels,
        norm_eps=float(norm_kw.get("eps", 1e-5)),
        nonlin_negative_slope=float(nonlin_kw.get("negative_slope", 0.01)),
        compute_dtype=compute_dtype)


def random_plain_params(arch_kwargs: dict, input_channels: int,
                        num_classes: int, seed: int = 0) -> dict:
    """Seeded random weights for a PlainConvUNet in the JAX package's flax
    tree layout (nested numpy dicts, every deep-supervision head included),
    for smoke runs at full width without a trained checkpoint. Convs are
    He-normal, norms near identity."""
    rng = np.random.RandomState(seed)
    f = [int(v) for v in arch_kwargs["features_per_stage"]]
    ks = [tuple(k) for k in arch_kwargs["kernel_sizes"]]
    st = [tuple(s) for s in arch_kwargs["strides"]]
    n = int(arch_kwargs["n_stages"])

    def conv(k, ci, co):
        fan_in = ci * int(np.prod(k))
        return {"kernel": (rng.randn(*k, ci, co) * np.sqrt(2.0 / fan_in)
                           ).astype(np.float32),
                "bias": (rng.randn(co) * 0.01).astype(np.float32)}

    def block(k, ci, co):
        return {"conv": conv(k, ci, co),
                "norm": {"scale": (1 + 0.1 * rng.randn(co)).astype(np.float32),
                         "bias": (0.1 * rng.randn(co)).astype(np.float32)}}

    enc = {}
    for s in range(n):
        nb = int(arch_kwargs["n_conv_per_stage"][s])
        cin = input_channels if s == 0 else f[s - 1]
        enc[f"stage_{s}"] = {f"block_{i}": block(ks[s], cin if i == 0 else f[s],
                                                 f[s]) for i in range(nb)}
    dec = {}
    for s in range(1, n):
        d = s - 1
        cin, cout = f[-s], f[-(s + 1)]
        dec[f"transpconv_{d}"] = conv(st[-s], cin, cout)
        nb = int(arch_kwargs["n_conv_per_stage_decoder"][d])
        dec[f"stage_{d}"] = {f"block_{i}": block(ks[-(s + 1)],
                                                 2 * cout if i == 0 else cout,
                                                 cout) for i in range(nb)}
        head = conv((1, 1, 1), cout, num_classes)
        head["kernel"] *= np.float32(0.5)
        dec[f"seg_head_{d}"] = head
    return {"params": {"encoder": enc, "decoder": dec}}
