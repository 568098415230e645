"""Primus, the pure-transformer 3D segmentation network, as an ``nn.Module``
— the port of fast_nnunet_tpu/models/primus.py.

An 8^3 (``patch_embed_size``) strided conv turns the patch into tokens, a
learned position embedding is added, ``depth`` pre-LN blocks follow
(attention with a qk-norm and a learned per-head temperature, 3D axial
rotary position embeddings, a SwiGLU MLP, LayerScale, stochastic depth),
then a LayerNorm and a transposed-conv decoder (conv -> LayerNorm -> tanh
GELU per x2 step) back to full resolution and a 1x1x1 seg head.

Forward contract: input (B, C_in, X, Y, Z) in NCDHW with the JAX package's
spatial order, at exactly ``patch_size``; output float32 logits (B, K, X, Y,
Z), or a 1-tuple of them with ``deep_supervision=True`` (Primus has one
head). Tokens are in flax's order, ``reshape(B, -1, E)`` of the
channels-last grid, which is ``flatten(2).transpose(1, 2)`` of the
channels-first conv output.

Parameters are float32 and cast to ``compute_dtype`` where the flax module
casts them (its ``dtype``), so the arithmetic follows the flax module's
type promotion under bf16:
- every LayerNorm reduces in float32 with E[x^2] - E[x]^2 (flax's
  ``use_fast_variance``), epsilon 1e-6, and returns the compute dtype;
- the qk-norm is ``q / (|q| + 1e-6)`` in the compute dtype (the squares
  summed in float32), not ``F.normalize``'s ``max(|q|, eps)``;
- the rotary embedding multiplies q and k by float32 cos / sin, so the
  scores are a float32 product; they are scaled by the learned
  ``attn_temperature`` (H, 1, 1), softmaxed in float32 and cast to v's
  dtype before the AV product;
- ``h * ls1`` is compute dtype x float32, so the residual stream is
  float32 from the first block on;
- the decoder's GELU is the tanh approximation (``jax.nn.gelu``'s
  default); the seg head's output is cast to float32.
Attention in float32 is a plain ``torch.matmul`` + ``softmax``, the JAX
module's arithmetic (its XLA einsums, outside any Pallas kernel), so the
float32 network is held to JAX's. In bfloat16 (every trainer's and the
predictor's compute dtype) it goes through ops/attention.py's fused
attention (kernels F and G on the card, its plain version on the CPU): the
temperature times the rotated q_hat, and k_hat, are rounded to bf16 and
enter the product there, the scores and the softmax stay float32, and no
(B, H, T, T) tensor is kept for the backward. That is the one place the
bf16 network rounds otherwise than the JAX module, a decision taken with a
stated tolerance in place of parity (tests/test_torch_attention.py).

Tracing: ``Primus.timer`` (a ``utils.profiling.PhaseTimer``, None by
default; set it to trace) brackets each attention call in the phase
"attention" and counts the calls as ``attn_calls``; the fused attention
counts kernel F's launches as ``attn_fused`` and brackets its backward in
"attention_backward".

Drop path (stochastic depth, rate ``drop_path_rate * i / (depth - 1)`` in
block i) acts only when the forward is given a ``torch.Generator``; the
trainers never pass one, as the JAX trainers never pass a dropout rng.

The weight carrier :meth:`Primus.jax_param_paths` lists (flax path, tensor,
layout kind) for the flax tree ``patch_embed``, ``pos_embed``,
``block_{i}/{ls1, ls2, norm1, norm2, attn/{qkv, proj, attn_temperature},
mlp/{w1, w2, w3}}``, ``norm``, ``up_{i}``, ``up_norm_{i}``, ``seg_head``;
``models.unet``'s ``params_from_jax`` / ``params_to_jax`` and the
optimizer-state converters read it. :func:`init_primus_` draws fresh
weights from flax's initialisers.
"""
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention
from ..utils.profiling import phase

LN_EPS = 1e-6


def _rope_freqs(dim: int, length: int, base: float = 100.0) -> np.ndarray:
    """(length, dim/2) angles for one axis."""
    half = dim // 2
    inv = 1.0 / (base ** (np.arange(half) / max(half, 1)))
    return np.outer(np.arange(length), inv)


def make_3d_rope(grid: Tuple[int, int, int], head_dim: int) -> np.ndarray:
    """Axial 3D RoPE angles (tokens, head_dim / 2): ``head_dim // 6 * 2``
    rotary dims per axis, each rotated by its axis coordinate, zero-padded
    to head_dim / 2."""
    part = head_dim // 6 * 2
    angles = []
    for ax, g in enumerate(grid):
        a = _rope_freqs(part, g)
        shape = [1, 1, 1, a.shape[1]]
        shape[ax] = g
        a = np.broadcast_to(a.reshape(shape), (*grid, a.shape[-1]))
        angles.append(a.reshape(-1, a.shape[-1]))
    full = np.concatenate(angles, axis=-1)
    pad = head_dim // 2 - full.shape[-1]
    if pad > 0:
        full = np.concatenate([full, np.zeros((full.shape[0], pad))], -1)
    return full


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, T, H, hd); cos, sin (T, hd/2) float32: the first and second
    halves of hd rotated (concatenated, not interleaved). The result is
    float32, as in JAX (x times float32 cos / sin)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)`` over ``dim``: float32 statistics
    (E[x^2] - E[x]^2, clipped at 0), ``(x - mean) * (rsqrt(var + 1e-6) *
    scale) + bias`` in float32, returned in ``dtype``."""

    def __init__(self, features: int, dim: int = -1):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dim = dim

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(self.dim, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(self.dim, keepdim=True)
                              - mean * mean, 0.0)
        shape = [1] * x.dim()
        shape[self.dim] = -1
        mul = torch.rsqrt(var + LN_EPS) * self.weight.view(shape)
        return ((xf - mean) * mul + self.bias.view(shape)).to(dtype)


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


class EvaAttention(nn.Module):
    """The JAX module with ``scale_attn_inner=True`` (every trainer's and
    the predictor's setting): qk-norm, a learned temperature per head, the
    rotary embedding. In bfloat16 the product runs fused (module
    docstring)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = int(num_heads)
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.proj = nn.Linear(embed_dim, embed_dim)
        self.attn_temperature = nn.Parameter(
            torch.full((self.num_heads, 1, 1), 10.0))

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, timer=None) -> torch.Tensor:
        B, T, C = x.shape
        H = self.num_heads
        q, k, v = _linear(x, self.qkv).view(B, T, 3, H, C // H).unbind(2)
        q = apply_rope(q / (_l2_norm(q) + 1e-6), cos, sin)
        k = apply_rope(k / (_l2_norm(k) + 1e-6), cos, sin)
        if timer is not None:
            timer.count("attn_calls", 1)
        if v.dtype == torch.bfloat16:
            # tau * q_hat and k_hat in bf16, v read in place from qkv
            q = (q * self.attn_temperature.view(1, 1, H, 1)).to(v.dtype)
            k = k.to(v.dtype)
            with phase(timer, "attention"):
                out = fused_attention(q, k, v, timer)
            return _linear(out.reshape(B, T, C), self.proj)
        with phase(timer, "attention"):
            # float32 scores (q and k are float32 after the rotation)
            attn = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
            attn = torch.softmax(attn * self.attn_temperature[None], -1).to(
                v.dtype)
            out = torch.matmul(attn, v.transpose(1, 2))
        return _linear(out.transpose(1, 2).reshape(B, T, C), self.proj)


def _l2_norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1, keepdims=True)``: the squares in x's
    dtype summed in float32, cast back, then the square root."""
    return torch.sqrt((x * x).sum(-1, keepdim=True, dtype=torch.float32)
                      .to(x.dtype))


def swiglu_hidden(embed_dim: int, hidden_ratio: float = 8 / 3) -> int:
    return int(embed_dim * hidden_ratio / 64) * 64 or 64


class SwiGLU(nn.Module):
    def __init__(self, embed_dim: int, hidden_ratio: float = 8 / 3):
        super().__init__()
        hidden = swiglu_hidden(embed_dim, hidden_ratio)
        self.w1 = nn.Linear(embed_dim, hidden)
        self.w2 = nn.Linear(embed_dim, hidden)
        self.w3 = nn.Linear(hidden, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.silu(_linear(x, self.w1)) * _linear(x, self.w2),
                       self.w3)


class PrimusBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 init_values: float = 0.1, drop_path_rate: float = 0.0):
        super().__init__()
        self.ls1 = nn.Parameter(torch.full((embed_dim,), float(init_values)))
        self.ls2 = nn.Parameter(torch.full((embed_dim,), float(init_values)))
        self.norm1 = LayerNorm(embed_dim)
        self.attn = EvaAttention(embed_dim, num_heads)
        self.norm2 = LayerNorm(embed_dim)
        self.mlp = SwiGLU(embed_dim)
        self.drop_path_rate = float(drop_path_rate)

    def forward(self, x: torch.Tensor, cos, sin, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None,
                timer=None) -> torch.Tensor:
        h = self.attn(self.norm1(x, dtype), cos, sin, timer)
        x = x + self._drop_path(h * self.ls1, generator)
        h = self.mlp(self.norm2(x, dtype))
        return x + self._drop_path(h * self.ls2, generator)

    def _drop_path(self, x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """Stochastic depth: each sample's branch kept with probability 1 -
        rate and rescaled; only with a generator (JAX's apply with
        ``deterministic=False``), never in the trainers."""
        if generator is None or self.drop_path_rate == 0.0:
            return x
        keep = 1.0 - self.drop_path_rate
        mask = torch.bernoulli(
            torch.full((x.shape[0], 1, 1), keep, device=generator.device),
            generator=generator).to(x.device, x.dtype)
        return x * mask / keep


class Primus(nn.Module):
    """input (B, C_in, *patch) -> float32 logits (B, K, *patch). The patch
    must be divisible by the token size ``patch_embed_size`` (ValueError
    otherwise, where the JAX module asserts). The JAX module's
    ``scale_attn_inner`` and ``use_rope`` are True in every caller of
    either package, and are so here. ``trainable`` only decides whether
    the float32 parameters take gradients."""

    def __init__(self, input_channels: int, embed_dim: int,
                 patch_embed_size: Sequence[int], num_classes: int,
                 depth: int, num_heads: int, patch_size: Sequence[int],
                 drop_path_rate: float = 0.2, init_values: float = 0.1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 trainable: bool = False):
        super().__init__()
        pe = tuple(int(p) for p in patch_embed_size)
        patch = tuple(int(p) for p in patch_size)
        if any(p % e for p, e in zip(patch, pe)):
            raise ValueError(f"patch {patch} not divisible by token size {pe}")
        self.input_channels = int(input_channels)
        self.num_classes = int(num_classes)
        self.embed_dim = int(embed_dim)
        self.depth = int(depth)
        self.num_heads = int(num_heads)
        self.patch_embed_size = pe
        self.patch_size = patch
        self.grid = tuple(p // e for p, e in zip(patch, pe))
        self.init_values = float(init_values)
        self.compute_dtype = compute_dtype
        self.trainable = bool(trainable)
        n_tokens = math.prod(self.grid)

        self.patch_embed = nn.Conv3d(input_channels, embed_dim, pe, pe)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, embed_dim))
        self.blocks = nn.ModuleList(
            PrimusBlock(embed_dim, num_heads, init_values,
                        drop_path_rate * i / max(depth - 1, 1))
            for i in range(depth))
        self.norm = LayerNorm(embed_dim)
        ups, up_norms = [], []
        ch = embed_dim
        for i in range(int(np.log2(max(pe)))):
            stride = tuple(2 if (u >> i) > 1 else 1 for u in pe)
            out = max(ch // 2, 32)
            ups.append(nn.ConvTranspose3d(ch, out, stride, stride))
            up_norms.append(LayerNorm(out, dim=1))
            ch = out
        self.ups = nn.ModuleList(ups)
        self.up_norms = nn.ModuleList(up_norms)
        self.seg_head = nn.Conv3d(ch, num_classes, 1)
        angles = torch.tensor(make_3d_rope(self.grid, embed_dim // num_heads),
                              dtype=torch.float32)
        self.register_buffer("rope_cos", torch.cos(angles), persistent=False)
        self.register_buffer("rope_sin", torch.sin(angles), persistent=False)
        self.requires_grad_(self.trainable)
        #: optional utils.profiling.PhaseTimer (module docstring)
        self.timer = None

    def forward(self, x: torch.Tensor, deep_supervision: bool = False, *,
                generator: Optional[torch.Generator] = None):
        """``generator``: stochastic depth on, drawn from it (JAX's
        ``deterministic=False`` with a dropout rng); without one it is off,
        as in every JAX apply the trainers and the predictor make."""
        dt = self.compute_dtype
        pe = self.patch_embed
        h = F.conv3d(x.to(dt), pe.weight.to(dt), pe.bias.to(dt), pe.stride)
        B = h.shape[0]
        tokens = h.flatten(2).transpose(1, 2)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        for blk in self.blocks:
            tokens = blk(tokens, self.rope_cos, self.rope_sin, dt, generator,
                         self.timer)
        tokens = self.norm(tokens, dt)
        h = tokens.transpose(1, 2).reshape(B, self.embed_dim, *self.grid)
        for up, norm in zip(self.ups, self.up_norms):
            h = F.conv_transpose3d(h, up.weight.to(dt), up.bias.to(dt),
                                   up.stride)
            h = F.gelu(norm(h, dt), approximate="tanh")
        sh = self.seg_head
        logits = F.conv3d(h, sh.weight.to(dt), sh.bias.to(dt)).float()
        return (logits,) if deep_supervision else logits

    # ------------------------------------------------------- weight carrier
    def jax_param_paths(self) -> List[Tuple[tuple, torch.Tensor, str]]:
        """(flax path, tensor, layout kind) of every parameter: "conv"
        ((O, I, *k) <-> (*k, I, O)), "transpconv" (with flax's spatial
        flip), "dense" ((out, in) <-> (in, out)) or "vector" (unchanged:
        biases, norm scales, ls1 / ls2, ``pos_embed``,
        ``attn_temperature``)."""
        out = []

        def add(path, mod, kind):
            out.append((("params",) + path + ("kernel",), mod.weight, kind))
            out.append((("params",) + path + ("bias",), mod.bias, "vector"))

        def norm(path, mod):
            out.append((("params",) + path + ("scale",), mod.weight,
                        "vector"))
            out.append((("params",) + path + ("bias",), mod.bias, "vector"))

        add(("patch_embed",), self.patch_embed, "conv")
        out.append((("params", "pos_embed"), self.pos_embed, "vector"))
        for i, blk in enumerate(self.blocks):
            b = (f"block_{i}",)
            out.append((("params",) + b + ("ls1",), blk.ls1, "vector"))
            out.append((("params",) + b + ("ls2",), blk.ls2, "vector"))
            norm(b + ("norm1",), blk.norm1)
            add(b + ("attn", "qkv"), blk.attn.qkv, "dense")
            add(b + ("attn", "proj"), blk.attn.proj, "dense")
            out.append((("params",) + b + ("attn", "attn_temperature"),
                        blk.attn.attn_temperature, "vector"))
            norm(b + ("norm2",), blk.norm2)
            for w in ("w1", "w2", "w3"):
                add(b + ("mlp", w), getattr(blk.mlp, w), "dense")
        norm(("norm",), self.norm)
        for i, (up, nrm) in enumerate(zip(self.ups, self.up_norms)):
            add((f"up_{i}",), up, "transpconv")
            norm((f"up_norm_{i}",), nrm)
        add(("seg_head",), self.seg_head, "conv")
        return out


def _trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (flax's truncated normal)."""
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                 generator=generator)


def init_primus_(net: Primus, seed: int) -> Primus:
    """Fresh weights from the flax module's initialisers: lecun-normal
    Dense, Conv and ConvTranspose kernels (a normal truncated at two
    standard deviations, std sqrt(1 / fan_in) / 0.8796..., fan_in = input
    features x kernel volume), zero biases, LayerNorm scales 1,
    ``pos_embed`` truncated normal with std 0.02, ``ls1`` / ``ls2`` =
    ``init_values`` (0.1 in the trainers), ``attn_temperature`` = 10.
    Seeded with a ``torch.Generator`` on the CPU."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for path, prm, kind in net.jax_param_paths():
            name = path[-1]
            if name == "kernel":
                if kind == "dense":
                    fan_in = prm.shape[1]
                else:   # conv (O, I, *k), transposed conv (I, O, *k)
                    cin = prm.shape[0] if kind == "transpconv" \
                        else prm.shape[1]
                    fan_in = cin * math.prod(prm.shape[2:])
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                w = _trunc_normal(prm.shape, gen) * std
            elif name == "pos_embed":
                w = _trunc_normal(prm.shape, gen) * 0.02
            elif name == "scale":
                w = torch.ones(prm.shape)
            elif name in ("ls1", "ls2"):
                w = torch.full(prm.shape, net.init_values)
            elif name == "attn_temperature":
                w = torch.full(prm.shape, 10.0)
            else:
                w = torch.zeros(prm.shape)
            prm.copy_(w.to(prm.dtype))
    return net
