"""The plain reference of Primus training, in float32, written from the
published description (Wald et al., "Primus: Enforcing Attention Usage for
3D Medical Image Segmentation", arXiv:2503.01835; MIC-DKFZ/nnUNet's
``nnUNet_Primus_M_Trainer``) and nothing of the program:

- an 8^3 strided convolution makes one token of each 8^3 block (x slowest,
  z fastest, channels last), a learned position embedding is added;
- ``depth`` pre-LN blocks: ``x + ls1 * Attn(LN(x))``, ``x + ls2 *
  SwiGLU(LN(x))`` (LayerScale); Attn: a qkv projection, each head's q and
  k divided by their norm plus 1e-6, rotated by the 3D axial rotary
  embedding, the scores ``tau_h * q k^T`` (a learned temperature per head)
  softmaxed by rows, the heads' outputs projected; SwiGLU: ``w3(silu(w1
  x) * w2 x)``;
- a final LayerNorm, then per x2 step a transposed convolution (kernel =
  stride 2), a LayerNorm over channels and GELU, and a 1^3 seg head;
- loss: Dice + cross entropy at full resolution (no deep supervision);
  update: the gradients clipped to a global norm of 1, AdamW (b1 0.9, b2
  0.98, eps 1e-8, decoupled weight decay 5e-2, bias-corrected moments),
  the learning rate linear warmup then poly 0.9 from 3e-4, evaluated at
  the schedule's count.

Departures from the description, each noted: LayerNorm epsilon 1e-6 and
GELU's tanh form (the repository's Primus, as its JAX module has them);
the rotary angles as the repository's JAX module defines them (base 100,
``hd // 6 * 2`` rotary dims per axis, the two halves of a head
concatenated, not interleaved; timm's EVA rotary embedding differs in its
frequencies); drop path off (the trainers never draw it).

Attention runs in query blocks of ``QUERY_BLOCK`` rows, each block's
scores recomputed in the backward (``torch.utils.checkpoint``), and each
block and decoder stage checkpointed too, so the reference fits on the card
at a 160^3 patch once the program is freed. Parameters are a dict of
float32 tensors under the names of the PyTorch module's state dict
(``blocks.0.attn.qkv.weight`` and so on; Linear weights (out, in), the
transposed convolutions (in, out, 2, 2, 2) applied as torch applies them).

``quant`` puts the control in the reference's place: every product's
operands (the linears' inputs and weights, the convolutions', the scaled
q, k, v and the probabilities) rounded to float8 e4m3 under a per-tensor
scale, the arithmetic itself in float32, gradients passed straight
through.
"""
import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .train import dc_ce
from .unet import fp8

QUERY_BLOCK = 1000
LN_EPS = 1e-6


def rope_angles(grid, head_dim: int) -> torch.Tensor:
    """(tokens, head_dim / 2) angles: per axis ``head_dim // 6 * 2`` rotary
    dims, frequencies 100^(-i / half), each rotated by its axis coordinate,
    zero-padded to head_dim / 2."""
    part = head_dim // 6 * 2
    out = []
    for ax, g in enumerate(grid):
        half = part // 2
        inv = 1.0 / (100.0 ** (np.arange(half) / max(half, 1)))
        a = np.outer(np.arange(g), inv)
        shape = [1, 1, 1, half]
        shape[ax] = g
        out.append(np.broadcast_to(a.reshape(shape), (*grid, half))
                   .reshape(-1, half))
    full = np.concatenate(out, -1)
    pad = head_dim // 2 - full.shape[-1]
    if pad > 0:
        full = np.concatenate([full, np.zeros((full.shape[0], pad))], -1)
    return torch.tensor(full, dtype=torch.float32)


def layer_norm(x, w, b, dim=-1):
    mean = x.mean(dim, keepdim=True)
    var = x.var(dim, keepdim=True, unbiased=False)
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x - mean) * torch.rsqrt(var + LN_EPS) * w.view(shape) \
        + b.view(shape)


def rotate(x, cos, sin):
    """x (B, T, H, hd): halves rotated by the angles (T, hd / 2)."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1)


def attention_rows(q, k, v, quant: bool = False):
    """softmax(q k^T) v for a block of query rows, q (B, H, t, hd) already
    scaled by the temperature, k and v (B, H, T, hd); with ``quant`` the
    probabilities and v rounded to float8 before their product."""
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), -1)
    if quant:
        p, v = fp8(p), fp8(v)
    return torch.matmul(p, v)


class PlainPrimus:
    def __init__(self, arch: dict, params: dict, quant: bool = False):
        self.a = arch
        self.p = params
        self.quant = quant
        pe = arch["patch_embed_size"]
        self.grid = tuple(s // e for s, e in zip(arch["patch_size"], pe))
        hd = arch["embed_dim"] // arch["num_heads"]
        ang = rope_angles(self.grid, hd)
        dev = next(iter(params.values())).device
        self.cos, self.sin = torch.cos(ang).to(dev), torch.sin(ang).to(dev)

    def _q(self, *xs):
        return [fp8(x) for x in xs] if self.quant else list(xs)

    def _lin(self, x, name):
        x, w = self._q(x, self.p[name + ".weight"])
        return F.linear(x, w, self.p[name + ".bias"])

    def _attn_rows(self, q, k, v):
        return attention_rows(q, k, v, self.quant)

    def _attention(self, x, i):
        B, T, C = x.shape
        H = self.a["num_heads"]
        pre = f"blocks.{i}.attn."
        q, k, v = self._lin(x, pre + "qkv").view(B, T, 3, H, C // H) \
            .unbind(2)
        q = rotate(q / (q.norm(dim=-1, keepdim=True) + 1e-6), self.cos,
                   self.sin)
        k = rotate(k / (k.norm(dim=-1, keepdim=True) + 1e-6), self.cos,
                   self.sin)
        q = q * self.p[pre + "attn_temperature"].view(1, 1, H, 1)
        q, k = self._q(q, k)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out = torch.cat([
            checkpoint(self._attn_rows, q[:, :, t0:t0 + QUERY_BLOCK], k, v,
                       use_reentrant=False)
            for t0 in range(0, T, QUERY_BLOCK)], 2)
        return self._lin(out.transpose(1, 2).reshape(B, T, C), pre + "proj")

    def _block(self, x, i):
        p, pre = self.p, f"blocks.{i}."
        h = layer_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"])
        x = x + self._attention(h, i) * p[pre + "ls1"]
        h = layer_norm(x, p[pre + "norm2.weight"], p[pre + "norm2.bias"])
        h = self._lin(F.silu(self._lin(h, pre + "mlp.w1"))
                      * self._lin(h, pre + "mlp.w2"), pre + "mlp.w3")
        return x + h * p[pre + "ls2"]

    def _up(self, h, i):
        p = self.p
        x, w = self._q(h, p[f"ups.{i}.weight"])
        h = F.conv_transpose3d(x, w, p[f"ups.{i}.bias"], stride=2)
        h = layer_norm(h, p[f"up_norms.{i}.weight"], p[f"up_norms.{i}.bias"],
                       dim=1)
        return F.gelu(h, approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C_in, *patch) -> float32 logits (B, K, *patch)."""
        p, E = self.p, self.a["embed_dim"]
        xq, w = self._q(x.float(), p["patch_embed.weight"])
        h = F.conv3d(xq, w, p["patch_embed.bias"],
                     stride=tuple(self.a["patch_embed_size"]))
        B = h.shape[0]
        t = h.flatten(2).transpose(1, 2) + p["pos_embed"]
        for i in range(self.a["depth"]):
            t = checkpoint(self._block, t, i, use_reentrant=False)
        t = layer_norm(t, p["norm.weight"], p["norm.bias"])
        h = t.transpose(1, 2).reshape(B, E, *self.grid)
        i = 0
        while f"ups.{i}.weight" in p:
            h = checkpoint(self._up, h, i, use_reentrant=False)
            i += 1
        xq, w = self._q(h, p["seg_head.weight"])
        return F.conv3d(xq, w, p["seg_head.bias"])

    __call__ = forward


def learning_rate(opt: dict, count: int) -> float:
    """Linear warmup over ``warmup_steps`` to ``initial_lr``, then poly
    0.9 to 0 at ``total_steps``, at the schedule's count."""
    lr0, w, n = opt["initial_lr"], opt["warmup_steps"], opt["total_steps"]
    if count < w:
        return lr0 * (count + 1) / max(w, 1)
    frac = min(max((count - w) / max(n - w, 1), 0.0), 1.0)
    return lr0 * (1.0 - frac) ** 0.9


def follow(cfg: dict, params: dict, batches, device, quant: bool = False):
    """Run ``len(batches)`` reference steps from ``params`` ({name: float32
    tensor} on ``device``) on the host batches ``[(data, [labels])]``,
    the schedule's count starting at ``cfg["training"]["optimizer"]
    ["start_count"]``. Returns each step's loss, every leaf's norm of the
    first moment after the first step (the clipped gradient as AdamW holds
    it), its raw first gradient's norm, and its change after the steps."""
    opt = cfg["training"]["optimizer"]
    arch = dict(cfg["network"], patch_size=cfg["training"]["patch_size"])
    names = list(params)
    leaves = [params[k].detach().clone().float().requires_grad_(True)
              for k in names]
    p0 = [v.detach().clone() for v in leaves]
    net = PlainPrimus(arch, dict(zip(names, leaves)), quant=quant)
    m = [torch.zeros_like(v) for v in leaves]
    s = [torch.zeros_like(v) for v in leaves]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    out = {"losses": [], "first_grad": {}, "raw_grad": {}, "change": {}}
    for step, (data, targets) in enumerate(batches):
        x = data.to(device).float()
        loss = dc_ce(net(x), targets[0].to(device).long())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if step == 0:
                out["raw_grad"] = {k: float(g.norm())
                                   for k, g in zip(names, grads)}
            scale = opt["grad_clip"] / norm if norm > opt["grad_clip"] \
                else 1.0
            lr = learning_rate(opt, opt["start_count"] + step)
            t = step + 1
            for p, g, mi, si in zip(leaves, grads, m, s):
                g = g * scale
                mi.mul_(b1).add_((1 - b1) * g)
                si.mul_(b2).add_((1 - b2) * g * g)
                upd = (mi / (1 - b1 ** t)) / (
                    torch.sqrt(si / (1 - b2 ** t)) + eps) + wd * p
                p -= lr * upd
            if step == 0:
                out["first_grad"] = {k: float(mi.norm())
                                     for k, mi in zip(names, m)}
        del grads, loss
    with torch.no_grad():
        out["change"] = {k: float((p - q).norm())
                         for k, p, q in zip(names, leaves, p0)}
    return out

