"""Plain PlainConvUNet (nnU-Net v2's dynamic_network_architectures), in
float32 from a flax-layout weight tree, written from the published
architecture and nothing of the program:

- encoder stage s: ``n_conv_per_stage[s]`` blocks of conv (stride on the
  first block of a stage, "same" padding) -> InstanceNorm (affine, eps
  1e-5, biased variance) -> LeakyReLU(0.01);
- decoder stage d (deepest first): transposed conv (kernel = stride), the
  skip concatenated after it, ``n_conv_per_stage_decoder[d]`` blocks, a
  1^3 seg head; deep supervision returns every head, highest resolution
  first.

Weights are flax trees: conv kernels (*k, I, O); a transposed conv's kernel
is applied mirrored (out[2p + o] takes tap k[1 - o]), as flax does.

``quant`` puts the control in the reference's place: every convolution's
input and weight are rounded to float8 e4m3 with a per-tensor scale (the
nearest precision below the configuration's bfloat16), the arithmetic
itself in float32; in training the rounding passes gradients straight
through.
"""
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448);
    gradients pass straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x.detach())


def conv_weight(k: torch.Tensor) -> torch.Tensor:
    """flax (*k, I, O) -> torch conv (O, I, *k)."""
    return k.permute(4, 3, 0, 1, 2)


def transp_weight(k: torch.Tensor) -> torch.Tensor:
    """flax transposed-conv (*k, I, O), applied mirrored -> torch
    ConvTranspose3d (I, O, *k)."""
    return k.flip(0, 1, 2).permute(3, 4, 0, 1, 2)


class PlainUNet:
    def __init__(self, arch: dict, tree: dict, quant: bool = False):
        self.arch = arch
        self.p = tree["params"] if "params" in tree else tree
        self.quant = quant
        self.eps = 1e-5
        self.slope = 0.01

    def _conv(self, x, k, b, stride=1, transposed=False):
        w = transp_weight(k) if transposed else conv_weight(k)
        if self.quant:
            x, w = fp8(x), fp8(w)
        if transposed:
            return F.conv_transpose3d(x, w, b, stride=stride)
        pad = tuple(s // 2 for s in w.shape[2:])
        return F.conv3d(x, w, b, stride=stride, padding=pad)

    def _block(self, x, t, stride=1):
        x = self._conv(x, t["conv"]["kernel"], t["conv"]["bias"], stride)
        mean = x.mean(dim=(2, 3, 4), keepdim=True)
        var = x.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        x = x * t["norm"]["scale"].view(1, -1, 1, 1, 1) \
            + t["norm"]["bias"].view(1, -1, 1, 1, 1)
        return F.leaky_relu(x, self.slope)

    def forward(self, x: torch.Tensor, deep_supervision: bool = False):
        a, enc, dec = self.arch, self.p["encoder"], self.p["decoder"]
        n = len(a["features_per_stage"])
        x = x.float()
        skips = []
        for s in range(n):
            stage = enc[f"stage_{s}"]
            for i in range(a["n_conv_per_stage"][s]):
                stride = tuple(a["strides"][s]) if i == 0 else 1
                x = self._block(x, stage[f"block_{i}"], stride)
            skips.append(x)
        outs = []
        for d in range(n - 1):
            s = d + 1
            t = dec[f"transpconv_{d}"]
            x = self._conv(x, t["kernel"], t["bias"], tuple(a["strides"][-s]),
                           transposed=True)
            x = torch.cat([x, skips[-(s + 1)]], 1)
            stage = dec[f"stage_{d}"]
            for i in range(a["n_conv_per_stage_decoder"][d]):
                x = self._block(x, stage[f"block_{i}"])
            if deep_supervision or d == n - 2:
                h = dec[f"seg_head_{d}"]
                outs.append(self._conv(x, h["kernel"], h["bias"]))
        return tuple(outs[::-1]) if deep_supervision else outs[-1]

    __call__ = forward
