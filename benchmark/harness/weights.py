"""Seeded PlainConvUNet weights, made on the card in one draw.

The tree has the flax layout that the port's weight API takes
(``{"params": {"encoder": ..., "decoder": ...}}``, kernels (*k, I, O)),
every deep-supervision head included. Convolutions are He-normal with a
small bias, norms near identity, the heads halved. The benchmark hands the
same float32 values to the program (as numpy) and to the reference (as
tensors on the card)."""
import math

import torch


def _leaves(arch: dict, in_channels: int, num_classes: int):
    """(path, shape, kind) of every leaf, in a fixed order."""
    f = [int(v) for v in arch["features_per_stage"]]
    ks = [tuple(k) for k in arch["kernel_sizes"]]
    st = [tuple(s) for s in arch["strides"]]
    n = len(f)
    out = []

    def conv(path, k, ci, co, kind="kernel"):
        out.append((path + ("kernel",), k + (ci, co), kind))
        out.append((path + ("bias",), (co,), "bias"))

    def block(path, k, ci, co):
        conv(path + ("conv",), k, ci, co)
        out.append((path + ("norm", "scale"), (co,), "scale"))
        out.append((path + ("norm", "bias"), (co,), "shift"))

    for s in range(n):
        cin = in_channels if s == 0 else f[s - 1]
        for i in range(arch["n_conv_per_stage"][s]):
            block(("encoder", f"stage_{s}", f"block_{i}"), ks[s],
                  cin if i == 0 else f[s], f[s])
    for s in range(1, n):
        d = s - 1
        cin, cout = f[-s], f[-(s + 1)]
        conv(("decoder", f"transpconv_{d}"), st[-s], cin, cout)
        for i in range(arch["n_conv_per_stage_decoder"][d]):
            block(("decoder", f"stage_{d}", f"block_{i}"), ks[-(s + 1)],
                  2 * cout if i == 0 else cout, cout)
        conv(("decoder", f"seg_head_{d}"), (1, 1, 1), cout, num_classes,
             "head")
    return out


def make_tree(arch: dict, in_channels: int, num_classes: int, seed: int,
              device):
    """(tree of float32 tensors on ``device``, the same tree as numpy
    arrays on the host): leaves are views of one seeded draw, copied to
    the host in one transfer."""
    leaves = _leaves(arch, in_channels, num_classes)
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree, o = {}, 0
    for path, shape, kind in leaves:
        n = math.prod(shape)
        v = flat[o:o + n].view(shape)
        o += n
        if kind in ("kernel", "head"):
            fan_in = math.prod(shape[:-1])
            v.mul_(math.sqrt(2.0 / fan_in) * (0.5 if kind == "head" else 1))
        elif kind == "bias":
            v.mul_(0.01)
        elif kind == "scale":
            v.mul_(0.1).add_(1.0)
        else:
            v.mul_(0.1)
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    host = flat.cpu().numpy()
    tree_np, o = {}, 0
    for path, shape, _ in leaves:
        n = math.prod(shape)
        d = tree_np
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = host[o:o + n].reshape(shape)
        o += n
    return {"params": tree}, {"params": tree_np}


def to_device(tree, device):
    """A numpy tree as float32 tensors on ``device``."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
