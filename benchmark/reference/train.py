"""The plain reference of the teacher's training step, in float32: what
the configuration states, from nnU-Net v2's nnUNetTrainer, and nothing of
the program.

- Loss: deep supervision over the decoder's heads (highest resolution
  first), weights 1/2^i with the lowest resolution's zeroed, normalised
  to 1; each level's labels are the patch's, resampled nearest-exact
  (voxel centres) to the level's shape, 1 / the running product of the
  strides, as nnU-Net v2's DownsampleSegForDSTransform does; at each level cross entropy (mean over voxels) plus soft Dice
  (softmax, per sample and class, background left out, smooth 1e-5,
  ``(2 I + s) / max(G + P + s, 1e-8)``, negated and averaged).
- Update: SGD with nesterov momentum 0.99, weight decay 3e-5 added to
  the gradient, the gradients first clipped to a global norm of 12 (g * 12
  / |g| where |g| > 12), learning rate 1e-2 * (1 - step / total)^0.9.

``follow`` runs it from the plain weights on the batches the program's
feed produced (the loader's augmentation is random by design, so the
reference takes its patches and their full-resolution labels, and makes
the deep-supervision levels' labels itself) and returns what the judgement compares: each
step's loss, every leaf's norm of the first step's momentum (the first
gradient as the optimizer holds it: clipped, with the decay added), its
raw gradient's norm, and its change after the steps.
"""
import torch
import torch.nn.functional as F

from .unet import PlainUNet


def ds_weights(n: int):
    w = [1 / 2 ** i for i in range(n)]
    if n > 1:
        w[-1] = 0.0
    s = sum(w)
    return [v / s for v in w]


def dc_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """logits (B, K, *S) float32, target (B, *S) integer labels."""
    ce = F.cross_entropy(logits, target)
    p = torch.softmax(logits, 1)
    onehot = F.one_hot(target, logits.shape[1]).movedim(-1, 1).float()
    dims = tuple(range(2, logits.dim()))
    inter = (p * onehot).sum(dims)
    pred, gt = p.sum(dims), onehot.sum(dims)
    dc = (2 * inter + 1e-5) / torch.clamp(gt + pred + 1e-5, min=1e-8)
    return ce - dc[:, 1:].mean()


def ds_targets(seg: torch.Tensor, strides) -> list:
    """The labels (B, *S) at every deep-supervision level, highest
    resolution first: one level per stride but the last, each at the
    patch's shape over the running product of the strides, rounded,
    resampled nearest-exact."""
    out, f = [], [1] * (seg.dim() - 1)
    for st in strides[:-1]:
        f = [a * b for a, b in zip(f, st)]
        if all(d == 1 for d in f):
            out.append(seg)
            continue
        shape = [round(n / d) for n, d in zip(seg.shape[1:], f)]
        out.append(F.interpolate(seg[:, None].float(), size=shape,
                                 mode="nearest-exact")[:, 0].long())
    return out


def ds_loss(outputs, targets) -> torch.Tensor:
    w = ds_weights(len(outputs))
    return sum(wi * dc_ce(o, t) for wi, o, t in zip(w, outputs, targets)
               if wi != 0)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def _unflat(items):
    out = {}
    for path, v in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def follow(cfg: dict, tree: dict, batches, device, quant: bool = False,
           teacher=None):
    """Run ``len(batches)`` reference steps from ``tree`` (flax layout, on
    ``device``) on the host batches ``[(data, [labels per level])]``, of
    whose labels it takes the full-resolution level alone.
    ``teacher``: for distillation, a callable data -> the teachers' mean
    float32 logits (the loss then mixes in their KL term)."""
    tr = cfg["training"]
    opt = tr["optimizer"]
    total_steps = tr["num_epochs"] * tr["iterations_per_epoch"]
    leaves = [(p, v.detach().clone().float()) for p, v in _flat(tree)]
    params = [v.requires_grad_(True) for _, v in leaves]
    paths = ["/".join(p) for p, _ in leaves]
    p0 = [v.detach().clone() for v in params]
    net = PlainUNet(cfg["network"], _unflat(
        [(p, v) for (p, _), v in zip(leaves, params)]), quant=quant)
    mom = [torch.zeros_like(v) for v in params]
    out = {"losses": [], "first_grad": {}, "raw_grad": {}, "change": {}}
    for step, (data, targets) in enumerate(batches):
        x = data.to(device).float()
        ts = ds_targets(targets[0].to(device).long(),
                        cfg["network"]["strides"])
        outs = net(x, deep_supervision=True)
        loss = ds_loss(outs, ts)
        if teacher is not None:
            T, a = cfg["distillation"]["temperature"], \
                cfg["distillation"]["alpha"]
            with torch.no_grad():
                t_log = teacher(x) / T
            s = outs[0] / T
            kl = (torch.softmax(t_log, 1) * (torch.log_softmax(t_log, 1)
                                             - torch.log_softmax(s, 1))).mean()
            loss = (1 - a) * loss + a * kl * T * T
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if step == 0:
                out["raw_grad"] = {k: float(g.norm())
                                   for k, g in zip(paths, grads)}
            scale = opt["grad_clip"] / norm if norm > opt["grad_clip"] \
                else 1.0
            lr = opt["initial_lr"] * (1 - step / total_steps) ** 0.9
            for p, g, m in zip(params, grads, mom):
                g = g * scale + opt["weight_decay"] * p
                m.mul_(opt["momentum"]).add_(g)
                p -= lr * (g + opt["momentum"] * m)
            if step == 0:
                out["first_grad"] = {k: float(m.norm())
                                     for k, m in zip(paths, mom)}
    with torch.no_grad():
        out["change"] = {k: float((p - q).norm())
                         for k, p, q in zip(paths, params, p0)}
    return out


def ds_mismatch(batches, strides) -> float:
    """The largest share, over the rows' levels, of labels in which the
    program's deep-supervision labels differ from :func:`ds_targets` of
    its full-resolution ones."""
    worst = 0.0
    for _, targets in batches:
        for got, want in zip(targets[1:],
                             ds_targets(targets[0].long(), strides)[1:]):
            if got.shape != want.shape:
                return 1.0
            worst = max(worst, float((got.long() != want).float().mean()))
    return worst


def leaf_gaps(got: dict, ref: dict, leaves=None) -> dict:
    """{leaf: |got - ref| / max(ref, the median leaf's ref)}."""
    keys = [k for k in ref if leaves is None or k in leaves]
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def worst_leaf_gap(got: dict, ref: dict, leaves=None) -> float:
    return max(leaf_gaps(got, ref, leaves).values())


def median_leaf_gap(got: dict, ref: dict, leaves=None) -> float:
    g = sorted(leaf_gaps(got, ref, leaves).values())
    return g[len(g) // 2]


def worst_leaves(got: dict, ref: dict, raw: dict, n: int = 3) -> list:
    """The n leaves of the widest gaps: (leaf, gap, got, ref, the
    reference's raw first gradient)."""
    g = leaf_gaps(got, ref)
    return [(k, g[k], got[k], ref[k], raw[k])
            for k in sorted(g, key=g.get, reverse=True)[:n]]


def moved_leaves(raw_grad: dict, rel: float = 1e-3):
    """The leaves whose first gradient is not nought to rounding: at least
    a thousandth of the median leaf's."""
    vals = sorted(raw_grad.values())
    med = vals[len(vals) // 2]
    return {k for k, v in raw_grad.items() if v >= rel * med}


def judge(prog: dict, ref: dict) -> dict:
    """The widest relative gap of a step's loss; over the leaves the
    reference moves, the median leaf's gap of its first-gradient norm and
    of its change norm (the numbers compared), and the worst leaf's of
    each (kept for the record: bf16 round-off in a few heavily cancelled
    per-channel sums sets them, see PERF.md)."""
    moved = moved_leaves(ref["raw_grad"])
    fg, ch = prog["first_grad"], prog["change"]
    return {
        "loss": max(abs(a - b) / max(abs(b), 1e-30)
                    for a, b in zip(prog["losses"], ref["losses"])),
        "first_grad": median_leaf_gap(fg, ref["first_grad"], moved),
        "change": median_leaf_gap(ch, ref["change"], moved),
        "first_grad_worst": worst_leaf_gap(fg, ref["first_grad"], moved),
        "change_worst": worst_leaf_gap(ch, ref["change"], moved),
    }
