"""The collectives the JAX package gets from its shardings, written out.

Every function takes ``group``: a process group to reduce over, or None for
this process alone (then it is the identity). Results are identical on
every rank of the group (NCCL's and gloo's all-reduce broadcast one sum).

Transport by backend, never by failure: NCCL moves CUDA tensors on the
card; gloo moves host tensors, so under gloo a CUDA tensor is staged
through a host copy (a pinned buffer for the halo exchange) — gloo's
point-to-point takes no CUDA tensor, and staging keeps every gloo
collective on one path.

The differentiable forms (:func:`global_sum`, :func:`global_cat`) carry the
gradient of a loss that every rank computes identically from the global
batch: their backward sums the incoming gradients over the ranks (the
reference's ``AllGatherGrad``), and the training step's gradient average
then divides by the world size, so the update is exactly the gradient of
the global loss.
"""
from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group's ranks in place; returns it."""
    if group_size(group) == 1:
        return t
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.detach().cpu() if _staged(t, group) else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, 0).to(t.device)


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` of the group's rank ``src`` on every rank, in place."""
    if group_size(group) == 1:
        return t
    src = dist.get_global_rank(group, src) \
        if group is not dist.group.WORLD else src
    if _staged(t, group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone(), ctx.group), None


class _GlobalCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank(group)
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.detach().contiguous().clone(), ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group's ranks."""
    return x if group_size(group) == 1 else _GlobalSum.apply(x, group)


def global_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable concatenation of every rank's ``x`` along dim 0, in
    rank order: the global batch's rows, as one process would hold them."""
    return x if group_size(group) == 1 else _GlobalCat.apply(x, group)


def global_mean_(values: torch.Tensor, group) -> torch.Tensor:
    """The mean over ranks of per-rank means (equal local batches), in
    place."""
    n = group_size(group)
    return all_reduce_(values, group).div_(n) if n > 1 else values


# -------------------------------------------------------- gradient average
BUCKET_BYTES = 32 * 1024 * 1024


def average_gradients_(params, group) -> None:
    """Replace every parameter gradient by its mean over the group's ranks:
    one all-reduce per bucket of about :data:`BUCKET_BYTES` of flattened
    float32 gradients, in parameter order. Parameters without a gradient
    (a deep-supervision head of weight 0) have none on any rank and are
    skipped on all of them alike."""
    n = group_size(group)
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    bucket: List[torch.Tensor] = []
    size = 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * 4
        if size >= BUCKET_BYTES or i == len(grads) - 1:
            flat = torch.cat([b.reshape(-1).float() for b in bucket])
            all_reduce_(flat, group).div_(n)
            off = 0
            for b in bucket:
                b.copy_(flat[off:off + b.numel()].view_as(b))
                off += b.numel()
            bucket, size = [], 0


# ------------------------------------------------------------ halo exchange
def shift_right(send: Optional[torch.Tensor], recv: Optional[torch.Tensor],
                group) -> None:
    """One hop along the group's ranks: rank i sends ``send`` to rank i+1
    and receives rank i-1's into ``recv`` (None where there is no such
    neighbour: the first rank receives nothing, the last sends nothing).
    NCCL: ``batch_isend_irecv`` on the card; gloo: host tensors, CUDA ones
    staged through pinned buffers."""
    n = group_size(group)
    if n == 1:
        return
    me = dist.get_rank(group)
    peer = (lambda r: r) if group is dist.group.WORLD \
        else (lambda r: dist.get_global_rank(group, r))
    right = peer(me + 1) if send is not None and me + 1 < n else None
    left = peer(me - 1) if recv is not None and me > 0 else None
    if dist.get_backend(group) == "nccl":
        ops = []
        if right is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), right,
                                  group))
        if left is not None:
            ops.append(dist.P2POp(dist.irecv, recv, left, group))
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        return
    works = []
    if right is not None:
        h = send.detach().contiguous()
        if h.is_cuda:
            h = h.to("cpu", non_blocking=False).pin_memory()
        works.append(dist.isend(h, right, group=group))
    host = None
    if left is not None:
        host = recv if not recv.is_cuda else torch.empty(
            recv.shape, dtype=recv.dtype, pin_memory=True)
        works.append(dist.irecv(host, left, group=group))
    for w in works:
        w.wait()
    if host is not None and host is not recv:
        recv.copy_(host)


def gather_to_first(t: torch.Tensor, group) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (equal shapes) on the group's first rank, in rank
    order (None on the others)."""
    n = group_size(group)
    if n == 1:
        return [t]
    me = dist.get_rank(group)
    dst = 0 if group is dist.group.WORLD else dist.get_global_rank(group, 0)
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)] if me == 0 else None
    dist.gather(src, parts, dst=dst, group=group)
    return parts
