"""Kernels F and G — Primus's attention fused, forward (F) and backward (G),
in ``csrc/attention.cu``.

The JAX package has no Pallas kernel here: its ``EvaAttention`` computes
the scores, the softmax and the AV product as XLA einsums. Eager PyTorch
keeps the float32 scores and probabilities of (B, H, T, T) per layer for the
backward, ~15.4 GB a layer for Primus M at a 160^3 patch (T = 8,000, batch
2), so plain attention cannot train the model at its plan. F and G keep no
T x T tensor in device memory (FlashAttention-2: online softmax forward, the
probabilities recomputed from the rows' log-sum-exp backward).

Contract, per batch row b and head h: ``q``, ``k``, ``v`` (B, T, H, hd)
bfloat16, hd <= 72; q already carries the head's temperature (the caller's
``tau * q_hat``, with q_hat and k unit-norm and rotated). Forward:
``S = q k^T`` (f32 sums), ``P = softmax(S)`` by rows in f32, ``O = P V``
with P rounded to bf16 and the sum in f32, O rounded to bf16, (B, T, H, hd);
``lse`` (B, H, T) f32, the rows' natural log-sum-exp. Backward from lse:
``P = exp(S - lse)``, ``D = rowsum(dO o O)``, ``dV = P^T dO`` (P in bf16),
``dP = dO V^T``, ``dS = P o (dP - D)``, ``dQ = dS K`` and ``dK = dS^T Q``
(dS in bf16); dq, dk, dv bfloat16. The gradients of the temperature, the
qk-norm and the rotation come from autograd on the caller's side.

The kernel is built for a head dim of 72 (Primus M; hd 72 x 2 bytes is
whole 16-byte rows). A smaller head dim (Primus S, B and L: 66) is padded
with zero columns to 72 on the way in and sliced on the way out: zero
columns add nothing to S and give zero columns of O, dQ, dK and dV.

Bound on the card: bf16 FLOPs, 4 B H T^2 hd for F and 10 B H T^2 hd for G
(its five products, each computed once: see the source note in
csrc/attention.cu).

:func:`attention_forward_plain` and :func:`attention_backward_plain` are
the same arithmetic in plain PyTorch, in query blocks (a block's scores and
probabilities, never the whole T x T); the wrappers take them for CPU
tensors only. A CUDA tensor launches the kernels or raises. Launches are
counted on :func:`attention_forward` (F, one a call) and
:func:`attention_backward` (G, two a call: the prep kernel, then the
key-major pass, whose f32 sums of dQ arrive in an order that changes from
run to run), and, where a ``timer`` is given, as the timer's counter
``attn_fused``. :class:`FusedAttention` is the autograd Function; its
backward is the phase ``attention_backward`` of the timer. Autograd runs a
CUDA backward on its own device thread while the step's thread waits in
``backward()``, so that phase is recorded from that thread (its CUDA
events on the same stream as the step's).
"""
from typing import Optional, Tuple

import torch

from ..utils.profiling import phase
from . import _build

HEAD_DIM = 72       # the kernel's head dim (kD in csrc/attention.cu)
BLOCK = 256         # query rows a block of the plain version
BWD_TILE = 64       # G's query rows a tile (kBr in csrc/attention.cu)
BWD_LAUNCHES = 2    # G's kernels a call (fnn_attention_bwd's launches)


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("attention takes q, k, v of one (B, T, H, hd) shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"attention takes bfloat16 q, k, v; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.shape[-1] > HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} above the kernel's "
                         f"{HEAD_DIM}")


# ------------------------------------------------------------------- plain
def attention_forward_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, block: int = BLOCK
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) of the contract, in query blocks of ``block`` rows."""
    _check(q, k, v)
    B, T, H, hd = q.shape
    kt = k.float().permute(0, 2, 3, 1)              # (B, H, hd, T)
    vf = v.float().transpose(1, 2)                  # (B, H, T, hd)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    for t0 in range(0, T, block):
        qb = q[:, t0:t0 + block].float().transpose(1, 2)
        s = torch.matmul(qb, kt)
        l_ = torch.logsumexp(s, -1)
        p = torch.exp(s - l_[..., None]).to(torch.bfloat16).float()
        o[:, t0:t0 + block] = torch.matmul(p, vf).transpose(1, 2).to(o.dtype)
        lse[..., t0:t0 + block] = l_
    return o, lse


def attention_backward_plain(q, k, v, o, lse, do, block: int = BLOCK
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of the contract, in query blocks of ``block`` rows."""
    B, T, H, hd = q.shape
    kf = k.float().transpose(1, 2)                  # (B, H, T, hd)
    vf = v.float().transpose(1, 2)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)   # (B, H, T)
    dq = torch.empty_like(q)
    dk = torch.zeros(B, H, T, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for t0 in range(0, T, block):
        sl = slice(t0, t0 + block)
        qb = q[:, sl].float().transpose(1, 2)
        dob = do[:, sl].float().transpose(1, 2)
        p = torch.exp(torch.matmul(qb, kf.transpose(-1, -2))
                      - lse[..., sl, None])
        dv += torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2),
                           dob)
        dp = torch.matmul(dob, vf.transpose(-1, -2))
        ds = (p * (dp - delta[..., sl, None])).to(torch.bfloat16).float()
        dq[:, sl] = torch.matmul(ds, kf).transpose(1, 2).to(dq.dtype)
        dk += torch.matmul(ds.transpose(-1, -2), qb)
    return (dq, dk.transpose(1, 2).to(q.dtype),
            dv.transpose(1, 2).to(q.dtype))


# ----------------------------------------------------------------- kernels
def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """t as the kernel reads it: (B, T, H, 72), the last dim contiguous,
    every stride a whole number of 16-byte units at a 16-byte base; a
    smaller head dim padded with zeros, a view that is not so copied."""
    if t.shape[-1] < HEAD_DIM:
        return torch.nn.functional.pad(t, (0, HEAD_DIM - t.shape[-1]))
    if t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(t: torch.Tensor):
    return [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      timer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) of the contract: kernel F for CUDA tensors (counted in
    ``attention_forward.launches`` and the timer's ``attn_fused``), the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_forward_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    B, T, H, hd = q.shape
    qv, kv, vv = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    o = torch.empty(B, T, H, HEAD_DIM, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    if B * T * H == 0:
        return o[..., :hd], lse
    err = _build.library().fnn_attention_fwd(
        *_strides(qv), *_strides(kv), *_strides(vv), o.data_ptr(),
        lse.data_ptr(), B, T, H, _build.stream_ptr(q))
    _build.check(err, "attention_forward")
    attention_forward.launches += 1
    if timer is not None:
        timer.count("attn_fused", 1)
    return o[..., :hd], lse


def backward_workspace_size(B: int, T: int, H: int) -> int:
    """float32 values of G's workspace (``fnn_attention_bwd``'s ``ws``):
    per (b, h), lse in log2 units and D for every row of its query tiles,
    the f32 dQ accumulator of those rows, and one int32 counter a tile."""
    nq = -(-T // BWD_TILE)
    return B * H * (nq * BWD_TILE * (2 + HEAD_DIM) + nq)


def attention_backward(q, k, v, o, lse, do
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the contract: kernel G's two launches for CUDA
    tensors (counted in ``attention_backward.launches``), the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    B, T, H, hd = q.shape
    qv, kv, vv = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    ov, dov = (_kernel_view(t).contiguous() for t in (o, do.to(q.dtype)))
    grads = [torch.empty(B, T, H, HEAD_DIM, dtype=q.dtype, device=q.device)
             for _ in range(3)]
    if B * T * H == 0:
        return tuple(g[..., :hd] for g in grads)
    ws = torch.empty(backward_workspace_size(B, T, H), dtype=torch.float32,
                     device=q.device)
    err = _build.library().fnn_attention_bwd(
        *_strides(qv), *_strides(kv), *_strides(vv), ov.data_ptr(),
        dov.data_ptr(), lse.contiguous().data_ptr(),
        *(g.data_ptr() for g in grads), ws.data_ptr(), B, T, H,
        _build.stream_ptr(q))
    _build.check(err, "attention_backward")
    attention_backward.launches += BWD_LAUNCHES
    return tuple(g[..., :hd] for g in grads)


attention_forward.launches = 0
attention_backward.launches = 0


class FusedAttention(torch.autograd.Function):
    """O = attention(q, k, v) under autograd: F forward, G backward (the
    plain versions on CPU tensors); q, k, v, O and lse are kept for the
    backward, never a T x T tensor."""

    @staticmethod
    def forward(ctx, q, k, v, timer=None):
        o, lse = attention_forward(q, k, v, timer)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.timer = timer
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with phase(ctx.timer, "attention_backward"):
            dq, dk, dv = attention_backward(q, k, v, o, lse, do)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    timer: Optional[object] = None) -> torch.Tensor:
    """O (B, T, H, hd) bfloat16 of the contract, differentiable in q, k and
    v."""
    return FusedAttention.apply(q, k, v, timer)
