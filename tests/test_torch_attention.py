"""The fused attention (ops/attention.py: kernels F and G, here their plain
version, which the CPU takes) and the bf16 Primus that runs through it,
against the benchmark's plain float32 reference (benchmark/reference/
primus.py), on the CPU.

Tolerances, all relative to the largest magnitude of the reference's
tensor: the attention's output and the gradients of q, k, v and the
temperature within 3e-2 (q_hat and k_hat enter the product in bf16, so a
score of temperature ~10 moves by up to ~10 x 2^-8; P and dS are rounded
to bf16 where they enter a product; the outputs are bf16: the measured
errors are 8.1e-3 to 2.2e-2, and P rounded to float8 reads 4.2e-2 on the
output, 7.8e-2 on dtau); a bf16 Primus's logits within 5e-3 in the mean
and 6e-2 at most (measured 1.7e-3 / 1.4e-2: every activation is rounded to
bf16; the rotation dropped reads 1.1e-2 / 0.13, the temperature dropped
2.0e-2 / 0.26); one AdamW step from the same weights: the loss within 2e-3
of the reference's, the median leaf's first moment and change within 1e-2
(measured 1.7e-4, 3.3e-4 and 3.3e-5).

Controls, each failing a tolerance: the rotary embedding dropped, the
temperature dropped, the probabilities rounded to float8 e4m3 in place of
bf16 (the attention's tolerance; in the whole network's logits it hides
under the other roundings). And no call of
``scaled_dot_product_attention``: the port never calls it."""
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import primus as ref
from benchmark.reference import train as ref_train
from fast_nnunet_tpu_torch.models import primus as pprimus
from fast_nnunet_tpu_torch.ops import _build
from fast_nnunet_tpu_torch.ops import attention as fa
from fast_nnunet_tpu_torch.training.optimizers import nnunet_adamw
from fast_nnunet_tpu_torch.training.schedules import linear_warmup_poly
from fast_nnunet_tpu_torch.training.train_step import make_train_step
from fast_nnunet_tpu_torch.utils.profiling import PhaseTimer

ATTN_TOL = 3e-2
LOGIT_MEAN_TOL, LOGIT_MAX_TOL = 5e-3, 6e-2
STEP_TOL = {"loss": 2e-3, "first_grad": 1e-2, "change": 1e-2}


def _raw(B, T, H, hd, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, hd, generator=g) for _ in range(3))
    tau = 10.0 + torch.randn(H, generator=g)
    return q, k, v, tau


def _grid(T):
    """A 3D grid of T tokens for the rotary angles (T = a x b x c)."""
    for a in range(round(T ** (1 / 3)) + 1, 0, -1):
        if T % a == 0:
            r = T // a
            b = next(d for d in range(int(math.isqrt(r)), 0, -1) if r % d == 0)
            return (a, b, r // b)


def _program(q, k, v, tau, rope=True, use_tau=True):
    """The port's bf16 path: q_hat, k_hat normed and rotated as
    models/primus.py does, tau * q_hat and k_hat rounded to bf16, then the
    fused attention's plain version."""
    T, hd = q.shape[1], q.shape[-1]
    ang = torch.tensor(pprimus.make_3d_rope(_grid(T), hd), dtype=torch.float32)
    cos, sin = torch.cos(ang), torch.sin(ang)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    qh = qb / (pprimus._l2_norm(qb) + 1e-6)
    kh = kb / (pprimus._l2_norm(kb) + 1e-6)
    if rope:
        qh, kh = pprimus.apply_rope(qh, cos, sin), pprimus.apply_rope(kh, cos,
                                                                      sin)
    qh, kh = qh.float(), kh.float()
    if use_tau:
        qh = qh * tau.view(1, 1, -1, 1)
    return fa.fused_attention(qh.bfloat16(), kh.bfloat16(), vb)


def _reference(q, k, v, tau):
    """The reference's float32 attention (its norm, rotation and query
    blocks), (B, T, H, hd)."""
    T, hd = q.shape[1], q.shape[-1]
    ang = ref.rope_angles(_grid(T), hd)
    cos, sin = torch.cos(ang), torch.sin(ang)
    qh = ref.rotate(q / (q.norm(dim=-1, keepdim=True) + 1e-6), cos, sin)
    kh = ref.rotate(k / (k.norm(dim=-1, keepdim=True) + 1e-6), cos, sin)
    qh = qh * tau.view(1, 1, -1, 1)
    qh, kh, v = (t.transpose(1, 2) for t in (qh, kh, v))
    rows = [ref.attention_rows(qh[:, :, t:t + 16], kh, v)
            for t in range(0, T, 16)]
    return torch.cat(rows, 2).transpose(1, 2)


def _errors(fault=None, shape=(2, 60, 3, 72), seed=0):
    """{name: error relative to the reference's largest} of the output and
    the gradients of q, k, v and tau."""
    q, k, v, tau = _raw(*shape, seed)
    g = torch.Generator().manual_seed(seed + 100)
    dout = torch.randn(shape, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, tau)]
    o = _program(*leaves, rope=fault != "no_rope", use_tau=fault != "no_tau")
    o.float().backward(dout)
    got = [o.detach().float()] + [torch.zeros_like(t) if t.grad is None
                                  else t.grad for t in leaves]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, tau)]
    o = _reference(*leaves)
    o.backward(dout)
    want = [o.detach()] + [t.grad for t in leaves]
    return {n: float((a - b).abs().max() / b.abs().max())
            for n, a, b in zip(("o", "dq", "dk", "dv", "dtau"), got, want)}


def _fp8_forward_plain(q, k, v, block=fa.BLOCK):
    """The plain forward with P rounded to float8 e4m3 (a control)."""
    B, T, H, hd = q.shape
    kt = k.float().permute(0, 2, 3, 1)
    vf = v.float().transpose(1, 2)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T)
    for t0 in range(0, T, block):
        s = torch.matmul(q[:, t0:t0 + block].float().transpose(1, 2), kt)
        l_ = torch.logsumexp(s, -1)
        p = ref.fp8(torch.exp(s - l_[..., None]))
        o[:, t0:t0 + block] = torch.matmul(p, vf).transpose(1, 2).to(o.dtype)
        lse[..., t0:t0 + block] = l_
    return o, lse


@pytest.mark.parametrize("shape", [(2, 60, 3, 72), (1, 45, 2, 72),
                                   (2, 27, 3, 66)])
def test_plain_fused_attention_matches_the_reference(shape):
    """Output, dq, dk, dv and dtau within ATTN_TOL, head dim 72 (Primus M's)
    and 66 (S, B, L's), ragged token counts (45, 27)."""
    err = _errors(shape=shape)
    assert max(err.values()) <= ATTN_TOL, err


@pytest.mark.parametrize("T", [127, 128, 129, 257])
def test_plain_backward_at_the_tile_edges(T):
    """Output, dq, dk, dv and dtau within ATTN_TOL at token counts on either
    side of kernel G's tiles (64 query rows, 128 key rows a block) and of
    the plain version's 256-row blocks."""
    err = _errors(shape=(1, T, 2, 72))
    assert max(err.values()) <= ATTN_TOL, err


def test_backward_launches_are_the_benchmarks():
    """The wrapper counts G's launches a call as the benchmark's
    roofline.G.primus expects them (harness/primus_train.G_LAUNCHES; it
    reads nothing where the trace holds another number), and
    fnn_attention_bwd launches that many kernels."""
    import re
    from benchmark.harness import primus_train
    assert fa.BWD_LAUNCHES == primus_train.G_LAUNCHES == 2
    src = open(os.path.join(_build.CSRC, "attention.cu")).read()
    body = src[src.index('extern "C" int fnn_attention_bwd('):]
    assert len(re.findall(r"<<<", body)) == fa.BWD_LAUNCHES


def test_two_kernels_carry_the_backward_symbol():
    """Exactly G's two kernels are named with benchmark/kernels/G.py's
    symbol, in every CUDA source, and F's kernel is not (the trace counts
    launches by that substring)."""
    import glob
    import re
    from benchmark.kernels import F as kernel_f
    from benchmark.kernels import G as kernel_g
    names = []
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                            r"[^)]*\)\s+)?(\w+)\s*\(", open(path).read())
    assert sorted(n for n in names if kernel_g.SYMBOL in n) == [
        "attention_bwd_kernel", "attention_bwd_prep_kernel"]
    assert [n for n in names if kernel_f.SYMBOL in n] == [
        "attention_fwd_kernel"]


@pytest.mark.parametrize("fault", ["no_rope", "no_tau", "p_fp8"])
def test_attention_controls_fail_the_tolerance(fault, monkeypatch):
    if fault == "p_fp8":
        monkeypatch.setattr(fa, "attention_forward_plain", _fp8_forward_plain)
    err = _errors(fault=fault)
    assert max(err.values()) > ATTN_TOL, err


def test_plain_blocks_do_not_change_the_result():
    q, k, v, _ = _raw(1, 70, 2, 72, 3)
    q, k, v = (t.bfloat16() for t in (q, k, v))
    a = fa.attention_forward_plain(q, k, v, block=16)
    b = fa.attention_forward_plain(q, k, v, block=70)
    assert torch.allclose(a[1], b[1], atol=1e-5)
    assert (a[0].float() - b[0].float()).abs().max() <= 1e-2


# ------------------------------------------------------------------ model
ARCH = dict(embed_dim=144, depth=2, num_heads=2, patch_embed_size=[8, 8, 8],
            patch_size=[32, 16, 16], mlp_hidden=384, head_dim=72,
            input_channels=1, num_classes=4)


def _primus(seed=5, dtype=torch.bfloat16):
    net = pprimus.Primus(1, 144, (8, 8, 8), 4, 2, 2, (32, 16, 16),
                         init_values=1.0, compute_dtype=dtype,
                         trainable=True)
    pprimus.init_primus_(net, seed)
    with torch.no_grad():        # LayerScale, temperatures, norms off their
        g = torch.Generator().manual_seed(seed + 1)   # constant inits
        for name, p in net.named_parameters():
            if p.dim() <= 1 or "temperature" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net


def _batch(seed=6):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 4, (2, 32, 16, 16))
    x = (rng.randn(2, 1, 32, 16, 16) + lab[:, None]).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(lab)


def _logit_errors():
    net = _primus()
    x, _ = _batch()
    params = {k: p.detach().float() for k, p in net.named_parameters()}
    with torch.no_grad():
        got = net(x)
        want = ref.PlainPrimus(ARCH, params)(x)
    scale = float(want.abs().max())
    d = (got - want).abs()
    return float(d.mean()) / scale, float(d.max()) / scale


def test_bf16_primus_logits_match_the_reference():
    mean, worst = _logit_errors()
    assert mean <= LOGIT_MEAN_TOL and worst <= LOGIT_MAX_TOL, (mean, worst)


@pytest.mark.parametrize("fault", ["no_rope", "no_tau"])
def test_bf16_primus_controls_fail(fault, monkeypatch):
    """(P in float8 moves these logits by less than bf16 does elsewhere in
    the network, 2.0e-3 / 1.75e-2: the attention's own test catches it.)"""
    if fault == "no_rope":
        monkeypatch.setattr(pprimus, "apply_rope",
                            lambda x, c, s: x.float())
    else:
        real = pprimus.fused_attention
        monkeypatch.setattr(
            pprimus, "fused_attention", lambda q, k, v, timer=None: real(
                F.normalize(q.float(), dim=-1).to(q.dtype), k, v, timer))
    mean, worst = _logit_errors()
    assert mean > LOGIT_MEAN_TOL or worst > LOGIT_MAX_TOL, (mean, worst)


def test_bf16_primus_adamw_step_matches_the_reference():
    """One step of the Primus trainers' update (clip 1, AdamW b2 0.98, wd
    5e-2, the schedule past its warmup) from the same weights: loss, the
    median leaf's first moment and change (the benchmark's judgement)."""
    net = _primus(seed=7)
    x, lab = _batch(seed=8)
    p0 = {k: p.detach().float().clone() for k, p in net.named_parameters()}
    opt_cfg = {"initial_lr": 3e-4, "warmup_steps": 10, "total_steps": 1000,
               "start_count": 10, "b1": 0.9, "b2": 0.98, "eps": 1e-8,
               "weight_decay": 5e-2, "grad_clip": 1.0}
    opt = nnunet_adamw(net.parameters(), linear_warmup_poly(3e-4, 1000, 10),
                       weight_decay=5e-2, b1=0.9, b2=0.98, grad_clip=1.0)
    opt.count = 10
    loss = make_train_step(net, opt, skip_nonfinite=True)(x, (lab,))
    st = opt.inner.state
    prog = {"losses": [float(loss)],
            "first_grad": {k: float(st[p]["exp_avg"].norm())
                           for k, p in net.named_parameters()},
            "change": {k: float((p.detach() - p0[k]).norm())
                       for k, p in net.named_parameters()}}
    cfg = {"network": ARCH, "training": {"patch_size": ARCH["patch_size"],
                                         "optimizer": opt_cfg}}
    r = ref.follow(cfg, p0, [(x, [lab])], torch.device("cpu"))
    got = ref_train.judge(prog, r)
    assert all(got[k] <= v for k, v in STEP_TOL.items()), got


def test_primus_never_calls_sdpa_and_traces_its_attention(monkeypatch):
    """bf16 forward and backward: no ``scaled_dot_product_attention`` call;
    the timer counts the model's attention calls and brackets the forward
    and backward attention (on the CPU no kernel F launches, so
    ``attn_fused`` stays 0)."""
    calls = []
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        lambda *a, **k: calls.append(1))
    monkeypatch.setattr(torch._C._nn, "scaled_dot_product_attention",
                        lambda *a, **k: calls.append(1), raising=False)
    net = _primus()
    net.timer = timer = PhaseTimer()
    x, lab = _batch()
    net(x).float().mean().backward()
    tot = timer.totals()
    assert calls == []
    assert tot["count:attn_calls"] == 2 and "count:attn_fused" not in tot
    assert "host:attention" in tot and "host:attention_backward" in tot


def test_float32_primus_keeps_the_plain_attention(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("float32 Primus reached the fused attention")
    monkeypatch.setattr(pprimus, "fused_attention", refuse)
    net = _primus(dtype=torch.float32)
    x, _ = _batch()
    with torch.no_grad():
        assert net(x).dtype == torch.float32
