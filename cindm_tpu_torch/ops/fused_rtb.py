"""Fused ResidualTemporalBlock (forward).

Port of ``cindm_tpu/ops/fused_rtb.py``: the whole block

    h   = Mish(GN(conv5(x) + b1))
    h  += temb[:, None, :]          # temb = Dense(mish(t_emb)), projected outside
    h   = Mish(GN(conv5(h) + b2))
    out = h + (x @ wres + bres | x)

in one call of ``csrc/fused_rtb.cu`` for CUDA tensors: two launches of the
3xTF32 tensor-core stage of ``csrc/conv_gn_mish.cuh`` (tiled by
``_build.plan_stage``), the first writing h [B, T, O] to device memory once
and the second reading it, with the 1x1 residual projection inside the
second. ``fused_rtb.launches`` counts calls. CPU tensors use
``fused_rtb_reference``.

``fused_rtb`` itself has no autograd history: it raises when a gradient is
wanted. ``fused_rtb_differentiable`` is the port of the JAX package's custom
VJP (``_fused_rtb_cv``, ``cindm_tpu/ops/fused_rtb.py:247-276``): its forward
is the kernel and its backward recomputes ``fused_rtb_reference`` on the
saved inputs and differentiates that, as ``_fused_rtb_cv_bwd`` does. The
backward therefore costs a plain forward plus a plain backward; a backward
kernel that reuses the forward's GroupNorm statistics would save the
recompute.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_conv_gn import fused_conv1d_gn_mish_reference, recompute_grads, refuse_grad


def fused_rtb_reference(
    x: torch.Tensor,  # [B, T, C]
    temb: torch.Tensor,  # [B, O], already Dense(mish(t_emb))
    w1: torch.Tensor,  # [K, C, O]
    b1: torch.Tensor,
    gs1: torch.Tensor,
    gb1: torch.Tensor,
    w2: torch.Tensor,  # [K, O, O]
    b2: torch.Tensor,
    gs2: torch.Tensor,
    gb2: torch.Tensor,
    wres: torch.Tensor | None = None,  # [C, O] 1x1 residual (None => identity)
    bres: torch.Tensor | None = None,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version: two Conv1d+GN+Mish with the temb add and the residual."""
    h = fused_conv1d_gn_mish_reference(x, w1, b1, gs1, gb1, groups, eps)
    h = h + temb[:, None, :]
    h = fused_conv1d_gn_mish_reference(h, w2, b2, gs2, gb2, groups, eps)
    res = x if wres is None else torch.matmul(x, wres) + bres
    return h + res


def fused_rtb(
    x: torch.Tensor,
    temb: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    gs1: torch.Tensor,
    gb1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gs2: torch.Tensor,
    gb2: torch.Tensor,
    wres: torch.Tensor | None = None,
    bres: torch.Tensor | None = None,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """ResidualTemporalBlock: the CUDA kernel on CUDA tensors, plain on CPU."""
    B, T, C = x.shape
    K, _, O = w1.shape
    if O % groups:
        raise ValueError(f"fused_rtb: O={O} not divisible by groups={groups}")
    if (wres is None) != (bres is None):
        raise ValueError("fused_rtb: pass both wres and bres, or neither")
    if wres is None and C != O:
        raise ValueError(f"fused_rtb: identity residual needs C == O, got {C} -> {O}")
    vec = (O,)
    shapes = dict(
        x=(x, (B, T, C)), temb=(temb, (B, O)), w1=(w1, (K, C, O)), b1=(b1, vec),
        gs1=(gs1, vec), gb1=(gb1, vec), w2=(w2, (K, O, O)), b2=(b2, vec),
        gs2=(gs2, vec), gb2=(gb2, vec),
    )
    if wres is not None:
        shapes.update(wres=(wres, (C, O)), bres=(bres, vec))
    _build.check_inputs("fused_rtb", x.device, **shapes)
    refuse_grad("fused_rtb", "fused_rtb_differentiable", x, temb, w1, b1, gs1, gb1, w2, b2,
                gs2, gb2, wres, bres)
    if x.device.type == "cpu":
        return fused_rtb_reference(
            x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, groups, eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_rtb: unsupported device {x.device}")
    _build.check_channels("fused_rtb", C=C, O=O)
    _build.check_aligned("fused_rtb", x=x, temb=temb, w1=w1, w2=w2, wres=wres, gs1=gs1,
                         gb1=gb1, gs2=gs2, gb2=gb2)
    sms = _build.num_sms(x.device)
    plan1 = _build.plan_stage(B, T, C, O, groups, K, num_sms=sms)
    plan2 = _build.plan_stage(B, T, O, O, groups, K, proj=wres is not None, num_sms=sms)
    lib = _build.load()
    h = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    out = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    nbytes = plan1.weight_bytes(C) + plan1.weight_bytes(O) + (
        plan1.weight_bytes(C, K=1) if wres is not None else 0)
    scratch = _build.scratch(nbytes, x.device)
    with torch.cuda.device(x.device):
        err = lib.cindm_fused_rtb(
            *map(_build.ptr, (x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, h, out,
                              scratch)),
            scratch.numel() * 4, B, T, C, O, K, groups, eps, plan1.samples, plan1.n_tile,
            plan1.smem_bytes, plan2.smem_bytes, _build.stream_of(x),
        )
    _build.raise_on_error("fused_rtb", err)
    fused_rtb.launches += 1
    return out


fused_rtb.launches = 0  # kernel calls (two stage launches each); the CPU path does not count


class FusedRTB(torch.autograd.Function):
    """``fused_rtb`` with a gradient: the kernel forward, a recompute backward.

    ``backward`` runs ``fused_rtb_reference`` under autograd on the saved
    inputs and returns the cotangents of all twelve tensor arguments (``None``
    for an absent residual); it launches no kernel of its own. On CUDA
    tensors ``FusedRTB.launches`` counts the forward's kernel launches and
    ``FusedRTB.backwards`` the backward passes; the CPU path counts neither.
    """

    launches = 0
    backwards = 0

    @staticmethod
    def forward(ctx, x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, groups, eps):
        ctx.save_for_backward(x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres)
        ctx.groups, ctx.eps = groups, eps
        out = fused_rtb(x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, groups, eps)
        if x.device.type == "cuda":
            FusedRTB.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        grads = recompute_grads(
            lambda *a: fused_rtb_reference(*a, ctx.groups, ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:12], g,
        )
        if g.device.type == "cuda":
            FusedRTB.backwards += 1
        return (*grads, None, None)


def fused_rtb_differentiable(
    x: torch.Tensor,
    temb: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    gs1: torch.Tensor,
    gb1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gs2: torch.Tensor,
    gb2: torch.Tensor,
    wres: torch.Tensor | None = None,
    bres: torch.Tensor | None = None,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``fused_rtb`` that autograd can differentiate (through ``FusedRTB``).

    Without a gradient to compute (under ``torch.no_grad()``, or no input
    requires one) it is exactly ``fused_rtb``: one launch, nothing saved.
    """
    args = (x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        return FusedRTB.apply(*args, groups, eps)
    return fused_rtb(*args, groups, eps)
