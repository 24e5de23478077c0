"""Fused Conv1d + GroupNorm + Mish (the Conv1dBlock body).

Port of ``cindm_tpu/ops/fused_conv_gn.py``. ``fused_conv1d_gn_mish`` launches
the hand-written CUDA kernel in ``csrc/fused_conv_gn.cu`` (one launch of the
3xTF32 tensor-core stage of ``csrc/conv_gn_mish.cuh``, tiled by
``_build.plan_stage``) for CUDA tensors and uses
``fused_conv1d_gn_mish_reference`` for CPU tensors. Layout is channel-last:
x [B, T, C], w [K, C, O] (the JAX package's layout, which the kernel reads
directly), out [B, T, O]. On CUDA, C and O must be multiples of 4 and K = 5.

The kernel's output has no autograd history, so ``fused_conv1d_gn_mish``
raises when a gradient is wanted; ``fused_conv1d_gn_mish_differentiable``
(through ``FusedConv1dGNMish``) launches the same kernel forward and
recomputes the plain version for the backward. The JAX package never
differentiates this kernel, but in the port it is the default head of
TemporalUnet1D on CUDA, so training needs its gradient.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from . import _build


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) with the overflow-free softplus jax.nn.softplus uses."""
    return x * torch.tanh(torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs())))


def conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """Stride-1 Conv1d with padding K//2 on channel-last x [B,T,C], w [K,C,O]."""
    K = w.shape[0]
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, padding=K // 2)
    return y.transpose(1, 2).contiguous()


def group_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over (T, C/groups) per sample of channel-last h; biased variance."""
    B, T, O = h.shape
    g = h.reshape(B, T, groups, O // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    g = (g - mean) * torch.rsqrt(var + eps)
    return g.reshape(B, T, O) * scale + bias


def fused_conv1d_gn_mish_reference(
    x: torch.Tensor,  # [B, T, C]
    w: torch.Tensor,  # [K, C, O]
    b: torch.Tensor,  # [O]
    gn_scale: torch.Tensor,  # [O]
    gn_bias: torch.Tensor,  # [O]
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version: Conv1d(pad K//2) + GroupNorm(groups) + Mish."""
    return mish(group_norm(conv1d_same(x, w, b), gn_scale, gn_bias, groups, eps))


def refuse_grad(kernel: str, differentiable: str, *tensors: torch.Tensor | None) -> None:
    """Raise if autograd would want a gradient through a raw kernel wrapper,
    whose output has no autograd history: the gradient would vanish silently."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the kernel's output carries no autograd "
            f"history; call {differentiable} instead, or run under torch.no_grad()"
        )


def recompute_grads(
    fn: Callable[..., torch.Tensor],
    saved: Sequence[torch.Tensor | None],
    needs: Sequence[bool],
    g: torch.Tensor,
) -> list[torch.Tensor | None]:
    """Cotangents of ``fn(*saved)`` for cotangent ``g``, by running ``fn``
    under autograd on detached inputs: the inputs flagged in ``needs`` get
    their gradient, the others (and absent inputs) ``None``."""
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(saved, needs)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*inputs), wanted, g) if wanted else ())
    return [next(grads) if t is not None and t.requires_grad else None for t in inputs]


def fused_conv1d_gn_mish(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    gn_scale: torch.Tensor,
    gn_bias: torch.Tensor,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Conv1d + GroupNorm + Mish: the CUDA kernel on CUDA tensors, plain on CPU."""
    B, T, C = x.shape
    K, _, O = w.shape
    if O % groups:
        raise ValueError(f"fused_conv1d_gn_mish: O={O} not divisible by groups={groups}")
    _build.check_inputs(
        "fused_conv1d_gn_mish", x.device, x=(x, (B, T, C)), w=(w, (K, C, O)),
        b=(b, (O,)), gn_scale=(gn_scale, (O,)), gn_bias=(gn_bias, (O,)),
    )
    refuse_grad("fused_conv1d_gn_mish", "fused_conv1d_gn_mish_differentiable",
                x, w, b, gn_scale, gn_bias)
    if x.device.type == "cpu":
        return fused_conv1d_gn_mish_reference(x, w, b, gn_scale, gn_bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv1d_gn_mish: unsupported device {x.device}")
    _build.check_channels("fused_conv1d_gn_mish", C=C, O=O)
    _build.check_aligned("fused_conv1d_gn_mish", x=x, w=w, gn_scale=gn_scale, gn_bias=gn_bias)
    plan = _build.plan_stage(B, T, C, O, groups, K, num_sms=_build.num_sms(x.device))
    lib = _build.load()
    out = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    scratch = _build.scratch(plan.weight_bytes(C), x.device)
    with torch.cuda.device(x.device):
        err = lib.cindm_fused_conv1d_gn_mish(
            *map(_build.ptr, (x, w, b, gn_scale, gn_bias, out, scratch)),
            scratch.numel() * 4, B, T, C, O, K, groups, eps, plan.samples, plan.n_tile,
            plan.smem_bytes, _build.stream_of(x),
        )
    _build.raise_on_error("fused_conv1d_gn_mish", err)
    fused_conv1d_gn_mish.launches += 1
    return out


fused_conv1d_gn_mish.launches = 0  # kernel launches; the CPU path does not count


class FusedConv1dGNMish(torch.autograd.Function):
    """``fused_conv1d_gn_mish`` with a gradient: the kernel forward, and a
    backward that recomputes the plain version under autograd.
    ``FusedConv1dGNMish.backwards`` counts backward passes on CUDA tensors."""

    backwards = 0

    @staticmethod
    def forward(ctx, x, w, b, gn_scale, gn_bias, groups, eps):
        ctx.save_for_backward(x, w, b, gn_scale, gn_bias)
        ctx.groups, ctx.eps = groups, eps
        return fused_conv1d_gn_mish(x, w, b, gn_scale, gn_bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        grads = recompute_grads(
            lambda *a: fused_conv1d_gn_mish_reference(*a, ctx.groups, ctx.eps),
            ctx.saved_tensors, ctx.needs_input_grad[:5], g,
        )
        if g.device.type == "cuda":
            FusedConv1dGNMish.backwards += 1
        return (*grads, None, None)


def fused_conv1d_gn_mish_differentiable(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    gn_scale: torch.Tensor,
    gn_bias: torch.Tensor,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``fused_conv1d_gn_mish`` that autograd can differentiate; exactly
    ``fused_conv1d_gn_mish`` when no gradient is wanted."""
    args = (x, w, b, gn_scale, gn_bias)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return FusedConv1dGNMish.apply(*args, groups, eps)
    return fused_conv1d_gn_mish(*args, groups, eps)
