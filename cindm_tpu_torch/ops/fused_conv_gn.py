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
(through ``FusedConv1dGNMish``) launches the kernel's saving instance
forward, which also keeps the conv output z and the GroupNorm's mean and
rstd, and ``fused_conv1d_gn_mish_backward`` (``csrc/block_backward.cu``)
backward from them, without recomputing the forward. Their plain versions,
``fused_conv1d_gn_mish_forward_saving_reference`` and
``fused_conv1d_gn_mish_backward_reference`` (the closed-form GroupNorm,
Mish and conv gradients in PyTorch, not autograd), serve CPU tensors. The
JAX package never differentiates this kernel, but in the port it is the
default head of TemporalUnet1D on CUDA, so training needs its gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

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


def normalize(h: torch.Tensor, groups: int,
              eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(yh, mean, rstd): h [B, T, O] normalised over (T, O/groups) per sample
    with biased variance, and the per-(sample, group) mean and
    1/sqrt(var + eps) [B, groups]."""
    B, T, O = h.shape
    g = h.reshape(B, T, groups, O // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return ((g - mean) * rstd).reshape(B, T, O), mean.reshape(B, groups), rstd.reshape(B, groups)


def group_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over (T, C/groups) per sample of channel-last h; biased variance."""
    return normalize(h, groups, eps)[0] * scale + bias


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


def mish_grad(y: torch.Tensor) -> torch.Tensor:
    """d/dy Mish(y) = tanh(sp) + y sigmoid(y) (1 - tanh(sp)^2), sp = softplus(y)
    in the overflow-free form ``mish`` uses."""
    t = torch.tanh(torch.clamp_min(y, 0.0) + torch.log1p(torch.exp(-y.abs())))
    return t + y * torch.sigmoid(y) * (1.0 - t * t)


def gn_mish_backward_reference(
    d: torch.Tensor, z: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
    gs: torch.Tensor, gb: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dz, dgs, dgb) of Mish(GN(z) * gs + gb) for its output's cotangent d,
    from the forward's saved z [B, T, O], mean and rstd [B, G]:
    dz = rstd (dyh - m[dyh] - yh m[dyh yh]) with dyh = d mish'(y) gs and m[.]
    the mean over each (sample, group)."""
    B, T, O = z.shape
    G = mean.shape[1]
    m, r = mean[:, None, :, None], rstd[:, None, :, None]
    yh = ((z.reshape(B, T, G, O // G) - m) * r).reshape(B, T, O)
    dy = d * mish_grad(yh * gs + gb)
    dyh = (dy * gs).reshape(B, T, G, O // G)
    yhg = yh.reshape(B, T, G, O // G)
    dz = r * (dyh - dyh.mean(dim=(1, 3), keepdim=True)
              - yhg * (dyh * yhg).mean(dim=(1, 3), keepdim=True))
    return dz.reshape(B, T, O), (dy * yh).sum(dim=(0, 1)), dy.sum(dim=(0, 1))


def conv1d_dgrad(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input cotangent of ``conv1d_same`` (w [K, C, O]) for its output's
    cotangent dz [B, T, O]: the conv with w flipped in time and transposed."""
    return conv1d_same(dz, w.flip(0).transpose(1, 2), None)


def conv1d_wgrad(x: torch.Tensor, dz: torch.Tensor, K: int) -> torch.Tensor:
    """dw [K, C, O] of ``conv1d_same``: dw[k] = sum over b, t of
    x[b, t + k - K//2] outer dz[b, t], zero padding at the sample's edges."""
    T = x.shape[1]
    xp = F.pad(x, (0, 0, K // 2, K // 2))
    return torch.stack([torch.einsum("btc,bto->co", xp[:, k:k + T], dz) for k in range(K)])


class ConvGNMishSaved(NamedTuple):
    """What ``FusedConv1dGNMish`` keeps for its backward: the inputs, and
    the conv output plus bias z [B, T, O] with its GroupNorm's mean and
    rstd [B, G]."""

    x: torch.Tensor
    w: torch.Tensor
    b: torch.Tensor
    gn_scale: torch.Tensor
    gn_bias: torch.Tensor
    z: torch.Tensor
    mean: torch.Tensor
    rstd: torch.Tensor


def fused_conv1d_gn_mish_forward_saving_reference(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gn_scale: torch.Tensor,
    gn_bias: torch.Tensor, groups: int = 8, eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the saving forward: (out, z, mean, rstd), out equal
    to ``fused_conv1d_gn_mish_reference``'s bit for bit."""
    z = conv1d_same(x, w, b)
    yh, mean, rstd = normalize(z, groups, eps)
    return mish(yh * gn_scale + gn_bias), z, mean, rstd


def fused_conv1d_gn_mish_backward_reference(
    saved: Sequence[torch.Tensor], g: torch.Tensor, needs: Sequence[bool],
) -> list[torch.Tensor | None]:
    """Plain version of ``fused_conv1d_gn_mish_backward``: the cotangents of
    (x, w, b, gn_scale, gn_bias) from ``ConvGNMishSaved`` fields and the
    output's cotangent g, by the closed forms; None where ``needs`` is False."""
    s = ConvGNMishSaved(*saved)
    dz, dgs, dgb = gn_mish_backward_reference(g, s.z, s.mean, s.rstd, s.gn_scale, s.gn_bias)
    grads = [conv1d_dgrad(dz, s.w) if needs[0] else None, conv1d_wgrad(s.x, dz, s.w.shape[0]),
             dz.sum(dim=(0, 1)), dgs, dgb]
    return [v if n else None for v, n in zip(grads, needs)]


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
    refuse_grad("fused_conv1d_gn_mish", "fused_conv1d_gn_mish_differentiable",
                x, w, b, gn_scale, gn_bias)
    return _conv_gn_mish(x, w, b, gn_scale, gn_bias, groups, eps, save=False)[0]


def _conv_gn_mish(x, w, b, gn_scale, gn_bias, groups, eps, save: bool) -> tuple:
    """(out,), or with ``save`` (out, z, mean, rstd) for the backward."""
    B, T, C = x.shape
    K, _, O = w.shape
    if O % groups:
        raise ValueError(f"fused_conv1d_gn_mish: O={O} not divisible by groups={groups}")
    _build.check_inputs(
        "fused_conv1d_gn_mish", x.device, x=(x, (B, T, C)), w=(w, (K, C, O)),
        b=(b, (O,)), gn_scale=(gn_scale, (O,)), gn_bias=(gn_bias, (O,)),
    )
    if x.device.type == "cpu":
        if save:
            return fused_conv1d_gn_mish_forward_saving_reference(x, w, b, gn_scale, gn_bias,
                                                                 groups, eps)
        return (fused_conv1d_gn_mish_reference(x, w, b, gn_scale, gn_bias, groups, eps),)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv1d_gn_mish: unsupported device {x.device}")
    _build.check_channels("fused_conv1d_gn_mish", C=C, O=O)
    _build.check_aligned("fused_conv1d_gn_mish", x=x, w=w, gn_scale=gn_scale, gn_bias=gn_bias)
    plan = _build.plan_stage(B, T, C, O, groups, K, num_sms=_build.num_sms(x.device))
    lib = _build.load()
    out = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    scratch = _build.scratch(plan.weight_bytes(C), x.device)
    saved = ()
    if save:
        saved = tuple(_build.carve(x.device, (B, T, O), (B, groups), (B, groups)))
    err = _build.call_on(
        x.device,
        lib.cindm_fused_conv1d_gn_mish_saving if save else lib.cindm_fused_conv1d_gn_mish,
        *map(_build.ptr, (x, w, b, gn_scale, gn_bias, out, *saved, scratch)),
        scratch.numel() * 4, B, T, C, O, K, groups, eps, plan.samples, plan.n_tile,
        plan.smem_bytes,
    )
    _build.raise_on_error("fused_conv1d_gn_mish", err)
    fused_conv1d_gn_mish.launches += 1
    return (out, *saved)


fused_conv1d_gn_mish.launches = 0  # kernel launches (either instance); the CPU path does not count


def fused_conv1d_gn_mish_backward(
    saved: Sequence[torch.Tensor], g: torch.Tensor, needs: Sequence[bool],
) -> list[torch.Tensor | None]:
    """The head's backward kernel (``csrc/block_backward.cu``) on CUDA
    tensors: the cotangents of (x, w, b, gn_scale, gn_bias) from
    ``ConvGNMishSaved`` fields and the output's cotangent g; None where
    ``needs`` is False (dx is then not computed; without any of the other
    four, wgrad does not run: the x-only gradient of design by backprop).
    Raises on other devices;
    ``fused_conv1d_gn_mish_backward_reference`` is the plain version."""
    s = ConvGNMishSaved(*saved)
    B, T, C = s.x.shape
    K, _, O = s.w.shape
    G = s.mean.shape[1]
    grads = _build.launch_backward(
        "fused_conv1d_gn_mish_backward", False, dict(x=s.x, w1=s.w, gs1=s.gn_scale,
                                                     gb1=s.gn_bias, g=g, z1=s.z, mean1=s.mean,
                                                     rstd1=s.rstd),
        B, T, C, O, K, G, want_dx=needs[0], want_dtemb=False, want_w=any(needs[1:]))
    fused_conv1d_gn_mish_backward.launches += 1
    return [grads.get(n) if want else None
            for n, want in zip(("dx", "dw1", "db1", "dgs1", "dgb1"), needs)]


fused_conv1d_gn_mish_backward.launches = 0  # kernel calls (4-5 launches each)


class FusedConv1dGNMish(torch.autograd.Function):
    """``fused_conv1d_gn_mish`` with a gradient. On CUDA tensors the forward
    is the kernel's saving instance and the backward the kernel
    ``fused_conv1d_gn_mish_backward`` on what it saved; on CPU tensors their
    plain versions. On CUDA tensors ``FusedConv1dGNMish.launches`` counts the
    forward's kernel calls and ``FusedConv1dGNMish.backwards`` the backward
    passes."""

    launches = 0
    backwards = 0

    @staticmethod
    def forward(ctx, x, w, b, gn_scale, gn_bias, groups, eps):
        out, *saved = _conv_gn_mish(x, w, b, gn_scale, gn_bias, groups, eps, save=True)
        ctx.save_for_backward(x, w, b, gn_scale, gn_bias, *saved)
        if x.device.type == "cuda":
            FusedConv1dGNMish.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        cuda = g.device.type == "cuda"
        fn = fused_conv1d_gn_mish_backward if cuda else fused_conv1d_gn_mish_backward_reference
        grads = fn(ctx.saved_tensors, g.contiguous(), ctx.needs_input_grad[:5])
        if cuda:
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
