"""Fused Conv1d + GroupNorm + Mish (the Conv1dBlock body).

Port of ``cindm_tpu/ops/fused_conv_gn.py``. ``fused_conv1d_gn_mish`` launches
the hand-written CUDA kernel in ``csrc/fused_conv_gn.cu`` for CUDA tensors and
uses ``fused_conv1d_gn_mish_reference`` for CPU tensors. Layout is
channel-last: x [B, T, C], w [K, C, O] (the JAX package's layout, which the
kernel reads directly), out [B, T, O].
"""

from __future__ import annotations

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
    if x.device.type == "cpu":
        return fused_conv1d_gn_mish_reference(x, w, b, gn_scale, gn_bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv1d_gn_mish: unsupported device {x.device}")
    _build.check_channels("fused_conv1d_gn_mish", C=C)
    lib = _build.load()
    out = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.cindm_fused_conv1d_gn_mish(
            *map(_build.ptr, (x, w, b, gn_scale, gn_bias, out)),
            B, T, C, O, K, groups, eps, _build.stream_of(x),
        )
    _build.raise_on_error("fused_conv1d_gn_mish", err)
    fused_conv1d_gn_mish.launches += 1
    return out


fused_conv1d_gn_mish.launches = 0  # kernel launches; the CPU path does not count
