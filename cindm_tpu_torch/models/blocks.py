"""Denoiser building blocks (1D), channel-last [B, T, C].

Port of the 1D part of ``cindm_tpu/models/blocks.py``. Weights are kept in
the JAX package's layouts where a kernel reads them: Conv1d kernels are
[K, C_in, C_out] and Dense kernels [in, out]. The transposed conv of
Upsample1d keeps PyTorch's ConvTranspose1d layout [C_in, C_out, K].

Initialisation mimics torch's Conv/Linear defaults, U(+-1/sqrt(fan_in)) for
kernel and bias, as the JAX package does; every draw comes from the
``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (
    fused_conv1d_gn_mish_differentiable,
    fused_conv1d_gn_mish_reference,
    fused_rtb_differentiable,
    fused_rtb_reference,
    mish,
)
from ..ops.fused_conv_gn import group_norm
from ..ops.linear_attention import (
    channel_layer_norm,
    linear_attention_temporal_reference,
    prenorm_linear_attention_differentiable,
    prenorm_linear_attention_reference,
)
from ..ops.resample import (
    downsample1d_differentiable,
    downsample1d_reference,
    upsample1d_differentiable,
    upsample1d_reference,
)

__all__ = [
    "ChannelLayerNorm",
    "Conv1d",
    "Conv1dBlock",
    "Dense",
    "Downsample1d",
    "FullAttention",
    "GroupNorm",
    "LinearAttention",
    "LinearAttentionTemporal",
    "PreNormResidual",
    "RandomOrLearnedSinusoidalPosEmb",
    "ResidualTemporalBlock",
    "SinusoidalPosEmb",
    "Upsample1d",
    "mish",
]


def _uniform(shape, fan_in: int, generator: torch.Generator) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound)


class Conv1d(nn.Module):
    """Conv over the time axis of [B, T, C]; weight [K, C_in, C_out]."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *, stride: int = 1,
                 padding: int | None = None, generator: torch.Generator):
        super().__init__()
        fan_in = in_ch * kernel_size
        self.weight = _uniform((kernel_size, in_ch, out_ch), fan_in, generator)
        self.bias = _uniform((out_ch,), fan_in, generator)
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.weight.permute(2, 1, 0), self.bias,
                     stride=self.stride, padding=self.padding)
        return y.transpose(1, 2).contiguous()


class Dense(nn.Module):
    """x @ weight + bias with weight [in, out]."""

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 generator: torch.Generator):
        super().__init__()
        self.weight = _uniform((in_features, out_features), in_features, generator)
        self.bias = _uniform((out_features,), in_features, generator) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class SinusoidalPosEmb(nn.Module):
    """Timestep embedding [B] -> [B, dim]."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device)
            * -(math.log(10000.0) / (half - 1))
        )
        args = t.to(torch.float32)[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """Fourier timestep features [B] -> [B, dim + 1]: t, sin and cos of
    2 pi t w for ``dim // 2`` frequencies w ~ N(0, 1), learned unless
    ``is_random`` (then they get no gradient)."""

    def __init__(self, dim: int, is_random: bool = False, *, generator: torch.Generator):
        super().__init__()
        if dim % 2:
            raise ValueError(f"dim must be even, got {dim}")
        self.weights = nn.Parameter(torch.randn(dim // 2, generator=generator),
                                    requires_grad=not is_random)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)[:, None]
        freqs = t * self.weights[None, :] * (2 * math.pi)
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class ChannelLayerNorm(nn.Module):
    """Bias-free LayerNorm over channels: biased variance, eps 1e-5, gain g."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_layer_norm(x, self.g, self.eps)


class GroupNorm(nn.Module):
    """GroupNorm over channel-last input (torch's defaults: eps 1e-5, affine)."""

    def __init__(self, channels: int, num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class Conv1dBlock(nn.Module):
    """Conv1d(k, pad k//2) -> GroupNorm(8) -> Mish.

    With ``use_kernels`` the block goes through
    ``ops.fused_conv1d_gn_mish_differentiable`` (the CUDA kernel on CUDA
    tensors, with a recompute backward under autograd); otherwise through its
    plain version.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, n_groups: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, kernel_size, generator=generator)
        self.norm = GroupNorm(out_ch, n_groups)

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        fn = fused_conv1d_gn_mish_differentiable if use_kernels else fused_conv1d_gn_mish_reference
        return fn(x, self.conv.weight, self.conv.bias, self.norm.weight, self.norm.bias,
                  self.norm.num_groups, self.norm.eps)


class ResidualTemporalBlock(nn.Module):
    """Two Conv1dBlocks with an additive time embedding and a 1x1 residual.

    The time projection Dense(mish(t_emb)) runs outside the kernel, here or,
    given as ``temb`` ([B, O], its rows possibly a view of a wider matrix),
    by the caller (TemporalUnet1D projects every block's at once); the rest
    of the block is one ``ops.fused_rtb_differentiable`` call with
    ``use_kernels``: the kernel alone under ``torch.no_grad()``, the
    ``FusedRTB`` autograd Function when a gradient is wanted. The 1x1
    residual's weight goes in as the view ``weight[0]``, so its gradient
    flows back into the [1, C, O] parameter.
    """

    def __init__(self, in_ch: int, out_ch: int, embed_dim: int, kernel_size: int = 5, *,
                 generator: torch.Generator):
        super().__init__()
        self.block0 = Conv1dBlock(in_ch, out_ch, kernel_size, generator=generator)
        self.block1 = Conv1dBlock(out_ch, out_ch, kernel_size, generator=generator)
        self.time = Dense(embed_dim, out_ch, generator=generator)
        self.residual = (
            Conv1d(in_ch, out_ch, 1, generator=generator) if in_ch != out_ch else None
        )

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor | None, use_kernels: bool = True, *,
                temb: torch.Tensor | None = None) -> torch.Tensor:
        if temb is None:
            temb = self.time(mish(t_emb))
        b0, b1 = self.block0, self.block1
        res = self.residual
        fn = fused_rtb_differentiable if use_kernels else fused_rtb_reference
        return fn(
            x, temb,
            b0.conv.weight, b0.conv.bias, b0.norm.weight, b0.norm.bias,
            b1.conv.weight, b1.conv.bias, b1.norm.weight, b1.norm.bias,
            None if res is None else res.weight[0],
            None if res is None else res.bias,
            b0.norm.num_groups, b0.norm.eps,
        )


class LinearAttentionTemporal(nn.Module):
    """Softmax-kernel linear attention over the time axis of [B, T, C].

    Per head: k is softmaxed over time, context = k^T v, out = q context.
    The JAX package computes the same per-head contraction as one
    block-diagonal [hidden, hidden] product.
    """

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.qkv = Dense(dim, hidden * 3, use_bias=False, generator=generator)
        self.out = Dense(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_attention_temporal_reference(x, self.qkv.weight, self.out.weight, self.out.bias,
                                                   self.heads, self.dim_head)


class LinearAttention(nn.Module):
    """Linear attention over the sequence axis of [B, N, C], with q softmaxed
    per head over its channels, k over the sequence, and a ChannelLayerNorm
    after the output projection."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.qkv = Dense(dim, hidden * 3, use_bias=False, generator=generator)
        self.out = Dense(hidden, dim, generator=generator)
        self.norm = ChannelLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        split = lambda a: a.reshape(B, N, self.heads, self.dim_head)
        q, k, v = map(split, self.qkv(x).chunk(3, dim=-1))
        q = torch.softmax(q, dim=-1) * (self.dim_head ** -0.5)
        k = torch.softmax(k, dim=1)
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bnhd,bhde->bnhe", q, context)
        return self.norm(self.out(out.reshape(B, N, self.heads * self.dim_head)))


class FullAttention(nn.Module):
    """Softmax attention over the sequence axis of [B, N, C], written out as
    einsums (no fused attention backend: its arithmetic differs)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.qkv = Dense(dim, hidden * 3, use_bias=False, generator=generator)
        self.out = Dense(hidden, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        split = lambda a: a.reshape(B, N, self.heads, self.dim_head)
        q, k, v = map(split, self.qkv(x).chunk(3, dim=-1))
        sim = torch.einsum("bihd,bjhd->bhij", q * (self.dim_head ** -0.5), k)
        out = torch.einsum("bhij,bjhd->bihd", torch.softmax(sim, dim=-1), v)
        return self.out(out.reshape(B, N, self.heads * self.dim_head))


class PreNormResidual(nn.Module):
    """fn(ChannelLayerNorm(x)) + x.

    Around a ``LinearAttentionTemporal`` the whole block is one call of
    ``ops.prenorm_linear_attention_reference``, or with ``use_kernels`` of
    ``ops.prenorm_linear_attention_differentiable``: the kernel on CUDA
    tensors when no gradient is wanted, the plain version under autograd
    when one is. Other wrapped modules ignore ``use_kernels``.
    """

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        fn = self.fn
        if not isinstance(fn, LinearAttentionTemporal):
            return fn(self.norm(x)) + x
        block = prenorm_linear_attention_differentiable if use_kernels else prenorm_linear_attention_reference
        return block(x, self.norm.g, fn.qkv.weight, fn.out.weight, fn.out.bias, fn.heads, fn.dim_head,
                     self.norm.eps)


class Downsample1d(nn.Module):
    """Conv k3 s2 p1: halves the time axis.

    With ``use_kernels`` it goes through ``ops.downsample1d_differentiable``
    (the CUDA kernel on CUDA tensors when no gradient is wanted, the plain
    version under autograd when one is); otherwise through the plain version.
    """

    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv1d(dim, dim, 3, stride=2, padding=1, generator=generator)

    def forward(self, x: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        fn = downsample1d_differentiable if use_kernels else downsample1d_reference
        return fn(x, self.conv.weight, self.conv.bias)


class Upsample1d(nn.Module):
    """Transposed conv k4 s2: doubles the time axis.

    Flax's ConvTranspose(k4, s2, "SAME") equals torch's conv_transpose1d with
    stride 2, padding 1 and the kernel flipped along K; the weight is stored
    in torch's layout [C_in, C_out, K], already flipped. With
    ``use_kernels`` it goes through ``ops.upsample1d_differentiable``, as
    Downsample1d does.
    """

    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        fan_in = dim * 4
        self.weight = _uniform((dim, dim, 4), fan_in, generator)
        self.bias = _uniform((dim,), fan_in, generator)

    def forward(self, x: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        fn = upsample1d_differentiable if use_kernels else upsample1d_reference
        return fn(x, self.weight, self.bias)
