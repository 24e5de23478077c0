"""Unet1D, the generic DDPM-style 1D U-Net.

Port of ``cindm_tpu/models/unet1d_generic.py``: a 7-tap input conv,
weight-standardised ResnetBlocks with a FiLM time embedding (GELU time MLP
at 4 * dim), linear attention at every resolution, full attention in the
middle, skips taken before each block pair (two per stage) and a final
residual block over [x, input-conv output]. Layout is channel-last
[B, T, channels]. No CLI builds it; the n-body paths use TemporalUnet1D.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_conv_gn import conv1d_same
from .blocks import (
    Conv1d,
    Dense,
    FullAttention,
    GroupNorm,
    LinearAttention,
    PreNormResidual,
    RandomOrLearnedSinusoidalPosEmb,
    SinusoidalPosEmb,
    _uniform,
)
from .unet1d import FlaxNames, _conv, _dense, _prenorm_attention


class WSConv1d(nn.Module):
    """Weight-standardised conv (pad K//2): the kernel [K, C, O] normalised
    per output channel over (K, C), biased variance, eps 1e-5."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, eps: float = 1e-5, *,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = _uniform((kernel_size, in_ch, out_ch), in_ch * kernel_size, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        mean = k.mean(dim=(0, 1), keepdim=True)
        var = (k - mean).square().mean(dim=(0, 1), keepdim=True)
        return conv1d_same(x, (k - mean) * torch.rsqrt(var + self.eps), self.bias)


class Block1D(nn.Module):
    """WSConv1d(3) -> GroupNorm -> optional (scale + 1, shift) -> SiLU."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 8, *, generator: torch.Generator):
        super().__init__()
        self.conv = WSConv1d(in_ch, out_ch, 3, generator=generator)
        self.norm = GroupNorm(out_ch, groups)

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        x = self.norm(self.conv(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock1D(nn.Module):
    """Two Block1Ds, the first FiLM-modulated by the time embedding, and a
    1x1 residual when the width changes."""

    def __init__(self, in_ch: int, out_ch: int, time_dim: Optional[int], groups: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        self.time = Dense(time_dim, out_ch * 2, generator=generator) if time_dim else None
        self.block0 = Block1D(in_ch, out_ch, groups, generator=generator)
        self.block1 = Block1D(out_ch, out_ch, groups, generator=generator)
        self.residual = Conv1d(in_ch, out_ch, 1, generator=generator) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale_shift = None
        if t_emb is not None and self.time is not None:
            scale_shift = self.time(F.silu(t_emb))[:, None, :].chunk(2, dim=-1)
        h = self.block1(self.block0(x, scale_shift))
        return h + (x if self.residual is None else self.residual(x))


class Unet1D(nn.Module):
    """forward(x [B, T, channels], time [B]) -> [B, T, out_dim or channels].
    T must be divisible by 2^(len(dim_mults) - 1). Weights are drawn from
    ``generator`` (a seed-0 CPU generator if None)."""

    def __init__(self, dim: int, channels: int = 3, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 out_dim: Optional[int] = None, resnet_block_groups: int = 8,
                 learned_sinusoidal_cond: bool = False, random_fourier_features: bool = False,
                 learned_sinusoidal_dim: int = 16, *, generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        gr = resnet_block_groups
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.num_res = len(in_out)
        tdim = dim * 4

        self.init_conv = Conv1d(channels, dim, 7, generator=g)
        self.fourier = learned_sinusoidal_cond or random_fourier_features
        if self.fourier:
            self.time_pos = RandomOrLearnedSinusoidalPosEmb(
                learned_sinusoidal_dim, random_fourier_features, generator=g)
            fourier_dim = learned_sinusoidal_dim + 1
        else:
            self.time_pos = SinusoidalPosEmb(dim)
            fourier_dim = dim
        self.time_mlp = nn.ModuleList([Dense(fourier_dim, tdim, generator=g),
                                       Dense(tdim, tdim, generator=g)])

        def res(i, o):
            return ResnetBlock1D(i, o, tdim, gr, generator=g)

        def lin_attn(d):
            return PreNormResidual(d, LinearAttention(d, generator=g))

        self.downs = nn.ModuleList()
        for ind, (d_in, d_out) in enumerate(in_out):
            last = ind >= self.num_res - 1
            conv = (Conv1d(d_in, d_out, 3, generator=g) if last
                    else Conv1d(d_in, d_out, 4, stride=2, padding=1, generator=g))
            self.downs.append(nn.ModuleList([res(d_in, d_in), res(d_in, d_in), lin_attn(d_in), conv]))
        mid = dims[-1]
        self.mid = nn.ModuleList([res(mid, mid), PreNormResidual(mid, FullAttention(mid, generator=g)),
                                  res(mid, mid)])
        self.ups = nn.ModuleList()
        for d_in, d_out in reversed(in_out):
            self.ups.append(nn.ModuleList([res(d_out + d_in, d_out), res(d_out + d_in, d_out),
                                           lin_attn(d_out), Conv1d(d_out, d_in, 3, generator=g)]))
        self.final_res = res(dim * 2, dim)
        self.final_conv = Conv1d(dim, out_dim or channels, 1, generator=g)

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        x = self.init_conv(x)
        r = x
        t = self.time_mlp[1](F.gelu(self.time_mlp[0](self.time_pos(time)), approximate="tanh"))
        hs = []
        for res0, res1, attn, conv in self.downs:
            x = res0(x, t)
            hs.append(x)
            x = attn(res1(x, t))
            hs.append(x)
            x = conv(x)
        x = self.mid[2](self.mid[1](self.mid[0](x, t)), t)
        for ind, (res0, res1, attn, conv) in enumerate(self.ups):
            x = res0(torch.cat([x, hs.pop()], dim=-1), t)
            x = res1(torch.cat([x, hs.pop()], dim=-1), t)
            x = attn(x)
            if ind < self.num_res - 1:
                x = x.repeat_interleave(2, dim=1)  # nearest-neighbour x2 in time
            x = conv(x)
        x = self.final_res(torch.cat([x, r], dim=-1), t)
        return self.final_conv(x)

    def flax_mapping(self) -> Iterator[tuple[tuple[str, ...], str, Any]]:
        """(Flax key-path, state_dict key, transform) for every parameter,
        numbered in the JAX module's call order."""
        top = FlaxNames()

        def resnet(pk):
            fp = (top("ResnetBlock1D"),)
            yield from _dense(fp + ("Dense_0",), pk + "time.")
            for i in range(2):
                b = fp + (f"Block1D_{i}",)
                yield b + ("WSConv1d_0", "kernel"), pk + f"block{i}.conv.kernel", None
                yield b + ("WSConv1d_0", "bias"), pk + f"block{i}.conv.bias", None
                yield b + ("GroupNorm_0", "scale"), pk + f"block{i}.norm.weight", None
                yield b + ("GroupNorm_0", "bias"), pk + f"block{i}.norm.bias", None
            if pk + "residual.weight" in keys:
                yield from _conv(fp + ("Conv1d_0",), pk + "residual.")

        keys = set(self.state_dict())
        yield from _conv((top("Conv1d"),), "init_conv.")
        if self.fourier:
            yield (top("RandomOrLearnedSinusoidalPosEmb"), "weights"), "time_pos.weights", None
        yield from _dense((top("Dense"),), "time_mlp.0.")
        yield from _dense((top("Dense"),), "time_mlp.1.")
        for i in range(self.num_res):
            pk = f"downs.{i}."
            yield from resnet(pk + "0.")
            yield from resnet(pk + "1.")
            yield from _prenorm_attention(top("PreNormResidual"), top("LinearAttention"), pk + "2.")
            yield from _conv((top("Conv1d"),), pk + "3.")
        yield from resnet("mid.0.")
        yield from _prenorm_attention(top("PreNormResidual"), top("FullAttention"), "mid.1.")
        yield from resnet("mid.2.")
        for i in range(self.num_res):
            pk = f"ups.{i}."
            yield from resnet(pk + "0.")
            yield from resnet(pk + "1.")
            yield from _prenorm_attention(top("PreNormResidual"), top("LinearAttention"), pk + "2.")
            yield from _conv((top("Conv1d"),), pk + "3.")
        yield from resnet("final_res.")
        yield from _conv((top("Conv1d"),), "final_conv.")
