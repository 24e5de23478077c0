"""Unet1DForwardModel: the deterministic trajectory surrogate baseline.

Port of ``cindm_tpu/baselines/unet_forward.py``: the TemporalUnet1D
skeleton without time embeddings. The input is noise (zeros by default)
with its first frames overwritten by the condition; the output is a whole
trajectory. The "Unet" and "Unet_single_step" design baselines roll it out.

Every Conv1dBlock (33 at dim_mults (1, 2, 4, 8)) is the port's
``models.blocks.Conv1dBlock``: on CUDA tensors it launches the Conv1d +
GroupNorm + Mish kernel, through ``ops.FusedConv1dGNMish`` and its backward
kernel when autograd wants a gradient. With ``attention`` each linear
attention goes through ``models.blocks.PreNormResidual``'s route (the
attention kernel when no gradient is wanted), and so do the Downsample1d
and Upsample1d (the resampling kernel when no gradient is wanted: CEM's
rollouts). The 1x1 residuals and the skip concatenations are plain PyTorch.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence

import torch
from torch import nn

from ..models.blocks import (
    Conv1d,
    Conv1dBlock,
    Downsample1d,
    LinearAttentionTemporal,
    PreNormResidual,
    Upsample1d,
)
from ..models.unet1d import (
    _conv,
    _conv_block,
    _flip_convT,
    _prenorm_attention,
    _stage_flags,
)


class ResidualBlock(nn.Module):
    """Two Conv1dBlocks and a 1x1 residual, no time embedding."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5, *,
                 generator: torch.Generator):
        super().__init__()
        self.block0 = Conv1dBlock(in_ch, out_ch, kernel_size, generator=generator)
        self.block1 = Conv1dBlock(out_ch, out_ch, kernel_size, generator=generator)
        self.residual = Conv1d(in_ch, out_ch, 1, generator=generator) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        h = self.block1(self.block0(x, use_kernels), use_kernels)
        return h + (x if self.residual is None else self.residual(x))


class Unet1DForwardModel(nn.Module):
    """forward(cond [B, cond_steps, F], noise [B, horizon, F] or None) ->
    [B, horizon, F]. Weights are drawn from ``generator`` (a seed-0 CPU
    generator if None)."""

    def __init__(self, horizon: int, transition_dim: int, dim: int = 64,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), attention: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.horizon, self.transition_dim, self.attention = horizon, transition_dim, attention
        dims = [transition_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.num_res = len(in_out)
        self.down_flags, self.up_flags = _stage_flags(horizon, self.num_res)
        blocks, attns, downs, ups = [], [], [], []

        def attn(d):
            if attention:
                attns.append(PreNormResidual(d, LinearAttentionTemporal(d, generator=g)))

        for ind, (d_in, d_out) in enumerate(in_out):
            blocks += [ResidualBlock(d_in, d_out, generator=g),
                       ResidualBlock(d_out, d_out, generator=g)]
            attn(d_out)
            if self.down_flags[ind]:
                downs.append(Downsample1d(d_out, generator=g))
        mid = dims[-1]
        blocks.append(ResidualBlock(mid, mid, generator=g))
        attn(mid)
        blocks.append(ResidualBlock(mid, mid, generator=g))
        for ind, (d_in, d_out) in enumerate(reversed(in_out[1:])):
            blocks += [ResidualBlock(d_out * 2, d_out, generator=g),
                       ResidualBlock(d_out, d_in, generator=g)]
            attn(d_in)
            if self.up_flags[ind]:
                ups.append(Upsample1d(d_in, generator=g))
        self.blocks = nn.ModuleList(blocks)
        self.attns = nn.ModuleList(attns)
        self.downs = nn.ModuleList(downs)
        self.ups = nn.ModuleList(ups)
        self.final_block = Conv1dBlock(dims[1], dim, kernel_size=5, generator=g)
        self.final_conv = Conv1d(dim, transition_dim, 1, generator=g)

    def forward(self, cond: torch.Tensor, noise: Optional[torch.Tensor] = None,
                use_kernels: bool = True) -> torch.Tensor:
        B, k, F = cond.shape
        if noise is None:
            x = torch.cat([cond, cond.new_zeros((B, self.horizon - k, F))], dim=1)
        else:
            x = torch.cat([cond, noise[:, k:]], dim=1)
        blk, attn = iter(self.blocks), iter(self.attns)
        down, up = iter(self.downs), iter(self.ups)
        hs = []
        for ind in range(self.num_res):
            x = next(blk)(x, use_kernels)
            x = next(blk)(x, use_kernels)
            if self.attention:
                x = next(attn)(x, use_kernels)
            hs.append(x)
            if self.down_flags[ind]:
                x = next(down)(x, use_kernels)
        x = next(blk)(x, use_kernels)
        if self.attention:
            x = next(attn)(x, use_kernels)
        x = next(blk)(x, use_kernels)
        for ind in range(self.num_res - 1):
            x = torch.cat([x, hs.pop()], dim=-1)
            x = next(blk)(x, use_kernels)
            x = next(blk)(x, use_kernels)
            if self.attention:
                x = next(attn)(x, use_kernels)
            if self.up_flags[ind]:
                x = next(up)(x, use_kernels)
        return self.final_conv(self.final_block(x, use_kernels))

    def flax_mapping(self) -> Iterator[tuple[tuple[str, ...], str, Any]]:
        """(Flax key-path, state_dict key, transform) for every parameter."""
        for k, m in enumerate(self.blocks):
            fp, pk = (f"ResidualBlock_{k}",), f"blocks.{k}."
            yield from _conv_block(fp + ("Conv1dBlock_0",), pk + "block0.")
            yield from _conv_block(fp + ("Conv1dBlock_1",), pk + "block1.")
            if m.residual is not None:
                yield from _conv(fp + ("Conv1d_0",), pk + "residual.")
        for k in range(len(self.attns)):
            yield from _prenorm_attention(f"PreNormResidual_{k}", f"LinearAttentionTemporal_{k}",
                                          f"attns.{k}.")
        for k in range(len(self.downs)):
            yield from _conv((f"Downsample1d_{k}", "Conv1d_0"), f"downs.{k}.conv.")
        for k in range(len(self.ups)):
            yield (f"Upsample1d_{k}", "ConvTranspose_0", "kernel"), f"ups.{k}.weight", _flip_convT
            yield (f"Upsample1d_{k}", "ConvTranspose_0", "bias"), f"ups.{k}.bias", None
        yield from _conv_block(("Conv1dBlock_0",), "final_block.")
        yield from _conv(("Conv1d_0",), "final_conv.")
