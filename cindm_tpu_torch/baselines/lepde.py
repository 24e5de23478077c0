"""LE-PDE: latent evolution surrogate baseline.

Port of ``cindm_tpu/baselines/lepde.py``: a CNN encoder to a flat latent
(default 160) plus a static-boundary encoder, an MLP latent evolution
operator, and a transposed-CNN decoder; the loss is multi-step prediction +
0.1 reconstruction + 0.1 latent consistency.

The models take NCHW; three Flax conventions are kept exactly:

- ``Conv(3x3, stride s, "SAME")`` pads ``(out - 1) * s + 3 - n`` in total,
  the smaller half before: on an even size at stride 2 that is 0 before and
  1 after (torch's ``padding=1`` would shift the grid), at stride 4 from 64
  or 16 nothing;
- ``ConvTranspose(4x4, stride 2, "SAME")`` is ``conv_transpose2d`` with
  padding 1 and the Flax kernel flipped in both spatial axes
  (``models.unet1d.flip_convT2d``);
- the encoders flatten, and the decoder unflattens, in channel-last order,
  so the Dense weights are the JAX package's as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.blocks import Dense, _uniform
from ..models.unet1d import flip_convT2d, hwio_to_oihw
from .harness import loss_core

__all__ = ["CNNDecoder", "CNNEncoder", "EvolutionOp", "LEPDE", "LEPDEConfig", "StaticEncoder",
           "lepde_loss"]


@dataclasses.dataclass(frozen=True)
class LEPDEConfig:
    latent_size: int = 160
    channels: int = 3  # (vx, vy, p)
    static_channels: int = 3  # (mask, offx, offy)
    static_latent_size: int = 16
    enc_dim: int = 32
    evo_hidden: int = 256
    n_conv: int = 4  # 64 -> 4 after 4 stride-2 convs


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Module):
    """Flax ``Conv(k x k, strides=s, padding="SAME")``; weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int, *, generator: torch.Generator):
        super().__init__()
        self.weight = _uniform((out_ch, in_ch, k, k), in_ch * k * k, generator)
        self.bias = _uniform((out_ch,), in_ch * k * k, generator)
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        (t, b), (l, r) = _same_pad(x.shape[2], k, s), _same_pad(x.shape[3], k, s)
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight, self.bias, stride=s)


class ConvTranspose2x(nn.Module):
    """Flax ``ConvTranspose(4 x 4, strides=2, padding="SAME")``: doubles H and
    W; weight [in, out, 4, 4] (the Flax kernel flipped)."""

    def __init__(self, in_ch: int, out_ch: int, *, generator: torch.Generator):
        super().__init__()
        self.weight = _uniform((in_ch, out_ch, 4, 4), in_ch * 16, generator)
        self.bias = _uniform((out_ch,), in_ch * 16, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2, padding=1)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNNEncoder(nn.Module):
    """n_conv stride-2 convs (enc_dim * 2^k channels) with ELU -> Dense(latent)."""

    def __init__(self, cfg: LEPDEConfig, in_hw: int = 64, *, generator: torch.Generator):
        super().__init__()
        c, chans = cfg, [cfg.channels] + [cfg.enc_dim * 2 ** k for k in range(cfg.n_conv)]
        self.convs = nn.ModuleList(SameConv2d(a, b, 3, 2, generator=generator)
                                   for a, b in zip(chans[:-1], chans[1:]))
        hw = in_hw
        for _ in range(c.n_conv):
            hw = math.ceil(hw / 2)
        self.dense = Dense(hw * hw * chans[-1], c.latent_size, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.elu(conv(x))
        return self.dense(_flatten_nhwc(x))


class StaticEncoder(nn.Module):
    """Two stride-4 convs (enc_dim channels) with ELU -> Dense(static latent)."""

    def __init__(self, cfg: LEPDEConfig, in_hw: int = 64, *, generator: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleList([SameConv2d(cfg.static_channels, cfg.enc_dim, 3, 4, generator=generator),
                                    SameConv2d(cfg.enc_dim, cfg.enc_dim, 3, 4, generator=generator)])
        hw = math.ceil(math.ceil(in_hw / 4) / 4)
        self.dense = Dense(hw * hw * cfg.enc_dim, cfg.static_latent_size, generator=generator)

    def forward(self, static: torch.Tensor) -> torch.Tensor:
        x = static
        for conv in self.convs:
            x = F.elu(conv(x))
        return self.dense(_flatten_nhwc(x))


class EvolutionOp(nn.Module):
    """MLP z_{t+1} = f(z_t | z_static)."""

    def __init__(self, cfg: LEPDEConfig, *, generator: torch.Generator):
        super().__init__()
        g, c = generator, cfg
        self.denses = nn.ModuleList([Dense(c.latent_size + c.static_latent_size, c.evo_hidden, generator=g),
                                     Dense(c.evo_hidden, c.evo_hidden, generator=g),
                                     Dense(c.evo_hidden, c.latent_size, generator=g)])

    def forward(self, z: torch.Tensor, z_static: torch.Tensor) -> torch.Tensor:
        h = torch.cat([z, z_static], dim=-1)
        h = F.elu(self.denses[0](h))
        h = F.elu(self.denses[1](h))
        return self.denses[2](h)


class CNNDecoder(nn.Module):
    """Dense to [hw0, hw0, ch0] (channel-last order) -> n_conv transposed
    convs x2 with ELU between them -> [B, channels, out_hw, out_hw]."""

    def __init__(self, cfg: LEPDEConfig, out_hw: int = 64, *, generator: torch.Generator):
        super().__init__()
        c = cfg
        self.hw0, self.ch0 = out_hw // 2 ** c.n_conv, c.enc_dim * 2 ** (c.n_conv - 1)
        self.dense = Dense(c.latent_size, self.hw0 * self.hw0 * self.ch0, generator=generator)
        chans = [c.enc_dim * 2 ** k for k in range(c.n_conv - 1, -1, -1)] + [c.channels]
        self.convs = nn.ModuleList(ConvTranspose2x(a, b, generator=generator)
                                   for a, b in zip(chans[:-1], chans[1:]))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.dense(z).reshape(z.shape[0], self.hw0, self.hw0, self.ch0).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < len(self.convs) - 1:
                x = F.elu(x)
        return x


class LEPDE(nn.Module):
    """Encode u_t (+ the static boundary) -> evolve n_steps -> decode each:
    ``forward(u [B, C, H, W], static [B, Cs, H, W], n_steps) -> [B, n_steps, C, H, W]``."""

    def __init__(self, cfg: LEPDEConfig = LEPDEConfig(), out_hw: int = 64, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.encoder = CNNEncoder(cfg, out_hw, generator=g)
        self.static_encoder = StaticEncoder(cfg, out_hw, generator=g)
        self.evolution = EvolutionOp(cfg, generator=g)
        self.decoder = CNNDecoder(cfg, out_hw, generator=g)

    def forward(self, u: torch.Tensor, static: torch.Tensor, n_steps: int = 1) -> torch.Tensor:
        z, zs = self.encode(u, static)
        outs = []
        for _ in range(n_steps):
            z = self.evolution(z, zs)
            outs.append(self.decoder(z))
        return torch.stack(outs, dim=1)

    def encode(self, u: torch.Tensor, static: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(u), self.static_encoder(static)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def flax_mapping(self) -> Iterator[tuple[tuple[str, ...], str, object]]:
        def dense(fp, pk):
            yield fp + ("Dense_0", "kernel"), pk + ".weight", None
            yield fp + ("Dense_0", "bias"), pk + ".bias", None

        def convs(fp, pk, module, cls, transform):
            for k in range(len(module)):
                yield (fp, f"{cls}_{k}", "kernel"), f"{pk}.convs.{k}.weight", transform
                yield (fp, f"{cls}_{k}", "bias"), f"{pk}.convs.{k}.bias", None

        for fp, pk in (("encoder", "encoder"), ("static_encoder", "static_encoder")):
            yield from convs(fp, pk, getattr(self, pk).convs, "Conv", hwio_to_oihw)
            yield from dense((fp, "Dense_0"), pk + ".dense")
        for k in range(3):
            yield from dense(("evolution", f"Dense_{k}"), f"evolution.denses.{k}")
        yield from dense(("decoder", "Dense_0"), "decoder.dense")
        yield from convs("decoder", "decoder", self.decoder.convs, "ConvTranspose", flip_convT2d)


def lepde_loss(model: LEPDE, u0: torch.Tensor, static: torch.Tensor, targets: torch.Tensor,
               multi_step_dict: Optional[dict] = None, loss_type: str = "mse") -> torch.Tensor:
    """Prediction + 0.1 reconstruction + 0.1 latent consistency.
    targets [B, K, C, H, W]. ``multi_step_dict`` ({step: weight}) weights
    the prediction loss per rollout step; None = uniform MSE over all K."""
    z0, zs = model.encode(u0, static)
    loss_recon = (model.decode(z0) - u0).square().mean()
    preds = model(u0, static, targets.shape[1])
    if multi_step_dict is None:
        loss_pred = (preds - targets).square().mean()
    else:
        loss_pred = sum(w * loss_core(preds[:, k - 1], targets[:, k - 1], loss_type)
                        for k, w in multi_step_dict.items()) / sum(multi_step_dict.values())
    z_t, _ = model.encode(targets[:, 0], static)
    loss_latent = (model.evolution(z0, zs) - z_t).square().mean()
    return loss_pred + 0.1 * loss_recon + 0.1 * loss_latent
