"""FNO: Fourier Neural Operator surrogates (1D and 2D).

Port of ``cindm_tpu/baselines/fno.py``. The JAX package computes the
spectral convolution as a truncated real DFT (its TPU had no complex
arithmetic); here it is ``torch.fft`` on the kept modes, which computes the
same function: the forward transform keeps rows [:m1] and [-m1:] and
columns [:m2] of ``rfft2``, each block is multiplied by its complex weight,
and the inverse is ``ifft`` over rows then ``irfft`` over columns, which
counts each kept column ky > 0 twice (its Hermitian mirror) and the
column ky = 0 (and W/2) once, by its real part, as the JAX form's weights
``a = 1 or 2`` do.

Layouts: the models take NCHW (NCL in 1D); channel c is channel c of the
JAX package's channel-last tensor. The weights keep the JAX layout:
``w_real``, ``w_imag`` [2, C, O, m1, m2] (2D; the first axis is the
[:m1] / [-m1:] row block) and [C, O, m] (1D); Dense weights [in, out].
``flax_mapping()`` names each parameter's Flax key-path, so
``models.params_from_flax`` / ``flax_from_params`` move them between the
packages. Flax's ``gelu`` is the tanh approximation, so is the port's.
"""

from __future__ import annotations

from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from ..models.blocks import Dense

__all__ = ["FNO1d", "FNO2d", "SpectralConv1d", "SpectralConv2d"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def channel_dense(dense: Dense, x: torch.Tensor) -> torch.Tensor:
    """A Dense over the channel axis (dim 1) of [B, C, *spatial]."""
    y = torch.movedim(torch.movedim(x, 1, -1) @ dense.weight, -1, 1)
    if dense.bias is None:
        return y
    return y + dense.bias.reshape(-1, *([1] * (x.ndim - 2)))


def _spectral_weight(shape, scale: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(scale * torch.rand(shape, generator=generator))


def _real_bins(z: torch.Tensor, n: int) -> torch.Tensor:
    """The kept columns of a one-sided spectrum over the last axis, with the
    imaginary part of the DC (and Nyquist) bin dropped: a real inverse
    counts those bins by their real part alone."""
    dc = z[..., :1].real.to(z.dtype)
    if n % 2 == 0 and z.shape[-1] > n // 2:
        nyq = z[..., n // 2:n // 2 + 1].real.to(z.dtype)
        return torch.cat([dc, z[..., 1:n // 2], nyq, z[..., n // 2 + 1:]], dim=-1)
    return torch.cat([dc, z[..., 1:]], dim=-1)


class SpectralConv2d(nn.Module):
    """Low-mode spectral convolution over [B, C, H, W] -> [B, O, H, W]."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int = 12, modes2: int = 12, *,
                 generator: torch.Generator):
        super().__init__()
        self.modes1, self.modes2 = modes1, modes2
        shape = (2, in_channels, out_channels, modes1, modes2)
        scale = 1.0 / (in_channels * out_channels)
        self.w_real = _spectral_weight(shape, scale, generator)
        self.w_imag = _spectral_weight(shape, scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        m1, m2 = self.modes1, self.modes2
        w = torch.complex(self.w_real, self.w_imag)
        x_ft = torch.fft.rfft2(x)  # [B, C, H, W//2 + 1]
        top = torch.einsum("bcxy,coxy->boxy", x_ft[:, :, :m1, :m2], w[0])
        bot = torch.einsum("bcxy,coxy->boxy", x_ft[:, :, H - m1:, :m2], w[1])
        mid = top.new_zeros((B, w.shape[2], H - 2 * m1, m2))
        z = torch.fft.ifft(torch.cat([top, mid, bot], dim=2), dim=2)  # [B, O, H, m2]
        # irfft zero-pads the m2 kept columns to W//2 + 1
        return torch.fft.irfft(_real_bins(z, W), n=W, dim=3)


class SpectralConv1d(nn.Module):
    """1D low-mode spectral convolution over [B, C, L] -> [B, O, L]."""

    def __init__(self, in_channels: int, out_channels: int, modes: int = 16, *,
                 generator: torch.Generator):
        super().__init__()
        self.modes = modes
        shape = (in_channels, out_channels, modes)
        scale = 1.0 / (in_channels * out_channels)
        self.w_real = _spectral_weight(shape, scale, generator)
        self.w_imag = _spectral_weight(shape, scale, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[-1]
        m = self.modes
        x_ft = torch.fft.rfft(x)  # [B, C, L//2 + 1]
        z = torch.einsum("bck,cok->bok", x_ft[:, :, :m], torch.complex(self.w_real, self.w_imag))
        return torch.fft.irfft(_real_bins(z, L), n=L, dim=2)


class _FNO(nn.Module):
    """Lift (the input with its linspace(0, 1) grids appended) -> n_layers of
    spectral conv + 1x1 bypass, GELU between them -> Dense(128) -> GELU ->
    Dense(out)."""

    def __init__(self, spectral, in_channels: int, out_channels: int, width: int, n_layers: int,
                 n_grids: int, generator: torch.Generator):
        super().__init__()
        g = generator
        self.lift = Dense(in_channels + n_grids, width, generator=g)
        self.spectral = nn.ModuleList()
        self.bypass = nn.ModuleList()
        for _ in range(n_layers):  # Flax's call order: SpectralConv_k, then its Dense
            self.spectral.append(spectral(width, width, generator=g))
            self.bypass.append(Dense(width, width, generator=g))
        self.fc1 = Dense(width, 128, generator=g)
        self.fc2 = Dense(128, out_channels, generator=g)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = channel_dense(self.lift, x)
        n = len(self.spectral)
        for i, (spec, byp) in enumerate(zip(self.spectral, self.bypass)):
            y = spec(x) + channel_dense(byp, x)
            x = gelu(y) if i < n - 1 else y
        return channel_dense(self.fc2, gelu(channel_dense(self.fc1, x)))

    def flax_mapping(self) -> Iterator[tuple[tuple[str, ...], str, object]]:
        spec = type(self.spectral[0]).__name__
        denses = ["lift"] + [f"bypass.{i}" for i in range(len(self.bypass))] + ["fc1", "fc2"]
        for k, name in enumerate(denses):
            yield (f"Dense_{k}", "Dense_0", "kernel"), name + ".weight", None
            yield (f"Dense_{k}", "Dense_0", "bias"), name + ".bias", None
        for k in range(len(self.spectral)):
            for w in ("w_real", "w_imag"):
                yield (f"{spec}_{k}", w), f"spectral.{k}.{w}", None


class FNO2d(_FNO):
    """[B, in_channels, H, W] -> [B, out_channels, H, W]; the grids appended
    after the input channels are x (along H), then y (along W)."""

    def __init__(self, in_channels: int, out_channels: int, modes: int = 12, width: int = 20,
                 n_layers: int = 4, *, generator: torch.Generator | None = None):
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        spectral = lambda c, o, generator: SpectralConv2d(c, o, modes, modes, generator=generator)
        super().__init__(spectral, in_channels, out_channels, width, n_layers, 2, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        gx = torch.linspace(0, 1, H, device=x.device, dtype=x.dtype)[None, None, :, None]
        gy = torch.linspace(0, 1, W, device=x.device, dtype=x.dtype)[None, None, None, :]
        return self._trunk(torch.cat([x, gx.expand(B, 1, H, W), gy.expand(B, 1, H, W)], dim=1))


class FNO1d(_FNO):
    """[B, in_channels, L] -> [B, out_channels, L], a linspace(0, 1) grid
    appended after the input channels."""

    def __init__(self, in_channels: int, out_channels: int, modes: int = 16, width: int = 64,
                 n_layers: int = 4, *, generator: torch.Generator | None = None):
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        spectral = lambda c, o, generator: SpectralConv1d(c, o, modes, generator=generator)
        super().__init__(spectral, in_channels, out_channels, width, n_layers, 1, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, L = x.shape
        grid = torch.linspace(0, 1, L, device=x.device, dtype=x.dtype)[None, None, :]
        return self._trunk(torch.cat([x, grid.expand(B, 1, L)], dim=1))
