"""2D airfoil denoiser and differentiable force surrogate.

Port of ``cindm_tpu/models/unet2d.py``:

- ``Unet2D``: DDPM U-Net over 64 x 64 images, weight-standardized 3x3
  convs + GroupNorm + SiLU with a FiLM time scale/shift, linear attention
  at every resolution, pixel-unshuffle downsampling, full attention in the
  middle. Airfoil configuration: dim 64, dim_mults (1, 2), 21 channels.
- ``ForceUnet``: the encoder, a global mean pool and Dense(2) predicting
  (drag, lift) from [pressure, mask, offx, offy].

Both take NCHW input (PyTorch's layout); channel c is channel c of the JAX
package's NHWC tensor. Conv weights are stored OIHW; Dense weights keep the
JAX package's [in, out] layout (``blocks.Dense``). Every draw of the
initialisation comes from the ``torch.Generator`` the caller passes.

``flax_mapping()`` names each parameter's Flax key-path, so
``models.params_from_flax`` / ``flax_from_params`` move the weights of
either model between the packages. Flax numbers children per class in call
order (``ResnetBlock2D_k``, ``PreNormResidual2D_k`` are explicit names in
``Unet2D``); the attention a ``PreNormResidual2D`` wraps is built in its
parent's scope, so it is a sibling there (``LinearAttention2D_k``,
``Attention2D_k``). The modules here are built in that call order and
record their Flax names as they are built.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import ChannelLayerNorm, Dense, FullAttention, SinusoidalPosEmb, _uniform
from .unet1d import FlaxNames, hwio_to_oihw

__all__ = [
    "Attention2D",
    "Block2D",
    "Conv2d",
    "Downsample2D",
    "ForceUnet",
    "LinearAttention2D",
    "PreNormResidual2D",
    "ResnetBlock2D",
    "Unet2D",
    "Upsample2D",
    "WSConv2d",
]


class Conv2d(nn.Module):
    """Conv with "SAME" padding (odd kernels); weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, *, use_bias: bool = True,
                 generator: torch.Generator):
        super().__init__()
        fan_in = in_ch * kernel_size ** 2
        self.weight = _uniform((out_ch, in_ch, kernel_size, kernel_size), fan_in, generator)
        self.bias = _uniform((out_ch,), fan_in, generator) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, padding=self.weight.shape[-1] // 2)


class WSConv2d(Conv2d):
    """Weight-standardized conv: the kernel is standardized over (in, kh, kw)
    per output channel (biased variance, eps 1e-5) before the conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, eps: float = 1e-5, *,
                 generator: torch.Generator):
        super().__init__(in_ch, out_ch, kernel_size, generator=generator)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = (w - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        w = (w - mean) * torch.rsqrt(var + self.eps)
        return F.conv2d(x, w, self.bias, padding=w.shape[-1] // 2)


class Block2D(nn.Module):
    """WSConv 3x3 -> GroupNorm(groups) -> x (scale + 1) + shift -> SiLU."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 8, *, generator: torch.Generator):
        super().__init__()
        self.conv = WSConv2d(in_ch, out_ch, 3, generator=generator)
        self.norm = nn.GroupNorm(groups, out_ch, eps=1e-5)

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        x = self.norm(self.conv(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock2D(nn.Module):
    """Two Block2Ds, the first with the time embedding's scale/shift, plus a
    1x1 residual conv where the channel count changes."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 8, time_dim: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.time = Dense(time_dim, out_ch * 2, generator=generator) if time_dim else None
        self.block0 = Block2D(in_ch, out_ch, groups, generator=generator)
        self.block1 = Block2D(out_ch, out_ch, groups, generator=generator)
        self.residual = Conv2d(in_ch, out_ch, 1, generator=generator) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale_shift = None
        if self.time is not None and t_emb is not None:
            scale_shift = self.time(F.silu(t_emb))[:, :, None, None].chunk(2, dim=1)
        h = self.block1(self.block0(x, scale_shift))
        return h + (x if self.residual is None else self.residual(x))


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def _image(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, H*W, C] -> [B, C, H, W]."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], H, W)


class LinearAttention2D(nn.Module):
    """Linear attention over the H*W tokens: q softmaxed per head over its
    channels, k over the tokens, v divided by H*W; Dense out, then a
    ChannelLayerNorm."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.qkv = Dense(dim, hidden * 3, use_bias=False, generator=generator)
        self.out = Dense(hidden, dim, generator=generator)
        self.norm = ChannelLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        N = H * W
        split = lambda a: a.reshape(B, N, self.heads, self.dim_head)
        q, k, v = map(split, self.qkv(_tokens(x)).chunk(3, dim=-1))
        q = torch.softmax(q, dim=-1) * (self.dim_head ** -0.5)
        k = torch.softmax(k, dim=1)
        v = v / N
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bnhd,bhde->bnhe", q, context).reshape(B, N, -1)
        return _image(self.norm(self.out(out)), H, W)


class Attention2D(nn.Module):
    """Full softmax attention over the H*W tokens (``blocks.FullAttention``)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, *,
                 generator: torch.Generator):
        super().__init__()
        self.attn = FullAttention(dim, heads, dim_head, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _image(self.attn(_tokens(x)), *x.shape[2:])


class PreNormResidual2D(nn.Module):
    """fn(ChannelLayerNorm over channels(x)) + x."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return self.fn(normed) + x


class Downsample2D(nn.Module):
    """Pixel-unshuffle (channel c*4 + dh*2 + dw) + 1x1 conv."""

    def __init__(self, in_ch: int, out_ch: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv2d(in_ch * 4, out_ch, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pixel_unshuffle(x, 2))


class Upsample2D(nn.Module):
    """Nearest x2 (each pixel repeated along H and W) + 3x3 conv."""

    def __init__(self, in_ch: int, out_ch: int, *, generator: torch.Generator):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class _FlaxNamed(nn.Module):
    """Builds children in Flax's call order and records the Flax name of
    each top-level one (``self.flax_names``: port prefix -> Flax name)."""

    def __init__(self):
        super().__init__()
        self.names = FlaxNames()
        self.flax_names: dict[str, str] = {}

    def _named(self, prefix: str, module: nn.Module, flax_name: Optional[str] = None) -> nn.Module:
        cls = type(module).__name__
        self.flax_names[prefix] = flax_name or self.names(cls)
        return module

    def _stage(self, dims: list[int], time_dim: Optional[int], groups: int, explicit: bool,
               g: torch.Generator):
        """The encoder: per stage two ResnetBlock2Ds, a linear-attention
        residual, then Downsample2D (a 3x3 Conv2d at the last stage)."""
        rbs, pns, downs = [], [], []

        def rb(d_in, d_out):
            k = len(rbs)
            rbs.append(self._named(f"rbs.{k}", ResnetBlock2D(d_in, d_out, groups, time_dim, generator=g),
                                   f"ResnetBlock2D_{k}" if explicit else None))
            return d_out

        def pn(d, fn):
            k = len(pns)
            self._named(f"pns.{k}.fn", fn)
            pns.append(self._named(f"pns.{k}", PreNormResidual2D(d, fn),
                                   f"PreNormResidual2D_{k}" if explicit else None))

        in_out = list(zip(dims[:-1], dims[1:]))
        for ind, (d_in, d_out) in enumerate(in_out):
            rb(d_in, d_in)
            rb(d_in, d_in)
            pn(d_in, LinearAttention2D(d_in, generator=g))
            down = (Downsample2D(d_in, d_out, generator=g) if ind < len(in_out) - 1
                    else Conv2d(d_in, d_out, 3, generator=g))
            downs.append(self._named(f"downs.{ind}", down))
        mid = dims[-1]
        rb(mid, mid)
        pn(mid, Attention2D(mid, generator=g))
        rb(mid, mid)
        return rbs, pns, downs, rb, pn

    def flax_mapping(self) -> Iterator[tuple[tuple[str, ...], str, object]]:
        for prefix, flax_name in self.flax_names.items():
            yield from _mapping(self.get_submodule(prefix), (flax_name,), prefix + ".")


class Unet2D(_FlaxNamed):
    """DDPM 2D U-Net; ``forward(x [B, C, H, W], time [B]) -> [B, out, H, W]``.

    ``remat=True`` checkpoints each ResnetBlock2D and each attention
    residual (``torch.utils.checkpoint``, the JAX package's ``nn.remat``)
    while grad is enabled: the backward pass keeps only the blocks' inputs
    and recomputes their interiors, which lowers a training step's peak
    memory. The parameters are the same either way."""

    def __init__(self, dim: int = 64, dim_mults: Sequence[int] = (1, 2), channels: int = 21,
                 out_dim: Optional[int] = None, resnet_block_groups: int = 8, remat: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        groups = resnet_block_groups
        self.channels, self.remat = channels, remat
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        self.init_conv = self._named("init_conv", Conv2d(channels, dim, 7, generator=g))
        self.time_pos = SinusoidalPosEmb(dim)
        self.time_mlp = nn.ModuleList([Dense(dim, time_dim, generator=g),
                                       Dense(time_dim, time_dim, generator=g)])
        self._named("time_mlp.0", self.time_mlp[0])
        self._named("time_mlp.1", self.time_mlp[1])
        rbs, pns, downs, rb, pn = self._stage(dims, time_dim, groups, True, g)
        ups = []
        for ind, (d_in, d_out) in enumerate(reversed(in_out)):
            rb(d_out + d_in, d_out)
            rb(d_out + d_in, d_out)
            pn(d_out, LinearAttention2D(d_out, generator=g))
            up = (Upsample2D(d_out, d_in, generator=g) if ind < len(in_out) - 1
                  else Conv2d(d_out, d_in, 3, generator=g))
            ups.append(self._named(f"ups.{ind}", up))
        rb(dim * 2, dim)
        self.rbs, self.pns = nn.ModuleList(rbs), nn.ModuleList(pns)
        self.downs, self.ups = nn.ModuleList(downs), nn.ModuleList(ups)
        self.final_conv = self._named("final_conv", Conv2d(dim, out_dim or channels, 1, generator=g))
        self.num_res = len(in_out)

    def forward(self, x: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        x = self.init_conv(x)
        r = x
        t = self.time_pos(time)
        t = self.time_mlp[1](F.gelu(self.time_mlp[0](t)))
        remat = self.remat and torch.is_grad_enabled()

        def blocks(modules):
            for m in modules:
                yield (lambda *a, m=m: checkpoint(m, *a, use_reentrant=False)) if remat else m

        rb, pn = blocks(self.rbs), blocks(self.pns)
        hs = []
        for down in self.downs:
            x = next(rb)(x, t)
            hs.append(x)
            x = next(pn)(next(rb)(x, t))
            hs.append(x)
            x = down(x)
        x = next(rb)(x, t)
        x = next(pn)(x)
        x = next(rb)(x, t)
        for up in self.ups:
            x = next(rb)(torch.cat([x, hs.pop()], dim=1), t)
            x = next(rb)(torch.cat([x, hs.pop()], dim=1), t)
            x = up(next(pn)(x))
        x = next(rb)(torch.cat([x, r], dim=1), t)
        return self.final_conv(x)


class ForceUnet(_FlaxNamed):
    """Encoder-only U-Net -> global mean pool -> Dense(2):
    ``forward(x [B, 4, H, W]) -> [B, 2]`` (drag, lift)."""

    def __init__(self, dim: int = 64, dim_mults: Sequence[int] = (1, 2, 4, 8),
                 resnet_block_groups: int = 8, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        dims = [dim] + [dim * m for m in dim_mults]
        self.init_conv = self._named("init_conv", Conv2d(4, dim, 7, generator=g))
        rbs, pns, downs, _, _ = self._stage(dims, None, resnet_block_groups, False, g)
        self.rbs, self.pns, self.downs = nn.ModuleList(rbs), nn.ModuleList(pns), nn.ModuleList(downs)
        self.head = self._named("head", Dense(dims[-1], 2, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.init_conv(x)
        rb, pn = iter(self.rbs), iter(self.pns)
        for down in self.downs:
            x = next(rb)(x)
            x = next(rb)(x)
            x = down(next(pn)(x))
        x = next(rb)(x)
        x = next(pn)(x)
        x = next(rb)(x)
        return self.head(x.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# Flax key-paths of each module's parameters


def _mapping(m: nn.Module, fp: tuple[str, ...], pk: str):
    """(Flax key-path, state_dict key, transform) of ``m``'s own parameters,
    ``m`` being named ``fp`` in Flax and ``pk`` in the state dict."""
    if isinstance(m, WSConv2d):
        yield fp + ("kernel",), pk + "weight", hwio_to_oihw
        yield fp + ("bias",), pk + "bias", None
    elif isinstance(m, Conv2d):
        yield fp + ("Conv_0", "kernel"), pk + "weight", hwio_to_oihw
        if m.bias is not None:
            yield fp + ("Conv_0", "bias"), pk + "bias", None
    elif isinstance(m, Dense):
        yield fp + ("Dense_0", "kernel"), pk + "weight", None
        if m.bias is not None:
            yield fp + ("Dense_0", "bias"), pk + "bias", None
    elif isinstance(m, Block2D):
        yield from _mapping(m.conv, fp + ("WSConv2d_0",), pk + "conv.")
        yield fp + ("GroupNorm_0", "scale"), pk + "norm.weight", None
        yield fp + ("GroupNorm_0", "bias"), pk + "norm.bias", None
    elif isinstance(m, ResnetBlock2D):
        if m.time is not None:
            yield from _mapping(m.time, fp + ("Dense_0",), pk + "time.")
        yield from _mapping(m.block0, fp + ("Block2D_0",), pk + "block0.")
        yield from _mapping(m.block1, fp + ("Block2D_1",), pk + "block1.")
        if m.residual is not None:
            yield from _mapping(m.residual, fp + ("Conv2d_0",), pk + "residual.")
    elif isinstance(m, LinearAttention2D):
        yield from _mapping(m.qkv, fp + ("Dense_0",), pk + "qkv.")
        yield from _mapping(m.out, fp + ("Dense_1",), pk + "out.")
        yield fp + ("ChannelLayerNorm_0", "g"), pk + "norm.g", None
    elif isinstance(m, Attention2D):
        yield from _mapping(m.attn.qkv, fp + ("FullAttention_0", "Dense_0"), pk + "attn.qkv.")
        yield from _mapping(m.attn.out, fp + ("FullAttention_0", "Dense_1"), pk + "attn.out.")
    elif isinstance(m, PreNormResidual2D):
        # its fn is a sibling in Flax, mapped under its own name
        yield fp + ("ChannelLayerNorm_0", "g"), pk + "norm.g", None
    elif isinstance(m, (Downsample2D, Upsample2D)):
        yield from _mapping(m.conv, fp + ("Conv2d_0",), pk + "conv.")
    else:
        raise TypeError(f"no Flax mapping for {type(m).__name__}")
