"""TemporalUnet1D, the n-body trajectory denoiser, and the Flax weight loader.

Port of ``cindm_tpu/models/unet1d.py``: ResidualTemporalBlock stacks with
linear attention over time and horizon-aware down/upsampling. Layout is
channel-last [B, horizon, transition_dim].

Submodules of each kind are kept in flat ``ModuleList``s in call order
(``rtbs``, ``attns``, ``downs``, ``ups``), which is the order Flax numbers
its auto-named children ``{Class}_{i}`` in; ``params_from_flax`` relies on it.

``params_from_flax`` / ``flax_from_params`` move the weights of any port
model that names its parameters' Flax key-paths in a ``flax_mapping()``
method: TemporalUnet1D here, ``Unet1D``, ``Unet1DForwardModel``,
``GNSNet``, ``Unet2D`` and ``ForceUnet`` beside it.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.persist import parse_keypath
from .blocks import (
    Conv1d,
    Conv1dBlock,
    Dense,
    Downsample1d,
    LinearAttentionTemporal,
    PreNormResidual,
    ResidualTemporalBlock,
    SinusoidalPosEmb,
    Upsample1d,
    mish,
)


def _stage_flags(horizon: int, num_resolutions: int) -> tuple[list[bool], list[bool]]:
    """Per-stage (down, up) sampling flags: stages are skipped so that short
    horizons divide evenly. Returns (down_flags[num_res], up_flags[num_res-1])."""
    if horizon % 8 == 0:
        down_last = num_resolutions - 1
        up_skip = ()
    elif horizon % 4 == 0:
        down_last = num_resolutions - 2
        up_skip = (0,)
    elif horizon % 2 == 0:
        down_last = num_resolutions - 3
        up_skip = (0, 1)
    else:
        raise ValueError(f"horizon {horizon} must be divisible by 2")
    downs = [ind < down_last for ind in range(num_resolutions)]
    ups = [ind not in up_skip for ind in range(num_resolutions - 1)]
    return downs, ups


class TemporalUnet1D(nn.Module):
    """Temporal U-Net over [B, horizon, transition_dim].

    On CUDA tensors its 16 ResidualTemporalBlocks run through the fused-RTB
    kernel and the head Conv1dBlock through the Conv1d+GN+Mish kernel, with a
    recompute backward when autograd needs their gradient;
    ``forward(..., use_kernels=False)`` runs their plain versions instead.
    Weights are drawn from ``generator`` (a seed-0 CPU generator if None).
    """

    def __init__(self, horizon: int, transition_dim: int, dim: int = 64,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), attention: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.horizon, self.transition_dim, self.dim = horizon, transition_dim, dim
        self.attention = attention
        dims = [transition_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.num_res = len(in_out)
        self.down_flags, self.up_flags = _stage_flags(horizon, self.num_res)

        self.time_pos = SinusoidalPosEmb(dim)
        self.time_mlp = nn.ModuleList([Dense(dim, dim * 4, generator=g), Dense(dim * 4, dim, generator=g)])
        rtbs, attns, downs, ups = [], [], [], []

        def attn(d):
            if attention:
                attns.append(PreNormResidual(d, LinearAttentionTemporal(d, generator=g)))

        for ind, (d_in, d_out) in enumerate(in_out):
            rtbs += [ResidualTemporalBlock(d_in, d_out, dim, generator=g),
                     ResidualTemporalBlock(d_out, d_out, dim, generator=g)]
            attn(d_out)
            if self.down_flags[ind]:
                downs.append(Downsample1d(d_out, generator=g))
        mid = dims[-1]
        rtbs.append(ResidualTemporalBlock(mid, mid, dim, generator=g))
        attn(mid)
        rtbs.append(ResidualTemporalBlock(mid, mid, dim, generator=g))
        # up path over reversed(in_out[1:]); the first skip (stage 0) is unused
        for ind, (d_in, d_out) in enumerate(reversed(in_out[1:])):
            rtbs += [ResidualTemporalBlock(d_out * 2, d_out, dim, generator=g),
                     ResidualTemporalBlock(d_out, d_in, dim, generator=g)]
            attn(d_in)
            if self.up_flags[ind]:
                ups.append(Upsample1d(d_in, generator=g))
        self.rtbs = nn.ModuleList(rtbs)
        self.attns = nn.ModuleList(attns)
        self.downs = nn.ModuleList(downs)
        self.ups = nn.ModuleList(ups)
        self.final_block = Conv1dBlock(dim, dim, kernel_size=5, generator=g)
        self.final_conv = Conv1d(dim, transition_dim, 1, generator=g)

    def forward(self, x: torch.Tensor, time: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        """x: [B, horizon, transition_dim]; time: [B] timesteps."""
        x = x.contiguous()
        t = self.time_pos(time)
        t = self.time_mlp[1](mish(self.time_mlp[0](t)))
        rtb, attn = iter(self.rtbs), iter(self.attns)
        down, up = iter(self.downs), iter(self.ups)

        hs = []
        for ind in range(self.num_res):
            x = next(rtb)(x, t, use_kernels)
            x = next(rtb)(x, t, use_kernels)
            if self.attention:
                x = next(attn)(x)
            hs.append(x)
            if self.down_flags[ind]:
                x = next(down)(x)
        x = next(rtb)(x, t, use_kernels)
        if self.attention:
            x = next(attn)(x)
        x = next(rtb)(x, t, use_kernels)
        for ind in range(self.num_res - 1):
            x = torch.cat([x, hs.pop()], dim=-1)
            x = next(rtb)(x, t, use_kernels)
            x = next(rtb)(x, t, use_kernels)
            if self.attention:
                x = next(attn)(x)
            if self.up_flags[ind]:
                x = next(up)(x)
        x = self.final_block(x, use_kernels)
        return self.final_conv(x)

    def flax_mapping(self) -> Iterator[tuple[tuple[str, ...], str, Any]]:
        return _flax_mapping(self)


# ---------------------------------------------------------------------------
# Flax parameters -> state_dict


def _flip_convT(w: np.ndarray) -> np.ndarray:
    """Flax ConvTranspose kernel [K, C, O] -> torch [C, O, K], flipped along K."""
    return np.ascontiguousarray(np.transpose(w[::-1], (1, 2, 0)))


def hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    """Flax Conv kernel [kh, kw, C_in, C_out] -> torch [C_out, C_in, kh, kw]."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def flip_convT2d(w: np.ndarray) -> np.ndarray:
    """Flax ConvTranspose kernel [kh, kw, C_in, C_out] -> torch
    ``conv_transpose2d`` weight [C_in, C_out, kh, kw], flipped along kh and kw."""
    return np.ascontiguousarray(np.transpose(w[::-1, ::-1], (2, 3, 0, 1)))


def _unflip_convT2d(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


def _dense(fp, pk, bias=True):
    yield fp + ("Dense_0", "kernel"), pk + "weight", None
    if bias:
        yield fp + ("Dense_0", "bias"), pk + "bias", None


def _conv(fp, pk):
    yield fp + ("Conv_0", "kernel"), pk + "weight", None
    yield fp + ("Conv_0", "bias"), pk + "bias", None


def _conv_block(fp, pk):
    yield from _conv(fp + ("Conv1d_0",), pk + "conv.")
    yield fp + ("GroupNorm_0", "GroupNorm_0", "scale"), pk + "norm.weight", None
    yield fp + ("GroupNorm_0", "GroupNorm_0", "bias"), pk + "norm.bias", None


def _prenorm_attention(pre: str, attn: str, pk: str):
    """The gain of PreNormResidual ``pre`` and the attention module ``attn``
    it wraps, a sibling in Flax's naming (the parent builds it)."""
    yield (pre, "ChannelLayerNorm_0", "g"), pk + "norm.g", None
    yield from _dense((attn, "Dense_0"), pk + "fn.qkv.", bias=False)
    yield from _dense((attn, "Dense_1"), pk + "fn.out.")
    if attn.startswith("LinearAttention_"):
        yield (attn, "ChannelLayerNorm_0", "g"), pk + "fn.norm.g", None


class FlaxNames:
    """Flax's auto-names in one scope: ``FlaxNames()("Dense")`` gives
    Dense_0, then Dense_1, ...; one counter per class."""

    def __init__(self):
        self.count: dict[str, int] = {}

    def __call__(self, cls: str) -> str:
        i = self.count.get(cls, 0)
        self.count[cls] = i + 1
        return f"{cls}_{i}"


def _flax_mapping(model: TemporalUnet1D) -> Iterator[tuple[tuple[str, ...], str, Any]]:
    """(Flax key-path, state_dict key, transform or None) for every parameter."""
    yield from _dense(("Dense_0",), "time_mlp.0.")
    yield from _dense(("Dense_1",), "time_mlp.1.")
    for k, m in enumerate(model.rtbs):
        fp, pk = (f"ResidualTemporalBlock_{k}",), f"rtbs.{k}."
        yield from _conv_block(fp + ("Conv1dBlock_0",), pk + "block0.")
        yield from _conv_block(fp + ("Conv1dBlock_1",), pk + "block1.")
        yield from _dense(fp + ("Dense_0",), pk + "time.")
        if m.residual is not None:
            yield from _conv(fp + ("Conv1d_0",), pk + "residual.")
    for k in range(len(model.attns)):
        yield from _prenorm_attention(f"PreNormResidual_{k}", f"LinearAttentionTemporal_{k}",
                                      f"attns.{k}.")
    for k in range(len(model.downs)):
        yield from _conv((f"Downsample1d_{k}", "Conv1d_0"), f"downs.{k}.conv.")
    for k in range(len(model.ups)):
        yield (f"Upsample1d_{k}", "ConvTranspose_0", "kernel"), f"ups.{k}.weight", _flip_convT
        yield (f"Upsample1d_{k}", "ConvTranspose_0", "bias"), f"ups.{k}.bias", None
    yield from _conv_block(("Conv1dBlock_0",), "final_block.")
    yield from _conv(("Conv1d_0",), "final_conv.")


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], Any]:
    flat = {}
    for k, v in tree.items():
        path = prefix + (parse_keypath(k) if k.startswith("[") else (k,))
        if isinstance(v, Mapping):
            flat.update(_flatten(v, path))
        else:
            flat[path] = v
    return flat


def params_from_flax(tree: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """State dict for ``model`` from the JAX package's parameters of the same
    model (a TemporalUnet1D, Unet1D, Unet1DForwardModel, GNSNet, Unet2D,
    ForceUnet, FNO1d, FNO2d or LEPDE).

    ``tree`` is the Flax parameter tree as numpy arrays: nested dicts, or a
    flat dict keyed by key-path strings such as ``"['Dense_0']['Dense_0']['kernel']"``
    (a ``load_flax_npz`` result narrowed with ``select_subtree``), optionally
    under a leading ``params`` level. Raises, naming the key-paths, on any
    Flax key that maps to nothing, any missing key and any shape mismatch.
    """
    flat = _flatten(tree)
    if flat and all(p[0] == "params" for p in flat):
        flat = {p[1:]: v for p, v in flat.items()}
    want = model.state_dict()
    out, missing, mismatched, used = {}, [], [], set()
    for fp, pk, transform in model.flax_mapping():
        if fp not in flat:
            missing.append(str(list(fp)))
            continue
        used.add(fp)
        arr = np.asarray(flat[fp], dtype=np.float32)
        if transform is not None:
            arr = transform(arr)
        if tuple(arr.shape) != tuple(want[pk].shape):
            mismatched.append(f"{list(fp)}: {tuple(arr.shape)} vs {pk} {tuple(want[pk].shape)}")
            continue
        out[pk] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    unused = sorted(str(list(p)) for p in set(flat) - used)
    if missing or mismatched or unused:
        raise ValueError(
            f"Flax parameters do not match this {type(model).__name__} "
            "(wrong --Unet_dim/--horizon?). "
            f"missing: {missing[:5] or 'none'}; shape mismatches: {mismatched[:5] or 'none'}; "
            f"unconsumed: {unused[:5] or 'none'}"
        )
    return out


def _unflip_convT(w: np.ndarray) -> np.ndarray:
    """Inverse of ``_flip_convT``: torch [C, O, K] -> Flax [K, C, O]."""
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1))[::-1])


def flax_from_params(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's parameters as the JAX package's Flax tree, flattened to
    key-path strings (``"['Dense_0']['Dense_0']['kernel']"``); the inverse
    of ``params_from_flax``."""
    inverse = {_flip_convT: _unflip_convT, hwio_to_oihw: _oihw_to_hwio,
               flip_convT2d: _unflip_convT2d}
    sd = model.state_dict()
    out = {}
    for fp, pk, transform in model.flax_mapping():
        arr = sd[pk].detach().cpu().numpy()
        if transform is not None:
            arr = inverse[transform](arr)
        out["".join(f"['{p}']" for p in fp)] = arr
    return out
