"""Fused ResidualTemporalBlock (forward).

Port of ``cindm_tpu/ops/fused_rtb.py``: the whole block

    h   = Mish(GN(conv5(x) + b1))
    h  += temb[:, None, :]          # temb = Dense(mish(t_emb)), projected outside
    h   = Mish(GN(conv5(h) + b2))
    out = h + (x @ wres + bres | x)

in one launch of ``csrc/fused_rtb.cu`` for CUDA tensors, so neither
intermediate nor the residual goes back to device memory. CPU tensors use
``fused_rtb_reference``. The backward pass (the JAX package's custom VJP)
belongs to the training slice; sampling never differentiates the denoiser.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_conv_gn import fused_conv1d_gn_mish_reference


def fused_rtb_reference(
    x: torch.Tensor,  # [B, T, C]
    temb: torch.Tensor,  # [B, O], already Dense(mish(t_emb))
    w1: torch.Tensor,  # [K, C, O]
    b1: torch.Tensor,
    gs1: torch.Tensor,
    gb1: torch.Tensor,
    w2: torch.Tensor,  # [K, O, O]
    b2: torch.Tensor,
    gs2: torch.Tensor,
    gb2: torch.Tensor,
    wres: torch.Tensor | None = None,  # [C, O] 1x1 residual (None => identity)
    bres: torch.Tensor | None = None,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version: two Conv1d+GN+Mish with the temb add and the residual."""
    h = fused_conv1d_gn_mish_reference(x, w1, b1, gs1, gb1, groups, eps)
    h = h + temb[:, None, :]
    h = fused_conv1d_gn_mish_reference(h, w2, b2, gs2, gb2, groups, eps)
    res = x if wres is None else torch.matmul(x, wres) + bres
    return h + res


def fused_rtb(
    x: torch.Tensor,
    temb: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    gs1: torch.Tensor,
    gb1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gs2: torch.Tensor,
    gb2: torch.Tensor,
    wres: torch.Tensor | None = None,
    bres: torch.Tensor | None = None,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """ResidualTemporalBlock: the CUDA kernel on CUDA tensors, plain on CPU."""
    B, T, C = x.shape
    K, _, O = w1.shape
    if O % groups:
        raise ValueError(f"fused_rtb: O={O} not divisible by groups={groups}")
    if (wres is None) != (bres is None):
        raise ValueError("fused_rtb: pass both wres and bres, or neither")
    if wres is None and C != O:
        raise ValueError(f"fused_rtb: identity residual needs C == O, got {C} -> {O}")
    vec = (O,)
    shapes = dict(
        x=(x, (B, T, C)), temb=(temb, (B, O)), w1=(w1, (K, C, O)), b1=(b1, vec),
        gs1=(gs1, vec), gb1=(gb1, vec), w2=(w2, (K, O, O)), b2=(b2, vec),
        gs2=(gs2, vec), gb2=(gb2, vec),
    )
    if wres is not None:
        shapes.update(wres=(wres, (C, O)), bres=(bres, vec))
    _build.check_inputs("fused_rtb", x.device, **shapes)
    if x.device.type == "cpu":
        return fused_rtb_reference(
            x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, groups, eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_rtb: unsupported device {x.device}")
    _build.check_channels("fused_rtb", C=C, O=O)
    lib = _build.load()
    out = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.cindm_fused_rtb(
            *map(_build.ptr, (x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, out)),
            B, T, C, O, K, groups, eps, _build.stream_of(x),
        )
    _build.raise_on_error("fused_rtb", err)
    fused_rtb.launches += 1
    return out


fused_rtb.launches = 0  # kernel launches; the CPU path does not count
