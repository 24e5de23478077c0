"""Fused ResidualTemporalBlock, forward and backward.

Port of ``cindm_tpu/ops/fused_rtb.py``: the whole block

    h   = Mish(GN(conv5(x) + b1))
    h  += temb[:, None, :]          # temb = Dense(mish(t_emb)), projected outside: [B, O],
                                    # its rows may lie further apart (a view of a wider matrix)
    h   = Mish(GN(conv5(h) + b2))
    out = h + (x @ wres + bres | x)

in one call of ``csrc/fused_rtb.cu`` for CUDA tensors: two launches of the
3xTF32 tensor-core stage of ``csrc/conv_gn_mish.cuh`` (persistent CTAs on
the main loop of ``csrc/stage_ring.cuh``, tiled by ``_build.plan_stage``),
the first writing h [B, T, O] to device memory once and the second reading
it, with the 1x1 residual projection inside the second; each launch has its
own plan, whose last, partial wave of tiles is split by K chunks over every
cluster (workspace and counters kept by ``_build.stage_work``). The stage reads
w1, w2 and wres as ``_build.staged`` keeps them laid out (once per weight
version and N tile, those that changed in one launch;
``_build.staged.clear()`` drops them).
``fused_rtb.launches`` counts calls. CPU tensors use
``fused_rtb_reference``.

``fused_rtb`` itself has no autograd history: it raises when a gradient is
wanted. ``fused_rtb_differentiable`` is the port of the JAX package's custom
VJP (``_fused_rtb_cv``, ``cindm_tpu/ops/fused_rtb.py:247-276``) through
``FusedRTB``: its forward is the kernel's saving instance, which also keeps
h, the pre-norm conv outputs z1 and z2 and both GroupNorms' mean and rstd;
its backward is the kernel ``fused_rtb_backward`` (``csrc/block_backward.cu``)
on those, where ``_fused_rtb_cv_bwd`` recomputes the block under jax.vjp.
The plain versions beside them, ``fused_rtb_forward_saving_reference`` and
``fused_rtb_backward_reference`` (closed-form gradients in PyTorch, not
autograd), serve CPU tensors and the comparisons on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from . import _build
from .fused_conv_gn import (
    conv1d_dgrad,
    conv1d_same,
    conv1d_wgrad,
    fused_conv1d_gn_mish_reference,
    gn_mish_backward_reference,
    mish,
    normalize,
    refuse_grad,
)


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


class RTBSaved(NamedTuple):
    """What ``FusedRTB`` keeps for its backward: the twelve inputs, h [B, T,
    O] (the second conv's input), z1 and z2 [B, T, O] (each conv's output
    plus bias, before its GroupNorm) and both GroupNorms' mean and rstd
    [B, G]."""

    x: torch.Tensor
    temb: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    gs1: torch.Tensor
    gb1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    gs2: torch.Tensor
    gb2: torch.Tensor
    wres: torch.Tensor | None
    bres: torch.Tensor | None
    h: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    mean1: torch.Tensor
    rstd1: torch.Tensor
    mean2: torch.Tensor
    rstd2: torch.Tensor


def fused_rtb_forward_saving_reference(
    x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres=None, bres=None,
    groups: int = 8, eps: float = 1e-5,
) -> tuple[torch.Tensor, ...]:
    """Plain version of the saving forward: (out, h, z1, z2, mean1, rstd1,
    mean2, rstd2), out equal to ``fused_rtb_reference``'s bit for bit."""
    z1 = conv1d_same(x, w1, b1)
    yh, mean1, rstd1 = normalize(z1, groups, eps)
    h = mish(yh * gs1 + gb1) + temb[:, None, :]
    z2 = conv1d_same(h, w2, b2)
    yh, mean2, rstd2 = normalize(z2, groups, eps)
    res = x if wres is None else torch.matmul(x, wres) + bres
    return mish(yh * gs2 + gb2) + res, h, z1, z2, mean1, rstd1, mean2, rstd2


def fused_rtb_backward_reference(
    saved: Sequence[torch.Tensor | None], g: torch.Tensor, needs: Sequence[bool],
) -> list[torch.Tensor | None]:
    """Plain version of ``fused_rtb_backward``: the cotangents of the twelve
    inputs (x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres) from
    ``RTBSaved`` fields and the output's cotangent g, by the closed forms of
    the GroupNorm, Mish and conv gradients; None where ``needs`` is False or
    the residual is the identity."""
    s = RTBSaved(*saved)
    K = s.w1.shape[0]
    dz2, dgs2, dgb2 = gn_mish_backward_reference(g, s.z2, s.mean2, s.rstd2, s.gs2, s.gb2)
    dh = conv1d_dgrad(dz2, s.w2)
    dz1, dgs1, dgb1 = gn_mish_backward_reference(dh, s.z1, s.mean1, s.rstd1, s.gs1, s.gb1)
    proj = s.wres is not None
    dx = None
    if needs[0]:
        dx = conv1d_dgrad(dz1, s.w1) + (torch.matmul(g, s.wres.t()) if proj else g)
    grads = [dx, dh.sum(dim=1), conv1d_wgrad(s.x, dz1, K), dz1.sum(dim=(0, 1)), dgs1, dgb1,
             conv1d_wgrad(s.h, dz2, K), dz2.sum(dim=(0, 1)), dgs2, dgb2,
             torch.einsum("btc,bto->co", s.x, g) if proj else None,
             g.sum(dim=(0, 1)) if proj else None]
    return [v if n else None for v, n in zip(grads, needs)]


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
    args = (x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres)
    refuse_grad("fused_rtb", "fused_rtb_differentiable", *args)
    return _fused_rtb(*args, groups, eps, save=False)[0]


def _fused_rtb(x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, groups, eps,
               save: bool) -> tuple:
    """(out,), or with ``save`` (out, h, z1, z2, mean1, rstd1, mean2, rstd2)."""
    B, T, C = x.shape
    K, _, O = w1.shape
    if O % groups:
        raise ValueError(f"fused_rtb: O={O} not divisible by groups={groups}")
    if (wres is None) != (bres is None):
        raise ValueError("fused_rtb: pass both wres and bres, or neither")
    if wres is None and C != O:
        raise ValueError(f"fused_rtb: identity residual needs C == O, got {C} -> {O}")
    vec = (O,)
    temb_ld = _build.check_rows("fused_rtb", x.device, "temb", temb, (B, O))
    shapes = dict(
        x=(x, (B, T, C)), w1=(w1, (K, C, O)), b1=(b1, vec),
        gs1=(gs1, vec), gb1=(gb1, vec), w2=(w2, (K, O, O)), b2=(b2, vec),
        gs2=(gs2, vec), gb2=(gb2, vec),
    )
    if wres is not None:
        shapes.update(wres=(wres, (C, O)), bres=(bres, vec))
    _build.check_inputs("fused_rtb", x.device, **shapes)
    args = (x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, groups, eps)
    if x.device.type == "cpu":
        if save:
            return fused_rtb_forward_saving_reference(*args)
        return (fused_rtb_reference(*args),)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rtb: unsupported device {x.device}")
    _build.check_channels("fused_rtb", C=C, O=O)
    _build.check_aligned("fused_rtb", x=x, temb=temb, w1=w1, w2=w2, wres=wres, b1=b1, gs1=gs1,
                         gb1=gb1, b2=b2, gs2=gs2, gb2=gb2, bres=bres)
    sms = _build.num_sms(x.device)
    # each stage's own plan (the split depends on its K); the N tile is the same
    plans = [_build.plan_stage(B, T, Ci, O, groups, K, num_sms=sms) for Ci in (C, O)]
    lib = _build.load()
    # the weights as the stage reads them, laid out once per version and N tile
    # (those that changed in one launch)
    staged = _build.staged.many([(w, plans[0].n_tile) for w in (w1, w2, wres) if w is not None])
    wress = staged[2] if wres is not None else None
    work = _build.stage_work(x.device, *plans)
    h = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    out = torch.empty((B, T, O), device=x.device, dtype=torch.float32)
    saved = ()
    if save:
        saved = tuple(_build.carve(x.device, (B, T, O), (B, T, O), *[(B, groups)] * 4))
    err = _build.call_on(
        x.device, lib.cindm_fused_rtb_saving if save else lib.cindm_fused_rtb,
        *map(_build.ptr, (x, temb, staged[0], b1, gs1, gb1, staged[1], b2, gs2, gb2, wress, bres,
                          h, out, *saved)),
        B, T, C, O, K, groups, temb_ld, eps, *(ctypes.byref(_build.stage_launch(p, *work)) for p in plans),
    )
    _build.raise_on_error("fused_rtb", err)
    fused_rtb.launches += 1
    return (out, h, *saved) if save else (out,)


fused_rtb.launches = 0  # kernel calls (two stage launches each, either instance); not on CPU


def fused_rtb_backward(
    saved: Sequence[torch.Tensor | None], g: torch.Tensor, needs: Sequence[bool],
) -> list[torch.Tensor | None]:
    """The block's backward kernel (``csrc/block_backward.cu``) on CUDA
    tensors: the cotangents of the twelve inputs from ``RTBSaved`` fields and
    the output's cotangent g, as ``fused_rtb_backward_reference`` returns
    them. dx (and its launch) and dtemb are computed only where ``needs``
    asks, the other ten only when ``needs`` asks for one of them (wgrad and
    the reduction are then skipped). Raises on other devices."""
    s = RTBSaved(*saved)
    B, T, C = s.x.shape
    K, _, O = s.w1.shape
    inputs = dict(x=s.x, w1=s.w1, gs1=s.gs1, gb1=s.gb1, w2=s.w2, gs2=s.gs2, gb2=s.gb2,
                  wres=s.wres, g=g, h=s.h, z1=s.z1, mean1=s.mean1, rstd1=s.rstd1, z2=s.z2,
                  mean2=s.mean2, rstd2=s.rstd2)
    grads = _build.launch_backward("fused_rtb_backward", True, inputs, B, T, C, O, K,
                                   s.mean1.shape[1], want_dx=needs[0], want_dtemb=needs[1],
                                   want_w=any(needs[2:]))
    fused_rtb_backward.launches += 1
    names = ("dx", "dtemb", "dw1", "db1", "dgs1", "dgb1", "dw2", "db2", "dgs2", "dgb2", "dwres",
             "dbres")
    return [grads.get(n) if want else None for n, want in zip(names, needs)]


fused_rtb_backward.launches = 0  # kernel calls (5-6 launches each)


class FusedRTB(torch.autograd.Function):
    """``fused_rtb`` with a gradient. On CUDA tensors the forward is the
    kernel's saving instance and the backward the kernel
    ``fused_rtb_backward`` on what it saved: nothing of the block is
    recomputed. On CPU tensors both are their plain versions. It returns the
    cotangents of all twelve tensor arguments (``None`` where not needed and
    for an absent residual). On CUDA tensors ``FusedRTB.launches`` counts the
    forward's kernel calls and ``FusedRTB.backwards`` the backward passes;
    the CPU path counts neither.
    """

    launches = 0
    backwards = 0

    @staticmethod
    def forward(ctx, x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, groups, eps):
        out, *saved = _fused_rtb(x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres,
                                 groups, eps, save=True)
        ctx.save_for_backward(x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres, *saved)
        if x.device.type == "cuda":
            FusedRTB.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        cuda = g.device.type == "cuda"
        fn = fused_rtb_backward if cuda else fused_rtb_backward_reference
        grads = fn(ctx.saved_tensors, g.contiguous(), ctx.needs_input_grad[:12])
        if cuda:
            FusedRTB.backwards += 1
        return (*grads, None, None)


def fused_rtb_differentiable(
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
    """``fused_rtb`` that autograd can differentiate (through ``FusedRTB``).

    Without a gradient to compute (under ``torch.no_grad()``, or no input
    requires one) it is exactly ``fused_rtb``: one launch, nothing saved.
    """
    args = (x, temb, w1, b1, gs1, gb1, w2, b2, gs2, gb2, wres, bres)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        return FusedRTB.apply(*args, groups, eps)
    return fused_rtb(*args, groups, eps)
