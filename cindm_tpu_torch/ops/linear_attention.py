"""The denoiser's linear attention with its pre-norm and residual, in one launch.

``PreNormResidual(LinearAttentionTemporal)`` of the 1D denoiser:

    xn  = ChannelLayerNorm(x)                 # biased variance, eps, gain g
    q, k, v = split(xn @ wqkv)                # [B, T, 128] each, 4 heads of 32
    k   = softmax over T of k                 # per sample and channel
    q   = q * dim_head ** -0.5
    out = per head q (k^T v)  @ wout + bout + x

The JAX package leaves it to XLA inside the jitted forward
(``cindm_tpu/models/blocks.py:251`` over ``:167`` and ``:107``); no Pallas
kernel computes it. ``prenorm_linear_attention`` launches the hand-written
CUDA kernel ``csrc/linear_attention.cu`` for CUDA tensors (3xTF32 on
wgmma, one launch a block, ``prenorm_linear_attention.launches`` counts
them; its tiles and CTAs from ``_build.plan_attention``) and uses the plain
version ``prenorm_linear_attention_reference`` for CPU tensors. Weights
keep the JAX ``Dense`` layouts: wqkv [C, 384] (no bias), wout [128, C],
bout [C]; the kernel reads wqkv and wout as ``_build.staged`` keeps them
laid out (tf32 planes; N tiles of 128 and 64), once per weight version: a
stale one costs one ``stage_weights`` launch.

The kernel has no backward: ``prenorm_linear_attention`` raises when a
gradient is wanted, and ``prenorm_linear_attention_differentiable`` routes
such a call to the plain version under autograd (training, design by
backprop); it counts those CUDA calls in
``prenorm_linear_attention_differentiable.autograd_calls``.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_conv_gn import refuse_grad

HEADS, DIM_HEAD = 4, 32  # the kernel's heads x dim_head (hidden 128)


def channel_layer_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Bias-free LayerNorm over the last axis: biased variance, gain g."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g


def linear_attention_temporal_reference(xn: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor,
                                        bout: torch.Tensor, heads: int = HEADS,
                                        dim_head: int = DIM_HEAD) -> torch.Tensor:
    """``LinearAttentionTemporal`` on [B, T, C]: per head, k softmaxed over
    T, context = k^T v, out = q context, then the out Dense."""
    B, T, _ = xn.shape
    q, k, v = torch.matmul(xn, wqkv).chunk(3, dim=-1)
    k = torch.softmax(k, dim=1)
    q = q * (dim_head ** -0.5)
    split = lambda a: a.reshape(B, T, heads, dim_head)
    context = torch.einsum("bthd,bthe->bhde", split(k), split(v))
    out = torch.einsum("bthd,bhde->bthe", split(q), context)
    return torch.matmul(out.reshape(B, T, heads * dim_head), wout) + bout


def prenorm_linear_attention_reference(
    x: torch.Tensor,  # [B, T, C]
    g: torch.Tensor,  # [C]
    wqkv: torch.Tensor,  # [C, 3 * heads * dim_head]
    wout: torch.Tensor,  # [heads * dim_head, C]
    bout: torch.Tensor,  # [C]
    heads: int = HEADS,
    dim_head: int = DIM_HEAD,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version: LinearAttentionTemporal(ChannelLayerNorm(x)) + x."""
    xn = channel_layer_norm(x, g, eps)
    return linear_attention_temporal_reference(xn, wqkv, wout, bout, heads, dim_head) + x


def prenorm_linear_attention(
    x: torch.Tensor,
    g: torch.Tensor,
    wqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    heads: int = HEADS,
    dim_head: int = DIM_HEAD,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The block: the CUDA kernel on CUDA tensors, plain on CPU tensors.

    On CUDA the kernel takes heads x dim_head = 4 x 32, C a multiple of 16,
    T up to 96 (``_build.check_attention``), float32 contiguous tensors on
    16-byte boundaries; it raises otherwise."""
    refuse_grad("prenorm_linear_attention", "prenorm_linear_attention_differentiable",
                x, g, wqkv, wout, bout)
    B, T, C = x.shape
    hidden = heads * dim_head
    _build.check_inputs("prenorm_linear_attention", x.device, x=(x, (B, T, C)), g=(g, (C,)),
                        wqkv=(wqkv, (C, 3 * hidden)), wout=(wout, (hidden, C)), bout=(bout, (C,)))
    if x.device.type == "cpu":
        return prenorm_linear_attention_reference(x, g, wqkv, wout, bout, heads, dim_head, eps)
    if x.device.type != "cuda":
        raise ValueError(f"prenorm_linear_attention: unsupported device {x.device}")
    if (heads, dim_head) != (HEADS, DIM_HEAD):
        raise ValueError(f"prenorm_linear_attention: the kernel takes {HEADS} heads of {DIM_HEAD}, "
                         f"got {heads} of {dim_head}")
    _build.check_attention(C, T)
    _build.check_aligned("prenorm_linear_attention", x=x, g=g, wqkv=wqkv, wout=wout, bout=bout)
    out = torch.empty_like(x)
    if B:
        plan = _build.plan_attention(B, T, C, _build.num_sms(x.device))
        # laid out once per weight version: a launch for each stale one (their N tiles differ)
        wq, wo = _build.staged.many([(wqkv, _build.ATTN_QKV_NT), (wout, _build.ATTN_OUT_NT)])
        err = _build.call_on(x.device, _build.load().cindm_linear_attention,
                             *map(_build.ptr, (x, g, wq, wo, bout, out)), B, T, C, plan.ctas, eps)
        _build.raise_on_error("prenorm_linear_attention", err)
        prenorm_linear_attention.launches += 1
    return out


prenorm_linear_attention.launches = 0  # kernel calls, one launch each; not on CPU


def prenorm_linear_attention_differentiable(
    x: torch.Tensor,
    g: torch.Tensor,
    wqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    heads: int = HEADS,
    dim_head: int = DIM_HEAD,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The block as autograd can differentiate it. When a gradient is wanted
    (grad mode on and an input requires one) it is the plain version under
    autograd, counted on CUDA tensors in ``.autograd_calls``: the kernel has
    no backward. Otherwise it is exactly ``prenorm_linear_attention``."""
    args = (x, g, wqkv, wout, bout)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        if x.device.type == "cuda":
            prenorm_linear_attention_differentiable.autograd_calls += 1
        return prenorm_linear_attention_reference(*args, heads, dim_head, eps)
    return prenorm_linear_attention(*args, heads, dim_head, eps)


prenorm_linear_attention_differentiable.autograd_calls = 0  # CUDA calls on the plain path
