"""The denoiser's resampling convolutions on channel-last [B, T, C], in one launch each.

``Upsample1d`` doubles the time axis with a transposed conv (k4, stride 2,
padding 1; the port keeps torch's ConvTranspose1d weight [C_in, C_out, 4],
flipped from Flax's), ``Downsample1d`` halves it with a conv (k3, stride 2,
padding 1; weight [3, C_in, C_out] as the JAX package keeps it). The JAX
package leaves both to XLA (``cindm_tpu/models/blocks.py:262`` and
``:272``); no Pallas kernel computes them.

Three forms of each, one function:

- the plain versions ``upsample1d_reference`` / ``downsample1d_reference``:
  torch's strided convolutions on transposed copies, as the port ran them;
- the phase forms ``upsample1d_phase`` / ``downsample1d_phase``: the same
  function as stride-1 products over contiguous reshapes, from the weights
  as the kernel reads them (``upsample_phase_weights`` /
  ``downsample_phase_weights``):

      up:   y [B, 2T, C] = y2 [B, T, 2C], y2[j] = [y[2j], y[2j + 1]]
            y2[j, :C] = x[j - 1] W3 + x[j] W1 + b     (W_k = w[:, :, k])
            y2[j, C:] = x[j] W2 + x[j + 1] W0 + b
      down: x2 [B, T/2, 2C] = x, x2[j] = [x[2j], x[2j + 1]]
            y[j] = x2[j, :C] W1 + x2[j - 1, C:] W0 + x2[j, C:] W2 + b

- the kernel entry points ``upsample1d`` / ``downsample1d``: the
  hand-written CUDA kernel ``csrc/resample.cu`` for CUDA tensors (3xTF32 on
  wgmma, no transposes, tiles and the split of the last partial wave from
  ``_build.plan_resample``, its workspace and counters from
  ``_build.stage_work``; ``.launches`` counts launches), the plain version
  for CPU tensors. The phase weights
  are made and laid out (``stage_weights``) once per weight version, kept
  by ``_build.staged``.

The kernel has no backward: ``upsample1d`` / ``downsample1d`` raise when a
gradient is wanted, and ``*_differentiable`` send such a call to the plain
version under autograd (training, design by backprop), counting the CUDA
ones in ``.autograd_calls``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .fused_conv_gn import refuse_grad


def upsample1d_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of Upsample1d: x [B, T, C], w [C, C, 4] (torch's
    ConvTranspose1d layout, already flipped), b [C] -> [B, 2T, C]."""
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=2, padding=1)
    return y.transpose(1, 2).contiguous()


def downsample1d_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of Downsample1d: x [B, T, C], w [3, C, C], b [C] ->
    [B, ceil(T / 2), C]."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=2, padding=1)
    return y.transpose(1, 2).contiguous()


def upsample_phase_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The transposed conv's taps by output phase, as the kernel reads them:
    (even [2, C, C]: the taps at shifts -1 and 0, W3 and W1; odd [2, C, C]:
    at shifts 0 and +1, W2 and W0), W_k = w[:, :, k]."""
    wk = w.permute(2, 0, 1)  # [4, C_in, C_out]
    return wk[[3, 1]].contiguous(), wk[[2, 0]].contiguous()


def downsample_phase_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The strided conv's taps by input phase, as the kernel reads them:
    (x2's last C, x[2j + 1], at shifts -1 and 0: W0 and W2, [2, C, C]; its
    first C, x[2j], at shift 0: W1, [1, C, C])."""
    return w[0::2].contiguous(), w[1:2].contiguous()


def upsample1d_phase(x: torch.Tensor, w_even: torch.Tensor, w_odd: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Upsample1d as stride-1 products from ``upsample_phase_weights``."""
    B, T, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1))  # x[-1] = x[T] = 0
    prev, cur, nxt = xp[:, :-2], xp[:, 1:-1], xp[:, 2:]
    even = torch.matmul(prev, w_even[0]) + torch.matmul(cur, w_even[1]) + b
    odd = torch.matmul(cur, w_odd[0]) + torch.matmul(nxt, w_odd[1]) + b
    return torch.stack([even, odd], dim=2).reshape(B, 2 * T, -1)


def downsample1d_phase(x: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Downsample1d as stride-1 products from ``downsample_phase_weights``
    (an odd T reads one zero row past its end, as the conv's padding does)."""
    B, T, C = x.shape
    x2 = F.pad(x, (0, 0, 0, T % 2)).reshape(B, -(-T // 2), 2 * C)
    lo, hi = x2[..., :C], x2[..., C:]
    hi_prev = F.pad(hi, (0, 0, 1, 0))[:, :-1]
    return (torch.matmul(lo, w_lo[0]) + torch.matmul(hi_prev, w_hi[0]) + torch.matmul(hi, w_hi[1])) + b


@functools.lru_cache(maxsize=None)
def _laid_out(up: bool, nt: int):
    """w -> (its phase weights, their layouts for N tiles of nt): what
    ``_build.staged.derived`` keeps per weight version, one lookup a call.
    The phase weights stay with their layouts, so that no layout's tensor is
    freed while the kernel may read it."""
    phase = upsample_phase_weights if up else downsample_phase_weights

    def fn(w: torch.Tensor) -> tuple:
        parts = phase(w)
        return parts, tuple(_build.staged.many([(t, nt) for t in parts]))  # one launch

    return fn


def _resample(kind: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, up: bool) -> torch.Tensor:
    """The kernel on CUDA tensors (the plan's checks raise on what it does
    not take), the plain version on CPU tensors."""
    refuse_grad(kind, f"{kind}_differentiable", x, w, b)
    B, T, C = x.shape
    _build.check_inputs(kind, x.device, x=(x, (B, T, C)), w=(w, (C, C, 4) if up else (3, C, C)), b=(b, (C,)))
    if x.device.type == "cpu":
        return (upsample1d_reference if up else downsample1d_reference)(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"{kind}: unsupported device {x.device}")
    out = torch.empty((B, 2 * T if up else T // 2, C), device=x.device, dtype=torch.float32)
    if B == 0:
        return out
    plan = _build.plan_resample(B, T, C, up, _build.num_sms(x.device))
    _build.check_aligned(kind, x=x, w=w, b=b)
    # the phase weights and their layouts, made once per weight version and N tile
    _, (pa, pb) = _build.staged.derived(w, _laid_out(up, plan.n_tile))
    launch = _build.resample_launch(plan, B, T, C, *_build.stage_work(x.device, plan))
    err = _build.call_on(x.device, _build.load().cindm_resample, *map(_build.ptr, (x, pa, pb, b, out)),
                         ctypes.byref(launch))
    _build.raise_on_error(kind, err)
    return out


def upsample1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Upsample1d: the CUDA kernel on CUDA tensors (float32, contiguous, on
    16-byte boundaries, C a multiple of 4, T up to 192), plain on CPU tensors."""
    out = _resample("upsample1d", x, w, b, up=True)
    if x.device.type == "cuda" and x.shape[0]:
        upsample1d.launches += 1
    return out


upsample1d.launches = 0  # kernel calls, one launch each; not on CPU


def downsample1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Downsample1d: the CUDA kernel on CUDA tensors (float32, contiguous, on
    16-byte boundaries, C a multiple of 4, T even and up to 384), plain on
    CPU tensors."""
    out = _resample("downsample1d", x, w, b, up=False)
    if x.device.type == "cuda" and x.shape[0]:
        downsample1d.launches += 1
    return out


downsample1d.launches = 0  # kernel calls, one launch each; not on CPU


def upsample1d_differentiable(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Upsample1d as autograd can differentiate it: the plain version under
    autograd when a gradient is wanted (counted on CUDA tensors in
    ``.autograd_calls``), else exactly ``upsample1d``."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, w, b)):
        if x.device.type == "cuda":
            upsample1d_differentiable.autograd_calls += 1
        return upsample1d_reference(x, w, b)
    return upsample1d(x, w, b)


upsample1d_differentiable.autograd_calls = 0  # CUDA calls on the plain path


def downsample1d_differentiable(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Downsample1d as autograd can differentiate it: the plain version under
    autograd when a gradient is wanted (counted on CUDA tensors in
    ``.autograd_calls``), else exactly ``downsample1d``."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (x, w, b)):
        if x.device.type == "cuda":
            downsample1d_differentiable.autograd_calls += 1
        return downsample1d_reference(x, w, b)
    return downsample1d(x, w, b)


downsample1d_differentiable.autograd_calls = 0  # CUDA calls on the plain path
