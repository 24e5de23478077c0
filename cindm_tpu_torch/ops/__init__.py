"""Hand-written CUDA kernels of the denoiser and their plain PyTorch versions.

Each wrapper launches its kernel for a CUDA tensor, uses the plain version
for a CPU tensor, and counts its kernel calls in a plain integer attribute:
``fused_rtb.launches`` and ``fused_conv1d_gn_mish.launches`` (forwards,
either instance), ``fused_rtb_backward.launches`` and
``fused_conv1d_gn_mish_backward.launches`` (backwards). The raw forward
wrappers raise when autograd wants a gradient; the ``*_differentiable``
functions go through the autograd Functions ``FusedRTB`` and
``FusedConv1dGNMish``, whose forward is the kernel's saving instance and
whose backward is the backward kernel on what it saved (the plain closed
forms on the CPU). They count their CUDA backward passes in
``FusedRTB.backwards`` and ``FusedConv1dGNMish.backwards``;
``FusedRTB.launches`` counts the forward calls made through ``FusedRTB``.
``grad_reduce`` (``grad_reduce.launches``) runs the backward's in-order sum
of partials alone, beside its plain version ``grad_reduce_reference``.
``prenorm_linear_attention`` (``prenorm_linear_attention.launches``) is the
denoiser's linear attention with its pre-norm and residual in one kernel;
``prenorm_linear_attention_differentiable`` takes its plain version
``prenorm_linear_attention_reference`` under autograd when a gradient is
wanted (the kernel has no backward). ``upsample1d`` and ``downsample1d``
(``.launches``) are the denoiser's resampling convolutions in one kernel
each; their ``*_differentiable`` forms take the plain versions
``upsample1d_reference`` / ``downsample1d_reference`` under autograd.

``precision`` holds the bfloat16 helpers ``cast_floating`` and
``bf16_eps_model``; a bfloat16 model runs the plain versions.
"""

from .fused_conv_gn import (
    FusedConv1dGNMish,
    fused_conv1d_gn_mish,
    fused_conv1d_gn_mish_backward,
    fused_conv1d_gn_mish_backward_reference,
    fused_conv1d_gn_mish_differentiable,
    fused_conv1d_gn_mish_forward_saving_reference,
    fused_conv1d_gn_mish_reference,
    mish,
)
from .fused_rtb import (
    FusedRTB,
    fused_rtb,
    fused_rtb_backward,
    fused_rtb_backward_reference,
    fused_rtb_differentiable,
    fused_rtb_forward_saving_reference,
    fused_rtb_reference,
)
from .grad_reduce import grad_reduce, grad_reduce_reference
from .linear_attention import (
    prenorm_linear_attention,
    prenorm_linear_attention_differentiable,
    prenorm_linear_attention_reference,
)
from .precision import bf16_eps_model, cast_floating
from .resample import (
    downsample1d,
    downsample1d_differentiable,
    downsample1d_reference,
    upsample1d,
    upsample1d_differentiable,
    upsample1d_reference,
)

__all__ = [
    "FusedConv1dGNMish",
    "bf16_eps_model",
    "cast_floating",
    "downsample1d",
    "downsample1d_differentiable",
    "downsample1d_reference",
    "FusedRTB",
    "fused_conv1d_gn_mish",
    "fused_conv1d_gn_mish_backward",
    "fused_conv1d_gn_mish_backward_reference",
    "fused_conv1d_gn_mish_differentiable",
    "fused_conv1d_gn_mish_forward_saving_reference",
    "fused_conv1d_gn_mish_reference",
    "fused_rtb",
    "fused_rtb_backward",
    "fused_rtb_backward_reference",
    "fused_rtb_differentiable",
    "fused_rtb_forward_saving_reference",
    "fused_rtb_reference",
    "grad_reduce",
    "grad_reduce_reference",
    "mish",
    "prenorm_linear_attention",
    "prenorm_linear_attention_differentiable",
    "prenorm_linear_attention_reference",
    "upsample1d",
    "upsample1d_differentiable",
    "upsample1d_reference",
]
