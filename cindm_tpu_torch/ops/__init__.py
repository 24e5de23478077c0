"""Hand-written CUDA kernels of the denoiser and their plain PyTorch versions.

Each wrapper launches its kernel for a CUDA tensor, uses the plain version
for a CPU tensor, and counts its kernel launches in a plain integer
attribute, ``fused_rtb.launches`` and ``fused_conv1d_gn_mish.launches``.
The raw wrappers raise when autograd wants a gradient; the ``*_differentiable``
functions go through the autograd Functions ``FusedRTB`` and
``FusedConv1dGNMish`` (kernel forward, recompute backward in plain PyTorch),
which count their CUDA backward passes in ``FusedRTB.backwards`` and
``FusedConv1dGNMish.backwards``; ``FusedRTB.launches`` counts the kernel
launches made through ``FusedRTB``.
"""

from .fused_conv_gn import (
    FusedConv1dGNMish,
    fused_conv1d_gn_mish,
    fused_conv1d_gn_mish_differentiable,
    fused_conv1d_gn_mish_reference,
    mish,
)
from .fused_rtb import FusedRTB, fused_rtb, fused_rtb_differentiable, fused_rtb_reference

__all__ = [
    "FusedConv1dGNMish",
    "FusedRTB",
    "fused_conv1d_gn_mish",
    "fused_conv1d_gn_mish_differentiable",
    "fused_conv1d_gn_mish_reference",
    "fused_rtb",
    "fused_rtb_differentiable",
    "fused_rtb_reference",
    "mish",
]
