"""Hand-written CUDA kernels of the denoiser and their plain PyTorch versions.

Each wrapper launches its kernel for a CUDA tensor, uses the plain version
for a CPU tensor, and counts its kernel launches in a plain integer
attribute, ``fused_rtb.launches`` and ``fused_conv1d_gn_mish.launches``.
"""

from .fused_conv_gn import fused_conv1d_gn_mish, fused_conv1d_gn_mish_reference, mish
from .fused_rtb import fused_rtb, fused_rtb_reference

__all__ = [
    "fused_conv1d_gn_mish",
    "fused_conv1d_gn_mish_reference",
    "fused_rtb",
    "fused_rtb_reference",
    "mish",
]
