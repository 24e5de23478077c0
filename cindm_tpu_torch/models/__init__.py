from .unet1d import TemporalUnet1D, flax_from_params, params_from_flax
from .unet1d_generic import Unet1D
from .unet2d import ForceUnet, Unet2D

__all__ = ["ForceUnet", "TemporalUnet1D", "Unet1D", "Unet2D", "flax_from_params", "params_from_flax"]
