from .unet1d import TemporalUnet1D, flax_from_params, params_from_flax
from .unet1d_generic import Unet1D

__all__ = ["TemporalUnet1D", "Unet1D", "flax_from_params", "params_from_flax"]
