from .unet1d import TemporalUnet1D, flax_from_params, params_from_flax

__all__ = ["TemporalUnet1D", "flax_from_params", "params_from_flax"]
