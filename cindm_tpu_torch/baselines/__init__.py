"""The 1D baselines: the Unet forward model, GNS, and the CEM and
backprop design optimizers over them. FNO and LE-PDE come with the 2D
baselines."""

from .design_opt import BackpropConfig, CEMConfig, backprop_design, cem_design, clamp_nbody_cond
from .gns import GNSConfig, GNSNet, gns_direct_rollout, gns_rollout, make_gns_loss
from .unet_forward import Unet1DForwardModel

__all__ = [
    "BackpropConfig",
    "CEMConfig",
    "GNSConfig",
    "GNSNet",
    "Unet1DForwardModel",
    "backprop_design",
    "cem_design",
    "clamp_nbody_cond",
    "gns_direct_rollout",
    "gns_rollout",
    "make_gns_loss",
]
