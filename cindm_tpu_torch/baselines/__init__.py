"""The baselines: the 1D forward surrogates (Unet forward model, GNS), the
2D surrogates (FNO, LE-PDE) with their training harness, and the CEM and
backprop design optimizers over them."""

from .design_opt import BackpropConfig, CEMConfig, backprop_design, cem_design, clamp_nbody_cond
from .fno import FNO1d, FNO2d, SpectralConv1d, SpectralConv2d
from .gns import GNSConfig, GNSNet, gns_direct_rollout, gns_rollout, make_gns_loss
from .harness import experiment_record, loss_core, multi_step_loss, parse_multi_step
from .lepde import LEPDE, LEPDEConfig, lepde_loss
from .unet_forward import Unet1DForwardModel

__all__ = [
    "BackpropConfig",
    "CEMConfig",
    "FNO1d",
    "FNO2d",
    "GNSConfig",
    "GNSNet",
    "LEPDE",
    "LEPDEConfig",
    "SpectralConv1d",
    "SpectralConv2d",
    "Unet1DForwardModel",
    "backprop_design",
    "cem_design",
    "clamp_nbody_cond",
    "experiment_record",
    "gns_direct_rollout",
    "gns_rollout",
    "lepde_loss",
    "loss_core",
    "make_gns_loss",
    "multi_step_loss",
    "parse_multi_step",
]
