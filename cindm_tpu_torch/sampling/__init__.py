from .compose import EpsModel, make_composed_eps_model, pair_indices, resolve_fold_chunks, window_coverage
from .diffusion2d import (
    Diffusion2DConfig,
    asynchronous_clamp,
    ddim_sample_loop_2d,
    nhwc_model,
    p_losses_2d,
    p_sample_loop_2d,
    sample_noise,
    share_states_over_boundaries,
)
from .diffusion1d import Diffusion1DConfig, p_losses, sample, sample_total_steps
from .guidance import (
    confidence_interval_95,
    get_design_fn,
    get_eval_fn,
    get_eval_fn_per_sample,
)
from .guidance2d import make_design_grad_fn, mask_denoise
from .sampler import GuidanceSpec, ddim_sample_loop, p_sample_loop, p_sample_step

__all__ = [
    "Diffusion2DConfig",
    "asynchronous_clamp",
    "ddim_sample_loop_2d",
    "make_design_grad_fn",
    "mask_denoise",
    "nhwc_model",
    "p_sample_loop_2d",
    "sample_noise",
    "share_states_over_boundaries",
    "Diffusion1DConfig",
    "EpsModel",
    "GuidanceSpec",
    "confidence_interval_95",
    "ddim_sample_loop",
    "get_design_fn",
    "get_eval_fn",
    "get_eval_fn_per_sample",
    "make_composed_eps_model",
    "p_losses",
    "p_losses_2d",
    "p_sample_loop",
    "p_sample_step",
    "pair_indices",
    "sample",
    "resolve_fold_chunks",
    "sample_total_steps",
    "window_coverage",
]
