from .compose import EpsModel, make_composed_eps_model, pair_indices, resolve_fold_chunks, window_coverage
from .diffusion1d import Diffusion1DConfig, sample, sample_total_steps
from .guidance import (
    confidence_interval_95,
    get_design_fn,
    get_eval_fn,
    get_eval_fn_per_sample,
)
from .sampler import GuidanceSpec, ddim_sample_loop, p_sample_loop, p_sample_step

__all__ = [
    "Diffusion1DConfig",
    "EpsModel",
    "GuidanceSpec",
    "confidence_interval_95",
    "ddim_sample_loop",
    "get_design_fn",
    "get_eval_fn",
    "get_eval_fn_per_sample",
    "make_composed_eps_model",
    "p_sample_loop",
    "p_sample_step",
    "pair_indices",
    "sample",
    "resolve_fold_chunks",
    "sample_total_steps",
    "window_coverage",
]
